"""Port parity of the LazyConfig pieces and trainer (``config.py``, ``tools/lazyconfig_train.py``) against JAX.

* ``LazyCall``, ``instantiate``, ``apply_overrides`` and ``auto_scale_workers``
  against the JAX package's (``tests/test_lazyconfig_train.py``,
  ``tests/test_scaling.py:114``): the same nodes, objects and configs.
* The synthetic loader: the same numpy draws in the same order as the JAX
  tool's, and targets from the port's ``generate_target`` within 1e-6.
* The trainer: a config naming ``HRNET_TINY`` (5 joints) and Adam 2e-3 on
  64^2 -> 16^2 batches of 4; from the same seeded Flax variables
  (``convert.flax_to_state_dict``), the port's ``build`` and ``run`` against
  the JAX tool's pieces (its loader, ``instantiate``, ``TrainState.create``
  and the jitted ``make_train_step``): the first 3 losses within 1e-4
  relative, the bar of ``test_torch_train_step.py``'s float32 Adam updates.
* The command on the CPU: a checkpoint whose ``.npz`` the port's loader
  reads back; a ``torch.optim`` optimizer node; and CUDA by default (it
  raises without a card).
"""

import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import config as jconfig
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.train import state as jstate
from spacecraft_pose_estimation_tpu_torch import config as tconfig
from spacecraft_pose_estimation_tpu_torch.evaluate import load_landmark_model
from spacecraft_pose_estimation_tpu_torch.tools import lazyconfig_train as lct

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401 (the fixture)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import lazyconfig_train as jlct  # noqa: E402 (the JAX package's tool, from tools/)

pytestmark = pytest.mark.usefixtures("few_threads")

J = 5
TRAIN = dict(max_iter=3, batch_size=4, image_size=64, heatmap_size=16, num_joints=J, log_period=1, seed=0)
PORT_CONFIG = textwrap.dedent(
    """
    from spacecraft_pose_estimation_tpu_torch.config import LazyCall as L
    from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNet, HRNET_TINY
    from spacecraft_pose_estimation_tpu_torch.train.optim import build_optimizer

    model = L(HRNet)(config=HRNET_TINY.with_joints(5))
    optimizer = L(build_optimizer)(name="adam", learning_rate=2e-3)
    train = dict(max_iter=3, batch_size=4, image_size=64, heatmap_size=16, num_joints=5, log_period=1, seed=0)
    """
)
JAX_CONFIG = textwrap.dedent(
    """
    from spacecraft_pose_estimation_tpu.config import LazyCall as L
    from spacecraft_pose_estimation_tpu.models.hrnet import HRNet, HRNET_TINY
    import optax

    model = L(HRNet)(config=HRNET_TINY.with_joints(5))
    optimizer = L(optax.adam)(learning_rate=2e-3)
    train = dict(max_iter=3, batch_size=4, image_size=64, heatmap_size=16, num_joints=5, log_period=1, seed=0)
    """
)


def scaled(factor=1, offset=0.0):
    return {"factor": factor, "offset": offset}


def test_lazycall_and_instantiate_match_jax():
    def node(L):
        return L(scaled)(factor=L("numpy.arange")(stop=3), offset=[L(scaled)(factor=2), (1, L(dict)(a=4))])

    tnode, jnode = node(tconfig.LazyCall), node(jconfig.LazyCall)
    assert tnode == jnode and tnode["_target_"] is scaled
    got, want = tconfig.instantiate(tnode), jconfig.instantiate(jnode)
    np.testing.assert_array_equal(got["factor"], want["factor"])
    assert got["offset"] == want["offset"] == [scaled(2), (1, {"a": 4})]
    assert tconfig.instantiate({"plain": [1, (2, 3)]}) == jconfig.instantiate({"plain": [1, (2, 3)]})


def test_apply_overrides_matches_jax():
    pairs = ["max_iter", "7", "out_dir", "x/y", "lr", "1e-3", "sizes", "[64, 64]", "name", "hrnet"]
    assert lct.apply_overrides({"max_iter": 1}, pairs) == jlct.apply_overrides({"max_iter": 1}, pairs)
    assert lct.apply_overrides({}, pairs)["sizes"] == [64, 64]


@pytest.mark.parametrize("ref,world", [(8, 16), (8, 8), (0, 4), (4, 2)])
def test_auto_scale_workers_matches_jax(ref, world):
    import dataclasses

    def scale(C):
        cfg = C.get_preset("events")
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, lr=0.01, reference_world_size=ref))
        return C.auto_scale_workers(cfg, world_size=world).train

    got, want = scale(tconfig), scale(jconfig)
    assert (got.lr, got.reference_world_size) == (want.lr, want.reference_world_size)


def test_synthetic_loader_matches_jax():
    got, want = lct.synthetic_loader(TRAIN, torch.device("cpu")), jlct.synthetic_loader(TRAIN)
    for step in range(2):
        g, w = got(step), want(step)
        np.testing.assert_array_equal(n(g["image"]), np.asarray(w["image"]))
        np.testing.assert_allclose(n(g["target"]), np.asarray(w["target"]), atol=1e-6)
        np.testing.assert_array_equal(n(g["target_weight"]), np.asarray(w["target_weight"]))


@pytest.fixture(scope="module")
def tiny_variables():
    jm = JHRNet(config=J_TINY.with_joints(J))
    return random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=True), seed=2,
                            overrides={"final_layer": 0.1})


def _write(tmp_path, text, name):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_first_losses_match_jax(tmp_path, tiny_variables):
    ns = lct.load_lazy_config(_write(tmp_path, PORT_CONFIG, "port_cfg.py"))
    train_cfg = lct.apply_overrides(dict(ns["train"]), [])
    state, loader = lct.build(ns, train_cfg, torch.device("cpu"), variables=tiny_variables)
    got = lct.run(state, loader, train_cfg)
    # the JAX tool's loop, from the same variables
    jns = jlct.load_lazy_config(_write(tmp_path, JAX_CONFIG, "jax_cfg.py"))
    model, tx = jconfig.instantiate(jns["model"]), jconfig.instantiate(jns["optimizer"])
    js = jstate.TrainState.create(model, to_jax(tiny_variables), tx)
    step = jax.jit(jstate.make_train_step())
    jloader = jlct.synthetic_loader(dict(jns["train"]))
    want = []
    for it in range(3):
        js, metrics = step(js, jloader(it))
        want.append(float(metrics["loss"]))
    assert state.step == 3 and len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_command_writes_a_checkpoint_the_loader_reads(tmp_path):
    out = tmp_path / "out"
    path = _write(tmp_path, PORT_CONFIG, "cfg.py")
    loss = lct.main(["--config-file", path, "--device", "cpu", "max_iter", "2", "out_dir", str(out)])
    assert loss is not None and np.isfinite(loss)
    npz = out / "2" / "model.npz"
    model = load_landmark_model(str(npz), "hrnet_tiny", J, torch.float32, "cpu")
    # the saved state: the seeded start after 2 updates, rebuilt and run again here
    ns = lct.load_lazy_config(path)
    train_cfg = lct.apply_overrides(dict(ns["train"]), ["max_iter", "2"])
    state, loader = lct.build(ns, train_cfg, torch.device("cpu"))
    lct.run(state, loader, train_cfg)
    x = t(np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(np.float32))
    state.model.eval()
    with torch.no_grad():
        assert torch.equal(model(x), state.model(x))


def test_torch_optim_node(tmp_path):
    """An optimizer node naming a torch.optim class: built with the model's
    parameters, run at its constant learning rate."""
    path = _write(tmp_path, PORT_CONFIG.replace('L(build_optimizer)(name="adam", learning_rate=2e-3)',
                                                "L(torch.optim.SGD)(lr=0.5)").replace(
        "from spacecraft_pose_estimation_tpu_torch.train.optim import build_optimizer", "import torch"), "sgd.py")
    ns = lct.load_lazy_config(path)
    state, loader = lct.build(ns, dict(ns["train"]), torch.device("cpu"))
    before = [p.detach().clone() for p in state.model.parameters()]
    losses = lct.run(state, loader, dict(ns["train"], max_iter=1))
    assert isinstance(state.optimizer.inner, torch.optim.SGD) and state.optimizer.schedule(5) == 0.5
    assert np.isfinite(losses).all() and any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters()))


def test_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lct.main(["--config-file", _write(tmp_path, PORT_CONFIG, "cfg.py")])
