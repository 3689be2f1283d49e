"""Port parity of ``parallel/``: the mesh, the shards, data parallelism and the gathers.

Each world size (1, 2, 4) is a gloo group of spawned CPU processes, one
thread each, joined through a ``file://`` store in ``tmp_path``
(``torch_parallel_worker.py``, which imports no JAX). The JAX package's
scaling tests (``tests/test_scaling.py:44-113``) are the model:

* the layout: a (world, 1) ``("data", "model")`` mesh, each rank's shard
  the rank's 16 / world rows of every leaf, placements ``(Shard(0),
  Replicate())``, leaves replicated from rank 0, a world size that does
  not divide by ``model_parallel`` refused;
* the data-parallel train step of ``HRNET_TINY`` with 3 joints (SGD 1e-2,
  batch 16 of 32^2) against the single-process step on the same global
  batch, with JAX's bars: loss within 2e-5 relative, every parameter within
  1e-5. The single-process step is held to JAX's ``make_train_step`` on the
  same numpy-seeded variables (loss 1e-4 relative, as
  ``tests/test_torch_train_step.py``; parameters within 1 lr, at most 1% of
  them beyond 1e-3 lr, as ``tests/test_torch_detection_train.py``);
* a control: the same step with rank-local BatchNorm (DDP alone) must miss
  those bars at 2 and 4 ranks, so the check can fail;
* the data-parallel detection forward of ``RCNN_TINY`` on 8 images of 64^2,
  gathered, against the unsharded forward: boxes within 1e-3, ``valid``
  equal;
* ``all_gather_objects`` and ``reduce_dict`` against the expected gathers.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.train import optim as joptim, state as jstate
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, module_to_flax
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
from spacecraft_pose_estimation_tpu_torch.parallel import multihost
from spacecraft_pose_estimation_tpu_torch.train import optim as toptim, state as tstate

from torch_port_util import few_threads, random_variables, to_jax  # noqa: F401 (the fixture)
import torch_parallel_worker

pytestmark = pytest.mark.usefixtures("few_threads")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLDS = (1, 2, 4)
LR, B = 1e-2, 16


def landmark_batch(global_batch, seed=3):
    """``tests/test_scaling.py``'s ``landmark_batch``."""
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(global_batch, 32, 32, 3)).astype(np.float32),
        "target": rng.uniform(0, 1, (global_batch, 8, 8, 3)).astype(np.float32),
        "target_weight": np.ones((global_batch, 3), np.float32),
    }


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The numpy-seeded variables and batches, the single-process steps of both packages, and the unsharded detections."""
    jm = JHRNet(config=J_TINY.with_joints(3))
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False),
                                 seed=5, overrides={"final_layer": 0.1})
    batch = landmark_batch(B)
    js = jstate.TrainState.create(jm, to_jax(variables), joptim.build_optimizer("sgd", LR))
    js, jmet = jax.jit(jstate.make_train_step())(js, {k: jnp.asarray(v) for k, v in batch.items()})
    model = HRNet(HRNET_TINY.with_joints(3), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    work = tmp_path_factory.mktemp("parallel")
    torch.save(model.state_dict(), work / "hrnet.pt")
    ts = tstate.TrainState(model, toptim.build_optimizer("sgd", model.parameters(), LR))
    tmet = tstate.make_train_step()(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.savez(work / "batch.npz", **batch)
    images = np.random.default_rng(0).uniform(0, 255, size=(8, 64, 64, 3)).astype(np.float32)
    np.save(work / "images.npy", images)
    det = torch_parallel_worker.detector()
    with torch.no_grad():
        ref = {k: v.numpy() for k, v in det(torch.from_numpy(images)).items()}
    return dict(work=work, batch=batch, jloss=float(jmet["loss"]), jparams=flat(js.params),
                loss=float(tmet["loss"]), state=model.state_dict(), detections=ref)


@pytest.fixture(scope="module")
def runs(inputs):
    """world size -> (each rank's results, its work directory): one gloo group a world size."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, HERE]), "OMP_NUM_THREADS": "1"}
    procs = {}
    for world in WORLDS:  # the three groups run at once
        work = inputs["work"] / f"w{world}"
        work.mkdir()
        for name in ("hrnet.pt", "batch.npz", "images.npy"):
            os.link(inputs["work"] / name, work / name)
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"), str(r), str(world), str(work / "store"),
             str(work)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    out = {}
    for world, group in procs.items():
        logs = [p.communicate(timeout=300)[0] for p in group]
        for r, p in enumerate(group):
            assert p.returncode == 0, f"world {world} rank {r}:\n{logs[r]}"
        work = inputs["work"] / f"w{world}"
        out[world] = ([json.loads((work / f"rank{r}.json").read_text()) for r in range(world)], work)
    return out


def params_off(state, ref):
    """max |a - b| over every parameter (the buffers left out, as JAX's ``params``)."""
    return max(float((state[k] - ref[k]).abs().max()) for k in ref if not k.endswith((".mean", ".var")))


def test_single_process_step_matches_jax(inputs):
    assert inputs["loss"] == pytest.approx(inputs["jloss"], rel=1e-4)
    model = HRNet(HRNET_TINY.with_joints(3), device="cpu")
    model.load_state_dict(inputs["state"])
    tp = flat(module_to_flax(model)["params"])
    assert set(tp) == set(inputs["jparams"])
    dp = np.concatenate([(np.abs(tp[k] - inputs["jparams"][k]) / LR).ravel() for k in tp])
    assert dp.max() <= 1.0 and (dp > 1e-3).mean() <= 0.01, (dp.max(), (dp > 1e-3).mean())


@pytest.mark.parametrize("world", WORLDS)
def test_layout(runs, world):
    ranks, _ = runs[world]
    for r, res in enumerate(ranks):
        assert (res["world_size"], res["rank"], res["is_main"]) == (world, r, r == 0)
        assert res["mesh"] == {"shape": [world, 1], "names": ["data", "model"], "device": "cpu"}
        assert res["mp3"] == f"{world} devices not divisible by model_parallel=3"
        assert res["placements"] == ["Shard(0)", "Replicate"]
        assert res["shard_shapes"] == {"image": [B // world, 32, 32, 3], "target": [B // world, 8, 8, 3],
                                       "target_weight": [B // world, 3]}
        assert res["shard_is_slice"]
        assert res["replicated"] == {"w": [[0.0] * 4] * 4, "n": [0, 1, 2], "tag": "kept"}


@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_matches_single_process(inputs, runs, world):
    """Global-batch BatchNorm + DDP == the single-process step on the same global batch."""
    ranks, work = runs[world]
    for r, res in enumerate(ranks):
        assert res["global"]["batchnorms"] > 0 and res["global"]["no_grad"] == []
        np.testing.assert_allclose(res["global"]["loss"], inputs["loss"], rtol=2e-5)
        state = torch.load(work / f"global_{r}.pt", weights_only=True)
        off = params_off(state, inputs["state"])
        assert off <= 1e-5, (r, off)
        # the running statistics are the global batch's on every rank
        for k, v in inputs["state"].items():
            if k.endswith((".mean", ".var")):
                np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_rank_local_batchnorm_misses_the_bar(inputs, runs, world):
    """The control: DDP without the global statistics differs from the
    single-process step by more than the bars above."""
    ranks, work = runs[world]
    loss_off = abs(ranks[0]["local"]["loss"] - inputs["loss"]) / inputs["loss"]
    off = params_off(torch.load(work / "local_0.pt", weights_only=True), inputs["state"])
    print(f"world {world}, rank-local BatchNorm: loss {loss_off:.3g} relative off, parameters {off:.3g} off")
    assert loss_off > 2e-5 and off > 1e-5


@pytest.mark.parametrize("world", WORLDS)
def test_dp_detection_forward_matches_unsharded(inputs, runs, world):
    _, work = runs[world]
    got, ref = np.load(work / "detections.npz"), inputs["detections"]
    assert set(got.files) == set(ref)
    assert ref["valid"].any()
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-3)
    np.testing.assert_array_equal(got["valid"], ref["valid"])


@pytest.mark.parametrize("world", WORLDS)
def test_gathers(runs, world):
    ranks, _ = runs[world]
    want = [{"rank": r, "sq": r * r} for r in range(world)]
    total = sum(r + 1.0 for r in range(world))
    for res in ranks:
        assert res["gather"] == want
        assert res["mean"] == {"a": total / world, "b": 2.0}
        assert res["sum"] == {"a": total, "b": 2.0 * world}
        assert res["global"]["loss_sum"] == pytest.approx(world * res["global"]["loss"])


def test_single_process_degradation():
    """No process group: the world-size-1 no-ops of JAX's ``TestMultihost``."""
    assert multihost.get_world_size() == 1 and multihost.get_rank() == 0
    assert multihost.is_main_process()
    assert multihost.all_gather_objects({"a": 1}) == [{"a": 1}]
    assert multihost.reduce_dict({"x": 2.0}) == {"x": 2.0}
