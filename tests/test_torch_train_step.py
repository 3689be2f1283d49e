"""Port parity of the landmark train step: train-mode BatchNorm, ``make_train_step`` with Adam,
the weight bridge back to Flax, and the checkpoints.

``HRNET_TINY`` with 11 joints at 64x64 -> 16x16, batch 4, one numpy-seeded
Flax variable tree loaded into both packages, Adam at 1e-3 with a
milestone at step 2 (so the third update runs at 1e-4), 3 updates.

Tolerances:

* train-mode BN against ``flax.linen.BatchNorm`` (momentum 0.9, eps 1e-5):
  float32 outputs and gradients 1e-5 of scale, running statistics 1e-6
  (the biased variance: an unbiased one would be off by n / (n - 1));
  bfloat16 outputs within one bf16 step (1/128 of scale);
* ``make_train_step`` in float32, each of 3 updates: loss within 1e-4
  relative, ``grad_norm`` 1e-4 relative, ``acc`` equal, the first update's
  gradients within 1e-4 of each tensor's max, ``batch_stats`` 1e-5. The
  parameters: Adam's first update is about lr * g / (|g| + 1e-8), so an
  entry whose gradient is near 1e-8 moves by up to lr on a float32 rounding
  of the convolution backward, and by 2 lr a update at worst. Bound: every
  entry within 1 lr after 3 updates, at most 50 of 46,991 beyond 1e-3 lr
  (measured here: max 0.045 lr, 6 entries beyond 1e-3 lr);
* in bfloat16 (bf16 activations over float32 parameters on both sides) the
  two packages round their convolutions differently, and bf16 gradients of
  this tiny net are ~20% from float32 ones in either package. Held: loss
  1e-2 relative, ``grad_norm`` 5% and ``acc`` equal at each update, the port's gradients
  no farther from JAX's float32 gradients than 1.5x JAX's own bf16
  gradients are, ``batch_stats`` 1e-2 after the first update, parameters
  within 2 lr a update.
"""

import os

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import heatmap as jhm
from spacecraft_pose_estimation_tpu.train import optim as joptim, state as jstate
from spacecraft_pose_estimation_tpu.train.loss import joints_mse_loss as j_mse
from spacecraft_pose_estimation_tpu_torch import evaluate
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, module_to_flax, state_dict_to_flax
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
from spacecraft_pose_estimation_tpu_torch.models.layers import BatchNorm
from spacecraft_pose_estimation_tpu_torch.train import optim as toptim, state as tstate
from spacecraft_pose_estimation_tpu_torch.train.checkpoint import CheckpointManager

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

J, LR, MILESTONES = 11, 1e-3, [2]


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 6, 5, 8)) * 3 + 1.5).astype(np.float32)  # NHWC
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    mean0, var0 = rng.normal(0, 0.1, 8).astype(np.float32), rng.uniform(0.5, 1.5, 8).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}

    def f(xx, params):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    xj = jnp.asarray(x, jdt)
    y_j, vjp, stats_j = jax.vjp(f, xj, to_jax(variables["params"]), has_aux=True)
    dx_j, dp_j = vjp(jnp.asarray(cot, jdt))

    m = BatchNorm(8)
    m.load_state_dict({"scale": t(scale), "bias": t(bias), "mean": t(mean0), "var": t(var0)})
    assert not m.training  # built in eval mode
    m.train()
    xt = t(x).permute(0, 3, 1, 2).to(tdt).requires_grad_(True)
    y_t = m(xt)
    y_t.backward(t(cot).permute(0, 3, 1, 2).to(tdt))
    y_t = n(y_t.float().permute(0, 2, 3, 1))
    np.testing.assert_allclose(n(m.mean), np.asarray(stats_j["mean"]), atol=1e-6)
    np.testing.assert_allclose(n(m.var), np.asarray(stats_j["var"]), atol=1e-6)
    # the biased variance: torch's unbiased running update would miss by n / (n - 1)
    xf = np.asarray(xj, np.float32)
    np.testing.assert_allclose(n(m.var), 0.9 * var0 + 0.1 * xf.var(axis=(0, 1, 2)), rtol=1e-5)
    y_j = np.asarray(y_j, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(y_t, y_j, atol=1e-5 * np.abs(y_j).max())
        np.testing.assert_allclose(n(xt.grad.permute(0, 2, 3, 1)), np.asarray(dx_j),
                                   atol=1e-5 * np.abs(np.asarray(dx_j)).max())
        np.testing.assert_allclose(n(m.scale.grad), np.asarray(dp_j["scale"]), atol=1e-5 * np.abs(dp_j["scale"]).max())
        np.testing.assert_allclose(n(m.bias.grad), np.asarray(dp_j["bias"]), atol=1e-5 * np.abs(dp_j["bias"]).max())
    else:
        assert y_t.dtype == np.float32 and xt.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(y_t, y_j, atol=np.abs(y_j).max() / 128)
        dx = np.asarray(dx_j, np.float32)
        np.testing.assert_allclose(n(xt.grad.float().permute(0, 2, 3, 1)), dx, atol=np.abs(dx).max() / 64)
    # eval mode: the running statistics, as before
    m.eval()
    with torch.no_grad():
        y_e = n(m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    want = (x - n(m.mean)) / np.sqrt(n(m.var) + 1e-5) * scale + bias
    np.testing.assert_allclose(y_e, want, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    jm = JHRNet(config=J_TINY.with_joints(J))
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                                 seed=0, overrides={"final_layer": 0.1})
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    joints = rng.uniform(0, 64, size=(4, J, 2)).astype(np.float32)
    vis = (rng.uniform(size=(4, J)) > 0.1).astype(np.float32)
    target, tw = jax.vmap(lambda a, b: jhm.generate_target(a, b, (64, 64), (16, 16), 2.0))(joints, vis)
    batch = {"image": x, "target": np.asarray(target), "target_weight": np.asarray(tw)}
    return variables, batch


def jax_grads(dtype, variables, batch):
    jm = JHRNet(config=J_TINY.with_joints(J), dtype=dtype)

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": to_jax(variables["batch_stats"])}, batch["image"],
                          train=True, mutable=["batch_stats"])
        return j_mse(out, batch["target"], batch["target_weight"])

    return jax.jit(jax.grad(loss_fn))(to_jax(variables["params"]))


def run_both(dtype, variables, batch, steps=3):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jm = JHRNet(config=J_TINY.with_joints(J), dtype=jdt)
    tx = joptim.build_optimizer("adam", joptim.multistep_schedule(LR, MILESTONES), weight_decay=1e-4)
    js = jstate.TrainState.create(jm, to_jax(variables), tx)
    jstep = jax.jit(jstate.make_train_step(True))
    model = HRNet(HRNET_TINY.with_joints(J), dtype=tdt, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    ts = tstate.TrainState(model, toptim.build_optimizer("adam", model.parameters(),
                                                         toptim.multistep_schedule(LR, MILESTONES),
                                                         weight_decay=1e-4))
    tstep = tstate.make_train_step(True)
    tb = {k: t(v) for k, v in batch.items()}
    out = []
    for k in range(steps):
        js, jmet = jstep(js, {k2: jnp.asarray(v) for k2, v in batch.items()})
        tmet = tstep(ts, tb)
        grads = state_dict_to_flax({name: p.grad for name, p in model.named_parameters()}, set())["params"]
        out.append(dict(jmet={a: float(b) for a, b in jmet.items()}, tmet={a: float(b) for a, b in tmet.items()},
                        jvars={"params": js.params, "batch_stats": js.batch_stats},
                        tvars=module_to_flax(model), tgrads=grads))
    assert ts.step == steps and int(js.step) == steps
    return out, model


def test_train_step_matches_jax_float32(tiny):
    variables, batch = tiny
    out, _ = run_both("float32", variables, batch)
    jg = jax_grads(jnp.float32, variables, batch)
    for a, b in zip(leaves(jg), leaves(out[0]["tgrads"])):
        np.testing.assert_allclose(b, a, atol=1e-4 * max(np.abs(a).max(), 1e-30))
    for k, o in enumerate(out):
        jm, tm = o["jmet"], o["tmet"]
        assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-4), k
        assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-4), k
        assert tm["acc"] == jm["acc"], k
        for a, b in zip(leaves(o["jvars"]["batch_stats"]), leaves(o["tvars"]["batch_stats"])):
            np.testing.assert_allclose(b, a, atol=1e-5)
    dp = np.concatenate([np.abs(a - b).ravel() for a, b in zip(leaves(out[-1]["jvars"]["params"]),
                                                               leaves(out[-1]["tvars"]["params"]))]) / LR
    print(f"float32 parameters after 3 Adam updates: {dp.size} entries, max {dp.max():.4g} lr, "
          f"{(dp > 1e-3).sum()} beyond 1e-3 lr")
    assert dp.max() <= 1.0 and (dp > 1e-3).sum() <= 50


def test_train_step_matches_jax_bfloat16(tiny):
    variables, batch = tiny
    out, model = run_both("bfloat16", variables, batch)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in model.parameters())
    for k, o in enumerate(out):
        jm, tm = o["jmet"], o["tmet"]
        assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-2), k
        assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=5e-2), k
        assert tm["acc"] == jm["acc"], k
    flat = lambda tree: np.concatenate([a.ravel() for a in leaves(tree)])  # noqa: E731
    g32, gj = flat(jax_grads(jnp.float32, variables, batch)), flat(jax_grads(jnp.bfloat16, variables, batch))
    gt = flat(out[0]["tgrads"])
    err_j, err_t = (np.linalg.norm(g - g32) / np.linalg.norm(g32) for g in (gj, gt))
    print(f"bf16 gradients from the float32 ones: JAX {err_j:.4f}, port {err_t:.4f}")
    assert err_t <= 1.5 * err_j
    for a, b in zip(leaves(out[0]["jvars"]["batch_stats"]), leaves(out[0]["tvars"]["batch_stats"])):
        np.testing.assert_allclose(b, a, atol=1e-2)
    for a, b in zip(leaves(out[-1]["jvars"]["params"]), leaves(out[-1]["tvars"]["params"])):
        np.testing.assert_allclose(b, a, atol=2 * LR * len(out))


def test_eval_step_uses_running_statistics(tiny):
    variables, batch = tiny
    model = HRNet(HRNET_TINY.with_joints(J), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    ts = tstate.TrainState(model, toptim.build_optimizer("adam", model.parameters(), LR))
    tstate.make_train_step(True)(ts, {k: t(v) for k, v in batch.items()})
    assert model.training
    hm = tstate.make_eval_step()(ts, t(batch["image"]))
    assert not model.training
    jm = JHRNet(config=J_TINY.with_joints(J))
    want = np.asarray(jm.apply(module_to_flax(model), batch["image"], train=False))
    np.testing.assert_allclose(n(hm), want, atol=1e-4 * np.abs(want).max())


def test_state_dict_to_flax_round_trip_and_jax_load(tiny, tmp_path):
    """The port's trained variables go back to Flax's tree: exact through
    ``flax_to_state_dict``, the JAX ``HRNet`` gives the port's eval heatmaps
    (1e-4 of peak), and the ``.npz`` loads through ``evaluate.load_landmark_model``."""
    variables, batch = tiny
    model = HRNet(HRNET_TINY.with_joints(J), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    ts = tstate.TrainState(model, toptim.build_optimizer("adam", model.parameters(), LR))
    tstate.make_train_step(True)(ts, {k: t(v) for k, v in batch.items()})
    sd = model.state_dict()
    tree = module_to_flax(model)
    assert set(tree) == {"params", "batch_stats"}
    assert tree["params"]["stem1"]["conv"]["kernel"].shape == (3, 3, 3, 8)  # OIHW -> HWIO
    assert set(tree["batch_stats"]["stem1"]["bn"]) == {"mean", "var"}
    back = flax_to_state_dict(tree)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    jshapes = jax.eval_shape(lambda: JHRNet(config=J_TINY.with_joints(J)).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    assert jax.tree_util.tree_structure(jshapes) == jax.tree_util.tree_structure(tree)
    model.eval()
    with torch.no_grad():
        got = n(model(t(batch["image"])))
    want = np.asarray(JHRNet(config=J_TINY.with_joints(J)).apply(to_jax(tree), batch["image"], train=False))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, ts, {"epoch": 0})
    loaded = evaluate.load_landmark_model(mgr.npz_path(1), "hrnet_tiny", J, torch.float32, "cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(n(loaded(t(batch["image"]))), got)


def test_checkpoint_manager_rules(tiny, tmp_path):
    variables, batch = tiny
    tb = {k: t(v) for k, v in batch.items()}

    def fresh(opt="adam"):
        model = HRNet(HRNET_TINY.with_joints(J), device="cpu")
        model.load_state_dict(flax_to_state_dict(variables))
        return tstate.TrainState(model, toptim.build_optimizer(opt, model.parameters(), LR))

    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mgr.restore(fresh()) is None and mgr.latest_step() is None
    ts, step = fresh(), tstate.make_train_step(True)
    perfs = [0.2, 0.5, 0.4, 0.3, 0.1]
    for i, perf in enumerate(perfs):
        step(ts, tb)
        mgr.save(ts.step, ts, {"epoch": i})
        assert mgr.save_best(ts.step, perf, state=ts) == (perf > max(perfs[:i], default=-1))
    assert mgr.steps() == [3, 4, 5]  # max_to_keep
    assert not os.path.exists(mgr.npz_path(2)) and os.path.exists(mgr.npz_path(5))
    assert mgr.best_perf() == 0.5
    restored, meta, s = mgr.restore(fresh())
    assert (s, meta, restored.step) == (5, {"epoch": 4}, 5)
    for (k, a), b in zip(ts.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = ts.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)
    # the best state outlives the rolling window
    best, best_meta, best_step = mgr.restore_best(fresh())
    assert best_step == 2 and best_meta == {"perf": 0.5}
    # a placeholder optimizer of another structure: the model and step are taken
    other, _, _ = mgr.restore(fresh("sgd"), step=4)
    assert other.step == 4 and isinstance(other.optimizer.inner, torch.optim.SGD)
    # resuming continues the updates exactly
    step(ts, tb)
    step(restored, tb)
    assert all(torch.equal(a, b) for a, b in zip(ts.model.parameters(), restored.model.parameters()))
