"""Port parity of ``train/optim.py``: the multistep schedule and each optimizer branch against optax.

* ``multistep_schedule`` against the JAX package's (optax
  ``piecewise_constant_schedule`` and ``linear_schedule``) at every step
  from 0 to 12, the milestones' steps m - 1, m and m + 1 among them: the
  drop is at step m itself; 1e-6 relative (optax computes in float32).
* ``build_optimizer``: adam, adamw, sgd (plain and Nesterov), and adam
  and sgd behind the global-norm clip (reached and not), 3 updates on a toy tree whose gradients
  each package computes from its own parameters (g = c * p + d), the
  learning rate from the schedule at the count of updates done: the
  parameters within 1e-6 relative plus 1e-5 of the learning rate per update
  of optax's (Adam's bias corrections are float32 in optax, Python floats
  in torch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from spacecraft_pose_estimation_tpu.train import optim as joptim
from spacecraft_pose_estimation_tpu_torch.train import optim as toptim


@pytest.mark.parametrize("warmup", [0, 4])
def test_multistep_schedule_matches_optax(warmup):
    jsched = joptim.multistep_schedule(1e-3, [3, 7], 0.1, warmup_steps=warmup, warmup_factor=1e-2)
    tsched = toptim.multistep_schedule(1e-3, [3, 7], 0.1, warmup_steps=warmup, warmup_factor=1e-2)
    for step in range(13):
        assert tsched(step) == pytest.approx(float(jsched(step)), rel=1e-6), step
    if not warmup:  # the drop lands on the milestone's own step, as optax puts it
        assert [tsched(s) for s in (2, 3, 4, 6, 7, 8)] == pytest.approx([1e-3, 1e-4, 1e-4, 1e-4, 1e-5, 1e-5])


CASES = {
    "adam": dict(name="adam", weight_decay=1e-2),  # the decay must not reach Adam
    "adamw": dict(name="adamw", weight_decay=1e-2),
    "sgd": dict(name="sgd", weight_decay=1e-2, momentum=0.9),
    "sgd_nesterov": dict(name="sgd", weight_decay=1e-2, momentum=0.9, nesterov=True),
    "adam_clipped": dict(name="adam", grad_clip_norm=0.5),
    "sgd_clipped": dict(name="sgd", momentum=0.9, grad_clip_norm=0.5),
    "sgd_clipped_not_reached": dict(name="sgd", momentum=0.5, grad_clip_norm=1e3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_optimizer_matches_optax(case):
    kw = CASES[case]
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    c = {k: rng.uniform(0.5, 2.0, v.shape).astype(np.float32) for k, v in p0.items()}
    d = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
    lr = 0.1
    jsched = joptim.multistep_schedule(lr, [2], 0.5)
    tx = joptim.build_optimizer(learning_rate=jsched, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = toptim.build_optimizer(params=list(tp.values()), learning_rate=toptim.multistep_schedule(lr, [2], 0.5),
                                  **kw)
    for count in range(3):
        grads = {k: c[k] * jp[k] + d[k] for k in jp}
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(c[k]) * p.detach() + torch.from_numpy(d[k])
        topt.step(count)
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-5 * lr * (count + 1))
    moved = max(float(np.abs(np.asarray(jp[k]) - p0[k]).max()) for k in p0)
    assert moved > 0.05  # the updates did something to hold


def test_adam_ignores_weight_decay():
    """The preset's wd=1e-4 goes to ``build_optimizer`` and not into Adam."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.build_optimizer("adam", [p], 1e-3, weight_decay=1e-4)
    assert opt.inner.param_groups[0]["weight_decay"] == 0.0
    assert isinstance(opt.inner, torch.optim.Adam) and not isinstance(opt.inner, torch.optim.AdamW)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.build_optimizer("lamb", [p], 1e-3)


def _toy(seed):
    model = torch.nn.Linear(4, 3)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return model


def _grads(model, seed):
    """g = c * p + d, the same rule on either side."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.named_parameters():
        c, d = rng.uniform(0.5, 2.0, p.shape).astype(np.float32), rng.normal(size=p.shape).astype(np.float32)
        p.grad = torch.from_numpy(c) * p.detach() + torch.from_numpy(d)
        out[name] = (c, d)
    return out


def _saved(state):
    import io

    buf = io.BytesIO()
    torch.save(state.state_dict(), buf)
    buf.seek(0)
    return torch.load(buf, weights_only=True)


@pytest.mark.parametrize("saved_with", ["sgd", "adam"])
def test_resume_keeps_the_trainers_hyperparameters(saved_with):
    """A ``TrainState`` saved after one update of SGD (weight decay 0,
    momentum 0.9) or Adam, restored into SGD with weight decay 1e-4 and
    momentum 0.9: the group keeps 1e-4 and 0.9, and the next update equals
    optax's ``add_decayed_weights`` + ``sgd`` (the JAX ``build_optimizer``)
    from the same parameters and, where the saved state fits (SGD), the
    same trace; Adam's state does not fit SGD, so only the model and the
    step are taken, and the trace starts at 0."""
    from spacecraft_pose_estimation_tpu_torch.train.state import TrainState

    lr = 0.1
    src = _toy(0)
    kw = dict(weight_decay=0.0, momentum=0.9) if saved_with == "sgd" else {}
    src_opt = toptim.build_optimizer(saved_with, src.parameters(), lr, **kw)
    _grads(src, 1)
    src_opt.step(0)
    payload = _saved(TrainState(src, src_opt, step=1))

    dst = _toy(5)
    state = TrainState(dst, toptim.build_optimizer("sgd", dst.parameters(), lr, weight_decay=1e-4, momentum=0.9))
    state.load_state_dict(payload)
    group = state.optimizer.inner.param_groups[0]
    assert (group["weight_decay"], group["momentum"], group["nesterov"]) == (1e-4, 0.9, False)
    assert state.step == 1
    for (name, p), q in zip(dst.named_parameters(), src.parameters()):
        assert torch.equal(p, q), name
    trace = {name: (src_opt.inner.state[q]["momentum_buffer"].numpy() if saved_with == "sgd" else np.zeros(q.shape,
                                                                                                      np.float32))
             for (name, _), q in zip(dst.named_parameters(), src.parameters())}
    assert bool(state.optimizer.inner.state) == (saved_with == "sgd")

    params = {name: jnp.asarray(p.detach().numpy().copy()) for name, p in dst.named_parameters()}
    cd = _grads(dst, 2)
    state.optimizer.step(state.step)
    tx = joptim.build_optimizer("sgd", lr, weight_decay=1e-4, momentum=0.9)
    opt_state = optax.tree_utils.tree_set(tx.init(params), trace={k: jnp.asarray(v) for k, v in trace.items()})
    grads = {k: cd[k][0] * params[k] + cd[k][1] for k in params}
    updates, _ = tx.update(grads, opt_state, params)
    want = optax.apply_updates(params, updates)
    for name, p in dst.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), rtol=1e-6, atol=1e-7, err_msg=name)


def test_da_resume_keeps_each_optimizers_hyperparameters():
    """``DAState`` takes the same rule for both of its optimizers: Adam's
    state saved from a run whose discriminator used SGD at weight decay 0
    is restored into SGD at 1e-4, which keeps 1e-4; a generator's Adam
    state restored into Adam loads."""
    from spacecraft_pose_estimation_tpu_torch.train.adversarial import DAState

    def state(disc_wd):
        gen, disc = _toy(0), _toy(1)
        return DAState(gen, disc, toptim.build_optimizer("adam", gen.parameters(), 1e-3),
                       toptim.build_optimizer("sgd", disc.parameters(), 1e-2, weight_decay=disc_wd))

    src = state(0.0)
    for model, opt in ((src.generator, src.gen_optimizer), (src.discriminator, src.disc_optimizer)):
        _grads(model, 3)
        opt.step(0)
    src.step = 1
    dst = state(1e-4)
    dst.load_state_dict(_saved(src))
    assert dst.step == 1 and dst.disc_optimizer.inner.param_groups[0]["weight_decay"] == 1e-4
    for p, q in zip(dst.gen_optimizer.inner.param_groups[0]["params"], src.gen_optimizer.inner.param_groups[0]["params"]):
        assert torch.equal(dst.gen_optimizer.inner.state[p]["exp_avg"], src.gen_optimizer.inner.state[q]["exp_avg"])
