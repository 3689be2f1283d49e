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
