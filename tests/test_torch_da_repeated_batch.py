"""The repeated-batch DA check at the preset's Adam 1e-3, on the CPU.

``chip_smoke.py``'s gate "10 DA updates on one repeated batch lower the
hm_loss" runs at Adam 1e-4, because at the ``lightbox_cms`` preset's 1e-3
the port's hm_loss rose after the first update (0.010312 -> 0.011854 on
the card, W32 CMS at 768^2 with a bf16 generator) and was back to only
0.010301 after 10. This holds the JAX package's DA step to the same
question on one batch: ``hrnet_tiny_cms`` (11 joints, 128x128 crops,
heatmaps 128..16), the discriminator at one block a stage, 2 source and 3
target images, the preset's ``beta`` (2e-4) and ``d_loss_mode`` 2, Adam
1e-3 for both models, 10 updates from JAX's initial state (the JAX
package's initialisers).

What it pins:

* each update's ``loss``, ``hm_loss``, ``d_loss`` and ``adv_loss``: the
  port's step from JAX's state before that update (both models'
  parameters and BN statistics, both Adam states) against JAX's, within
  METRIC_REL relative (read: at most 6.7e-5, adv_loss at update 2);
* the free-running runs: free-running float32 Adam trajectories part (the
  first update moves an entry whose gradient sign is rounding by lr either
  way; ``test_torch_adversarial.py``), but hm_loss, which the adversarial
  term moves at 2e-4, stays within HM_REL relative (read: 3.0e-4);
* in both packages hm_loss rises at the second update (0.0026608 ->
  0.0026612 in JAX) and falls at every update after it (0.00207 at the
  tenth): the rise after the first update at Adam 1e-3 is the JAX step's
  behaviour, not a fault of the port; here it is +1.2e-4 relative, on the
  card +15%;
* ``d_loss_mode`` 2 does not diverge in either package over these 10
  updates (read: d_loss <= 0.78, adv_loss >= -1.77).

``-s`` prints the three trajectories.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models.discriminator import MultiScaleDiscriminator as JDisc
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import heatmap as jhm
from spacecraft_pose_estimation_tpu.train import adversarial as jadv, optim as joptim
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models.discriminator import MultiScaleDiscriminator
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
from spacecraft_pose_estimation_tpu_torch.train import adversarial as tadv, optim as toptim

from torch_port_util import few_threads, load_jax_state, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")
J, SIZE, NS, NT, LR, BETA, MODE, UPDATES = 11, 128, 2, 3, 1e-3, 2e-4, 2, 10
STAGES = (1, 1, 1, 1)
HM_REL = 1e-3  # relative hm_loss agreement of the free-running runs (read: at most 3.0e-4, at update 10)
METRIC_REL = 1e-4  # relative agreement of each update's losses from JAX's state (as test_torch_adversarial.py)
METRICS = ("loss", "hm_loss", "d_loss", "adv_loss")


def port_state(gvars, dvars):
    gen = HRNet(dataclasses.replace(HRNET_TINY.with_joints(J), head="cms"), device="cpu")
    gen.load_state_dict(flax_to_state_dict(gvars))
    disc = MultiScaleDiscriminator(J, stage_blocks=STAGES, device="cpu")
    disc.load_state_dict(flax_to_state_dict(dvars))
    return tadv.DAState(gen, disc, toptim.build_optimizer("adam", gen.parameters(), LR),
                        toptim.build_optimizer("adam", disc.parameters(), LR))


def batch_and_variables():
    cfg = dataclasses.replace(J_TINY.with_joints(J), head="cms")
    jm, jd = JHRNet(config=cfg), JDisc(stage_blocks=STAGES)
    gvars = jm.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    hs = [jnp.zeros((1, SIZE >> i, SIZE >> i, J)) for i in range(4)]
    dvars = jd.init(jax.random.key(1), *hs, train=False)
    rng = np.random.default_rng(13)
    batch = {"source_image": rng.normal(size=(NS, SIZE, SIZE, 3)).astype(np.float32),
             "target_image": rng.normal(size=(NT, SIZE, SIZE, 3)).astype(np.float32)}
    joints = rng.uniform(8, SIZE - 8, (NS, J, 2)).astype(np.float32)
    vis = np.ones((NS, J), np.float32)
    for idx, sigma in enumerate((12.0, 10.0, 8.0, 6.0)):  # the preset's sigmas over 768 -> 64, per scale
        hw = (SIZE >> idx, SIZE >> idx)
        tg, tw = jax.vmap(lambda a, v: jhm.generate_target(a, v, (SIZE, SIZE), hw, sigma / 12 * (1 << idx) ** -1))(
            joints, vis)
        suffix = "" if idx == 0 else str(idx + 1)
        batch[f"target{suffix}"], batch[f"target_weight{suffix}"] = np.asarray(tg), np.asarray(tw)
    return jm, jd, gvars, dvars, batch


def test_da_updates_at_adam_1e3_track_jax():
    jm, jd, gvars, dvars, batch = batch_and_variables()
    js = jadv.DAState.create(jm, gvars, jd, dvars, joptim.build_optimizer("adam", LR),
                             joptim.build_optimizer("adam", LR))
    jstep = jax.jit(jadv.make_da_train_step(beta=BETA, d_loss_mode=MODE))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_states, jax_hist = [], []
    for _ in range(UPDATES):
        jax_states.append(js)
        js, met = jstep(js, jb)
        jax_hist.append({k: float(met[k]) for k in METRICS})

    np_vars = jax.tree_util.tree_map(np.asarray, (gvars, dvars))
    step = tadv.make_da_train_step(beta=BETA, d_loss_mode=MODE)
    tb = {k: t(v) for k, v in batch.items()}
    free = port_state(*np_vars)
    free_hist = [{k: float(v) for k, v in step(free, tb).items() if k in METRICS} for _ in range(UPDATES)]
    forced = port_state(*np_vars)
    forced_hist = []
    for state in jax_states:
        load_jax_state(forced, state)
        forced_hist.append({k: float(v) for k, v in step(forced, tb).items() if k in METRICS})

    for k, (a, b, c) in enumerate(zip(jax_hist, forced_hist, free_hist)):
        print(f"update {k + 1}: " + "; ".join(f"{m} JAX {a[m]:.7g} port from JAX's state {b[m]:.7g} port free {c[m]:.7g}"
                                              for m in METRICS))
    rel = {m: max(abs(a[m] - b[m]) / abs(a[m]) for a, b in zip(jax_hist, forced_hist)) for m in METRICS}
    print("max relative |JAX - port| from JAX's state: " + ", ".join(f"{m} {v:.3g}" for m, v in rel.items()))
    # every update's losses, from JAX's state before it
    assert all(v <= METRIC_REL for v in rel.values()), rel
    jh = [h["hm_loss"] for h in jax_hist]
    ph = [h["hm_loss"] for h in free_hist]
    for a, b in zip(jh, ph):
        assert abs(a - b) <= HM_REL * abs(a)
    # in both packages hm_loss rises at the second update, then falls at every one after it
    for h in (jh, ph):
        assert h[1] > h[0] and all(b < a for a, b in zip(h[1:], h[2:])), h
    # nor does d_loss_mode 2 diverge over the 10 updates
    assert all(abs(h["d_loss"]) < 10 and abs(h["adv_loss"]) < 10 for h in jax_hist + free_hist)
