"""Port parity of the domain-adaptation step (``train/adversarial.py``).

``hrnet_tiny_cms`` at 64x64 (11 joints, heatmaps 64..8) and the
discriminator at ``stage_blocks=(1, 1, 1, 1)``, float32, one
numpy-seeded variable tree each, 2 source and 2 target images with
seeded targets at the four scales; Adam 1e-3 for both models with a
milestone at step 2 (the third update runs at 1e-4), ``beta`` 0.5 (so
that the adversarial gradient weighs in the generator's update), both
``d_loss_mode``s. The JAX step is jitted: its compile costs less than 3
eager updates.

The packages are held phase by phase at each of 3 updates: the port
takes JAX's state (both models' parameters and BN statistics, both Adam
states); its phase 1 is held to JAX's updated discriminator; it then takes
that discriminator, and its phase 2 is held to JAX's updated generator and
metrics. Free-running float32 trajectories are not comparable here: the
first Adam update moves each entry by about lr * sign(gradient), and
0.03% of the discriminator's 4.9M entries have gradients whose sign is
float32 rounding; those land 2 lr apart, and the discriminator, which fits
the 4 images in one update (``d_loss`` 0.71 -> 0.011), then reads the
generator's outputs through weights whose small differences move its
gradients: by the third free update 48% of its entries are beyond 1e-3 lr.
Even from the same state, the adversarial gradient through the saturated
discriminator carries ~1e-3 relative float32 error per entry (measured:
in ``d_loss_mode`` 2 at the second update, 28% of the generator's entries
beyond 1e-3 lr, 3% beyond 1e-2 lr, 0.05% beyond 0.1 lr, max 1.0 lr, with
the metrics within 3e-6). Bounds at each update:

* ``loss``, ``hm_loss``, ``d_loss``, ``adv_loss`` within 1e-4 relative
  (measured: at most 2.6e-5);
* both models' BN running statistics within 1e-5;
* both parameter sets within 2 lr (an entry whose gradient sign is
  rounding moves by lr either way), at most 0.1% of the entries beyond
  0.1 lr; the share beyond 1e-3 lr is printed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models.discriminator import MultiScaleDiscriminator as JDisc
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import heatmap as jhm
from spacecraft_pose_estimation_tpu.train import adversarial as jadv, optim as joptim
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, module_to_flax
from spacecraft_pose_estimation_tpu_torch.models.discriminator import MultiScaleDiscriminator
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
from spacecraft_pose_estimation_tpu_torch.train import adversarial as tadv, optim as toptim
from spacecraft_pose_estimation_tpu_torch.train.checkpoint import CheckpointManager

from torch_port_util import few_threads, load_jax_state, np_tree, random_variables, t, to_jax

pytestmark = pytest.mark.usefixtures("few_threads")
J, LR, MILESTONES, BETA = 11, 1e-3, [2], 0.5
SIZE, NS, NT = 64, 2, 2


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def da_setup():
    cfg = dataclasses.replace(J_TINY.with_joints(J), head="cms")
    jm, jd = JHRNet(config=cfg), JDisc(stage_blocks=(1, 1, 1, 1))
    gvars = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False),
                             seed=11, overrides={"head": 0.1})
    hs = [jnp.zeros((1, SIZE >> i, SIZE >> i, J)) for i in range(4)]
    dvars = random_variables(lambda: jd.init(jax.random.key(1), *hs, train=False), seed=12)
    rng = np.random.default_rng(13)
    batch = {"source_image": rng.normal(size=(NS, SIZE, SIZE, 3)).astype(np.float32),
             "target_image": rng.normal(size=(NT, SIZE, SIZE, 3)).astype(np.float32)}
    joints = rng.uniform(0, SIZE, (NS, J, 2)).astype(np.float32)
    vis = (rng.uniform(size=(NS, J)) > 0.1).astype(np.float32)
    for idx, div in enumerate((1, 2, 4, 8)):
        tg, tw = jax.vmap(lambda a, v: jhm.generate_target(a, v, (SIZE, SIZE), (SIZE // div, SIZE // div),
                                                           4.0 / (idx + 1)))(joints, vis)
        suffix = "" if idx == 0 else str(idx + 1)
        batch[f"target{suffix}"], batch[f"target_weight{suffix}"] = np.asarray(tg), np.asarray(tw)
    return jm, jd, gvars, dvars, batch


def port_state(gvars, dvars):
    gen = HRNet(dataclasses.replace(HRNET_TINY.with_joints(J), head="cms"), device="cpu")
    gen.load_state_dict(flax_to_state_dict(gvars))
    disc = MultiScaleDiscriminator(J, stage_blocks=(1, 1, 1, 1), device="cpu")
    disc.load_state_dict(flax_to_state_dict(dvars))
    schedule = toptim.multistep_schedule(LR, MILESTONES)
    return tadv.DAState(gen, disc, toptim.build_optimizer("adam", gen.parameters(), schedule, weight_decay=1e-4),
                        toptim.build_optimizer("adam", disc.parameters(), schedule))


def jax_state(jm, jd, gvars, dvars):
    sched = joptim.multistep_schedule(LR, MILESTONES)
    return jadv.DAState.create(jm, to_jax(gvars), jd, to_jax(dvars),
                               joptim.build_optimizer("adam", sched, weight_decay=1e-4),
                               joptim.build_optimizer("adam", sched))


def drift(jtree, ttree, lr):
    """|JAX - port| of every entry in units of ``lr``."""
    return np.concatenate([np.abs(a - b).ravel() for a, b in zip(leaves(jtree), leaves(ttree))]) / lr


def assert_params_close(jtree, ttree, lr, label):
    dp = drift(jtree, ttree, lr)
    print(f"{label}: {dp.size} entries, max {dp.max():.4g} lr, {(dp > 0.1).sum()} beyond 0.1 lr, "
          f"{(dp > 1e-3).sum()} beyond 1e-3 lr")
    assert dp.max() <= 2.0 and (dp > 0.1).mean() <= 1e-3, label


def assert_stats_close(jstats, tstats):
    assert jax.tree_util.tree_structure(jstats) == jax.tree_util.tree_structure(tstats)
    for a, b in zip(leaves(jstats), leaves(tstats)):
        np.testing.assert_allclose(b, a, atol=1e-5)


@pytest.mark.parametrize("d_loss_mode", [1, 2])
def test_da_step_matches_jax(da_setup, d_loss_mode):
    """Each update from JAX's state: phase 1 against JAX's updated
    discriminator, then phase 2 from JAX's updated discriminator against
    JAX's updated generator and metrics."""
    jm, jd, gvars, dvars, batch = da_setup
    js = jax_state(jm, jd, gvars, dvars)
    jstep = jax.jit(jadv.make_da_train_step(beta=BETA, d_loss_mode=d_loss_mode))
    ts = port_state(gvars, dvars)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, {k: t(v) for k, v in batch.items()}
    for k in range(3):
        load_jax_state(ts, js)
        js, jmet = jstep(js, jb)
        lr = LR * (0.1 if k >= MILESTONES[0] else 1.0)
        domain = tadv.domain_labels(tb)
        outs = tadv.generator_forward(ts, tb)
        d_loss = tadv.discriminator_update(ts, outs, domain)
        assert float(d_loss) == pytest.approx(float(jmet["d_loss"]), rel=1e-4), k
        disc = module_to_flax(ts.discriminator)
        assert_stats_close(js.disc_stats, disc["batch_stats"])
        assert_params_close(js.disc_params, disc["params"], lr, f"mode {d_loss_mode}, update {k}: discriminator")
        ts.discriminator.load_state_dict(flax_to_state_dict({"params": np_tree(js.disc_params),
                                                             "batch_stats": np_tree(js.disc_stats)}))
        loss, hm_loss, adv = tadv.generator_update(ts, outs, tb, domain, BETA, d_loss_mode)
        for name, v in (("loss", loss), ("hm_loss", hm_loss), ("adv_loss", adv)):
            assert float(v) == pytest.approx(float(jmet[name]), rel=1e-4), (k, name)
        gen = module_to_flax(ts.generator)
        assert_stats_close(js.gen_stats, gen["batch_stats"])
        assert_params_close(js.gen_params, gen["params"], lr, f"mode {d_loss_mode}, update {k}: generator")


def test_da_step_is_its_three_phases(da_setup):
    """``make_da_train_step`` is the three phases in order and one more
    step: the same metrics and states, bit for bit."""
    _, _, gvars, dvars, batch = da_setup
    tb = {k: t(v) for k, v in batch.items()}
    a, b = port_state(gvars, dvars), port_state(gvars, dvars)
    step = tadv.make_da_train_step(beta=BETA, d_loss_mode=2)
    for _ in range(2):
        met = step(a, tb)
        domain = tadv.domain_labels(tb)
        outs = tadv.generator_forward(b, tb)
        d_loss = tadv.discriminator_update(b, outs, domain)
        loss, hm_loss, adv = tadv.generator_update(b, outs, tb, domain, BETA, 2)
        b.step += 1
        assert [met[k].item() for k in ("loss", "hm_loss", "d_loss", "adv_loss")] == \
            [v.item() for v in (loss, hm_loss, d_loss, adv)]
    assert a.step == b.step == 2
    for x, y in zip(a.state_dict()["generator"].values(), b.state_dict()["generator"].values()):
        assert torch.equal(x, y)
    for x, y in zip(a.state_dict()["discriminator"].values(), b.state_dict()["discriminator"].values()):
        assert torch.equal(x, y)


def test_generator_update_leaves_the_discriminator_alone(da_setup):
    """Phase 2 reads the updated discriminator in eval mode: its parameters,
    gradients and running statistics come out of the generator's update
    as phase 1 left them, and it trains again afterwards; the adversarial
    term's gradient reaches the generator (beta changes its gradients); the
    generator's BN running statistics move once a step."""
    _, _, gvars, dvars, batch = da_setup
    tb = {k: t(v) for k, v in batch.items()}
    grads = {}
    for beta in (0.0, BETA):
        ts = port_state(gvars, dvars)
        domain = tadv.domain_labels(tb)
        outs = tadv.generator_forward(ts, tb)
        stats_after_forward = {k: v.clone() for k, v in ts.generator.state_dict().items() if k.endswith(".mean")}
        tadv.discriminator_update(ts, outs, domain)
        disc_after_1 = {k: v.clone() for k, v in ts.discriminator.state_dict().items()}
        disc_grads_1 = [p.grad.clone() for p in ts.discriminator.parameters()]
        tadv.generator_update(ts, outs, tb, domain, beta, 2)
        for k, v in ts.discriminator.state_dict().items():
            assert torch.equal(v, disc_after_1[k]), k
        assert all(torch.equal(p.grad, g) for p, g in zip(ts.discriminator.parameters(), disc_grads_1))
        assert all(p.requires_grad for p in ts.discriminator.parameters())
        assert not ts.discriminator.training
        assert all(torch.equal(ts.generator.state_dict()[k], v) for k, v in stats_after_forward.items())
        grads[beta] = torch.cat([p.grad.flatten() for p in ts.generator.parameters()])
    assert (grads[BETA] - grads[0.0]).abs().max() > 1e-3 * grads[0.0].abs().max()


def test_da_state_round_trips_through_the_checkpoint(da_setup, tmp_path):
    _, _, gvars, dvars, batch = da_setup
    tb = {k: t(v) for k, v in batch.items()}
    step = tadv.make_da_train_step(beta=BETA, d_loss_mode=2)
    ts = port_state(gvars, dvars)
    step(ts, tb)
    mgr = CheckpointManager(str(tmp_path / "da"), max_to_keep=2)
    mgr.save(ts.step, ts, {"epoch": 0})
    other = port_state(random_variables(lambda: gvars, seed=1), random_variables(lambda: dvars, seed=2))
    _, meta, s = mgr.restore(other)
    assert (s, meta, other.step) == (1, {"epoch": 0}, 1)
    for a, b in ((ts.generator, other.generator), (ts.discriminator, other.discriminator)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    # the .npz holds the generator; both states resume exactly
    npz = np.load(mgr.npz_path(1))
    assert "params/head0/deconv/kernel" in npz.files and not any("layer1_b0" in k for k in npz.files)
    m1, m2 = step(ts, tb), step(other, tb)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(x, y) for x, y in zip(ts.generator.parameters(), other.generator.parameters()))
