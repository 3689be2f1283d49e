"""The port's DVS emulator (``events/emulator.py``, ``thres_estimator.py``)
against the JAX package's, on the JAX package's own draws.

The JAX functions draw from ``jax.random`` keys; the tests split those keys
as ``emulator.py:114`` and ``:165`` split them, make the same draws and
hand them to the port (``draws=``).

Bars. XLA's ``log`` and PyTorch's differ by one float32 ulp on a few
inputs (3 of the integers 0-255: 47, 49 and 179), so a lin-log value
may sit one 2^-21 grid step from JAX's: LOG_SHARE of the lin-log values
may differ, each by one step (read here: 1.17% of the integers, 1.41%
of random floats). Everything downstream of a lin-log value (the IIR
stages, the base frame) is held within LOG_STEPS grid steps, and the
event maps within MAX_FLIP_SHARE flipped (iteration, pixel) entries, for
a pixel one step from a threshold can cross it (read here: none).
Thresholds, timestamps, validity, counts and overflow are exact against
``emulate_frame``. Inside the jitted ``emulate_sequence`` XLA contracts
``t_prev + step * (i + 1)`` into a fused multiply-add, so there the
timestamps are held within TS_ULPS float32 ulps (read here: 3 of 72 one
ulp apart); the port rounds the product and the sum apart, as JAX does
outside a jit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.events import emulator as jem
from spacecraft_pose_estimation_tpu.events import thres_estimator as jthres
from spacecraft_pose_estimation_tpu_torch.events import emulator as tem
from spacecraft_pose_estimation_tpu_torch.events import thres_estimator as tthres
from torch_port_util import few_threads, n, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

H, W = 20, 28
BASE = jem.EmulatorConfig(pos_thres=0.2, neg_thres=0.2, sigma_thres=0.0, max_iters=6)
CONFIGS = {
    "clean": jem.EmulatorConfig.preset("clean"),
    "noisy": jem.EmulatorConfig.preset("noisy"),
    "sigma": dataclasses.replace(BASE, sigma_thres=0.05),
    "cutoff": dataclasses.replace(BASE, cutoff_hz=30.0),
    "leak": dataclasses.replace(BASE, leak_rate_hz=5.0),
    "shot": dataclasses.replace(BASE, shot_noise_rate_hz=50.0),
    "refractory": dataclasses.replace(BASE, refractory_period_s=0.003),
}
GRID = 2.0 ** -21  # lin_log's grid step
LOG_SHARE = 0.02  # lin-log values one grid step from JAX's
LOG_STEPS = 2  # grid steps allowed downstream of lin_log
MAX_FLIP_SHARE = 1e-3  # flipped (iteration, pixel) entries of the event maps
TS_ULPS = 1  # float32 ulps between the port's timestamps and the jitted scan's


def assert_within_ulps(got, want, ulps, msg=""):
    got, want = n(got), n(want)
    assert np.all(np.abs(got - want) <= ulps * np.spacing(np.abs(want).astype(np.float32))), msg


def torch_cfg(cfg: jem.EmulatorConfig) -> tem.EmulatorConfig:
    return tem.EmulatorConfig(**dataclasses.asdict(cfg))


def moving_frames(seed: int, num: int, h: int = H, w: int = W, gain: float = 1.0) -> np.ndarray:
    """A smooth textured blob that drifts and brightens, on a noisy
    background: every pixel sees both polarities over the stream."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    tex = rng.uniform(0, 40, (h, w)).astype(np.float32)
    out = []
    for i in range(num):
        cx, cy = 4 + 2.3 * i, h / 2 + 1.5 * np.sin(i)
        blob = 200 * np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / 18.0)
        out.append(np.clip(gain * (30 + tex + blob + 6 * i), 0, 255))
    return np.stack(out).astype(np.float32)


def jax_init_draws(key, shape):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {"pos": n(jax.random.normal(k1, shape)), "neg": n(jax.random.normal(k2, shape)),
            "noise": n(jax.random.normal(k3, shape))}, k4


def jax_frame_draws(key, shape, cfg):
    key, k_leak, k_shot = jax.random.split(key, 3)
    return {"leak": n(jax.random.normal(k_leak, shape)),
            "shot": n(jax.random.uniform(k_shot, (cfg.max_iters, *shape)))}, key


def torch_draws(d):
    return {k: t(v) for k, v in d.items()}


def flips(a, b) -> float:
    return float(np.mean(n(a) != n(b)))


@pytest.mark.parametrize("values", ["integers", "floats"])
def test_lin_log_equals_jax(values):
    """On the integers 0-255 and on random floats in [0, 300): on the
    2^-21 grid, at most one step from JAX's on at most LOG_SHARE of them;
    ``rescale_intensity`` exact."""
    if values == "integers":
        x = np.arange(256, dtype=np.float32)
    else:
        x = np.random.default_rng(0).uniform(0, 300, 20000).astype(np.float32)
    got, want = n(tem.lin_log(t(x))), n(jem.lin_log(jnp.asarray(x)))
    np.testing.assert_array_equal(got * 2 ** 21, np.round(got * 2 ** 21))  # on the grid
    assert np.abs(got - want).max() <= GRID
    share = float(np.mean(got != want))
    print(f"lin_log {values}: {share:.4%} one grid step from JAX's")
    assert share <= LOG_SHARE
    np.testing.assert_array_equal(n(tem.rescale_intensity(t(x))), n(jem.rescale_intensity(jnp.asarray(x))))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_state_and_frames_equal_jax_on_its_draws(name):
    """init_state, then 6 frames of emulate_frame: thresholds and the
    refractory memory exact, the IIR stages and the base frame within
    LOG_STEPS grid steps, the maps within MAX_FLIP_SHARE; timestamps,
    validity, counts and overflow exact."""
    cfg = CONFIGS[name]
    tcfg = torch_cfg(cfg)
    frames = moving_frames(1, 7)
    times = (np.arange(7) * 0.004).astype(np.float32)
    key = jax.random.key(3)
    jstate = jem.init_state(jnp.asarray(frames[0]), key, cfg)
    d0, fkey = jax_init_draws(key, (H, W))
    tstate = tem.init_state(t(frames[0]), tcfg, draws=torch_draws(d0))
    for field in ("pos_thres", "neg_thres", "pos_pre_prob", "neg_pre_prob", "timestamp_mem"):
        np.testing.assert_array_equal(n(getattr(tstate, field)), n(getattr(jstate, field)), err_msg=field)
    for field in ("base_log", "lp0", "lp1"):
        np.testing.assert_allclose(n(getattr(tstate, field)), n(getattr(jstate, field)), rtol=0,
                                   atol=LOG_STEPS * GRID, err_msg=field)
    np.testing.assert_allclose(n(tstate.noise_rate), n(jstate.noise_rate), rtol=1e-6)
    total, worst = 0, 0.0
    for i in range(1, 7):
        d, fkey = jax_frame_draws(fkey, (H, W), cfg)
        jstate, jout = jem.emulate_frame(jstate, jnp.asarray(frames[i]), jnp.asarray(times[i]), cfg)
        tstate, tout = tem.emulate_frame(tstate, t(frames[i]), t(times[i]), tcfg, draws=torch_draws(d))
        for key_ in ("pos", "neg"):
            worst = max(worst, flips(tout[key_], jout[key_]))
        for key_ in ("ts", "iter_valid", "num_events", "overflow"):
            np.testing.assert_array_equal(n(tout[key_]), n(jout[key_]), err_msg=f"{name} frame {i} {key_}")
        for field in ("timestamp_mem", "t_previous"):
            np.testing.assert_array_equal(n(getattr(tstate, field)), n(getattr(jstate, field)),
                                          err_msg=f"{name} frame {i} {field}")
        for field in ("base_log", "lp0", "lp1"):
            np.testing.assert_allclose(n(getattr(tstate, field)), n(getattr(jstate, field)), rtol=0,
                                       atol=LOG_STEPS * GRID, err_msg=f"{name} frame {i} {field}")
        total += int(tout["num_events"])
    print(f"{name}: {total} events, worst flipped share {worst}")
    assert worst <= MAX_FLIP_SHARE
    assert total > 0


def test_overflow_is_clipped_and_deferred_as_in_jax():
    """A step too large for max_iters = 2: the same overflow count, the
    same capped maps, and the residual fires on the next frames."""
    cfg = dataclasses.replace(BASE, max_iters=2)
    f0 = np.full((8, 8), 20.0, np.float32)
    f1 = np.full((8, 8), 250.0, np.float32)
    jstate = jem.init_state(jnp.asarray(f0), jax.random.key(0), cfg)
    tstate = tem.init_state(t(f0), torch_cfg(cfg), draws=torch_draws(jax_init_draws(jax.random.key(0), (8, 8))[0]))
    overflow = []
    for i, f in enumerate((f1, f1, f1)):
        jstate, jout = jem.emulate_frame(jstate, jnp.asarray(f), jnp.asarray(0.01 * (i + 1)), cfg)
        tstate, tout = tem.emulate_frame(tstate, t(f), t(np.float32(0.01 * (i + 1))), torch_cfg(cfg), draws={})
        for key_ in ("pos", "neg", "ts", "iter_valid", "num_events", "overflow"):
            np.testing.assert_array_equal(n(tout[key_]), n(jout[key_]), err_msg=f"frame {i} {key_}")
        overflow.append(int(tout["overflow"]))
    assert overflow[0] > 0 and overflow[0] > overflow[1] > overflow[2] >= 0


def test_zero_event_frame_emits_no_shot_noise():
    """A static frame with shot noise on: num_iters is 0, so nothing fires,
    noise included, in both packages."""
    cfg = CONFIGS["shot"]
    frame = np.full((16, 16), 128.0, np.float32)
    key = jax.random.key(5)
    jstate = jem.init_state(jnp.asarray(frame), key, cfg)
    d0, fkey = jax_init_draws(key, (16, 16))
    tstate = tem.init_state(t(frame), torch_cfg(cfg), draws=torch_draws(d0))
    for k in range(4):
        d, fkey = jax_frame_draws(fkey, (16, 16), cfg)
        jstate, jout = jem.emulate_frame(jstate, jnp.asarray(frame), jnp.asarray(0.05 * (k + 1)), cfg)
        tstate, tout = tem.emulate_frame(tstate, t(frame), t(np.float32(0.05 * (k + 1))), torch_cfg(cfg),
                                         draws=torch_draws(d))
        assert int(tout["num_events"]) == int(jout["num_events"]) == 0
        assert not bool(tout["pos"].any() | tout["neg"].any())


@pytest.mark.parametrize("name", ["clean", "noisy"])
def test_sequence_chunks_equal_one_run(name):
    """The port's own draws (a generator per frame): emulate_sequence in
    chunks of 3 equals one run over 9 frames, bit for bit; and JAX's
    emulate_sequence on its draws equals the port's on the same draws."""
    cfg = CONFIGS[name]
    tcfg = torch_cfg(cfg)
    frames = moving_frames(2, 10)
    times = (np.arange(10) * 0.004).astype(np.float32)
    s_one = tem.init_state(t(frames[0]), tcfg, seed=7)
    s_one, one = tem.emulate_sequence(s_one, t(frames[1:]), t(times[1:]), tcfg)
    s_ch = tem.init_state(t(frames[0]), tcfg, seed=7)
    parts = []
    for i in range(1, 10, 3):
        s_ch, out = tem.emulate_sequence(s_ch, t(frames[i:i + 3]), t(times[i:i + 3]), tcfg)
        parts.append(out)
    for key_ in one:
        np.testing.assert_array_equal(n(torch.cat([p[key_] for p in parts])), n(one[key_]), err_msg=key_)
    np.testing.assert_array_equal(n(s_ch.base_log), n(s_one.base_log))
    assert int(one["num_events"].sum()) > 0

    key = jax.random.key(11)
    jstate = jem.init_state(jnp.asarray(frames[0]), key, cfg)
    _, jout = jem.emulate_sequence(jstate, jnp.asarray(frames[1:]), jnp.asarray(times[1:]), cfg)
    d0, fkey = jax_init_draws(key, (H, W))
    per_frame = []
    for _ in range(9):
        d, fkey = jax_frame_draws(fkey, (H, W), cfg)
        per_frame.append(d)
    draws = {k: t(np.stack([d[k] for d in per_frame])) for k in per_frame[0]}
    tstate = tem.init_state(t(frames[0]), tcfg, draws=torch_draws(d0))
    _, tout = tem.emulate_sequence(tstate, t(frames[1:]), t(times[1:]), tcfg, draws=draws)
    for key_ in ("pos", "neg"):
        assert flips(tout[key_], jout[key_]) <= MAX_FLIP_SHARE, key_
    for key_ in ("iter_valid", "num_events", "overflow"):
        np.testing.assert_array_equal(n(tout[key_]), n(jout[key_]), err_msg=key_)
    assert_within_ulps(tout["ts"], jout["ts"], TS_ULPS, "ts")


def test_estimate_threshold_equals_jax():
    """The bisection on the same frames and draws lands on the same
    threshold (every probe's count equal)."""
    cfg = dataclasses.replace(CONFIGS["clean"], sigma_thres=0.03)
    frames = moving_frames(4, 6, 16, 16)
    times = (np.arange(6) * 0.005).astype(np.float32)
    key = jax.random.key(2)
    d0, _ = jax_init_draws(key, (16, 16))
    target = 900
    jt = jthres.estimate_threshold(jnp.asarray(frames), jnp.asarray(times), target, key, cfg, steps=8)
    tt = tthres.estimate_threshold(t(frames), t(times), target, torch_cfg(cfg), steps=8,
                                   draws={"init": torch_draws(d0)})
    assert tt == jt
    for thr in (0.1, 0.3):
        assert tthres.count_events(t(frames), t(times), thr, torch_cfg(cfg), draws={"init": torch_draws(d0)}) \
            == jthres.count_events(jnp.asarray(frames), jnp.asarray(times), thr, key, cfg)
