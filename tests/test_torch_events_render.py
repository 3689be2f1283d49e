"""The port's event renderer (``events/renderer.py``) against the JAX
package's, on the same dense maps: every mode exact (frames and window end
times), empty windows' end times -inf in both. The jitted JAX renderers
normalise by a reciprocal and the eager ``finalize_duration`` by a
division; the port's do as their counterparts, and full-scale counts of 2
and 3 hold both."""

import numpy as np
import pytest

import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.events import renderer as jr
from spacecraft_pose_estimation_tpu_torch.events import renderer as tr
from torch_port_util import few_threads, n, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def dense_maps(seed: int, frames: int = 6, iters: int = 4, h: int = 10, w: int = 13, density: float = 0.08,
               quiet_frames: tuple = ()):
    """Seeded maps as the emulator makes them: per frame a valid prefix of
    iterations, timestamps rising through each frame; ``quiet_frames`` emit
    nothing (no valid iteration), which leaves windows empty."""
    rng = np.random.default_rng(seed)
    pos = rng.random((frames, iters, h, w)) < density
    neg = (rng.random((frames, iters, h, w)) < density) & ~pos
    num = rng.integers(1, iters + 1, frames)
    num[list(quiet_frames)] = 0
    valid = np.arange(iters)[None] < num[:, None]
    dt = np.float32(0.01)
    ts = np.stack([np.float32(f * dt) + (dt / max(k, 1)) * (np.arange(iters, dtype=np.float32) + 1)
                   for f, k in enumerate(num)]).astype(np.float32)
    return pos, neg, ts, valid


def both(fn_name, *args, **kwargs):
    jout = getattr(jr, fn_name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kwargs)
    tout = getattr(tr, fn_name)(*(t(a) if isinstance(a, np.ndarray) else a for a in args), **kwargs)
    return tout, jout


@pytest.mark.parametrize("exposure", [0.007, 0.01, 0.025])
def test_duration_equals_jax(exposure):
    """Windows of 7, 10 and 25 ms over a 60 ms stream with two quiet frames:
    the raw sums and the normalised frames exact; chunked sums equal one pass."""
    pos, neg, ts, valid = dense_maps(0, quiet_frames=(2, 3))
    num_frames = int(np.ceil(ts[valid].max() / exposure))
    tacc, jacc = both("duration_acc", pos, neg, ts, valid, np.float32(0.0), exposure, num_frames)
    np.testing.assert_array_equal(n(tacc), n(jacc))
    for fsc in (2, 3):
        tfr, jfr = both("render_duration", pos, neg, ts, valid, np.float32(0.0), exposure, num_frames,
                        full_scale_count=fsc)
        np.testing.assert_array_equal(n(tfr), n(jfr))
    parts = sum(tr.duration_acc(t(pos[i:i + 2]), t(neg[i:i + 2]), t(ts[i:i + 2]), t(valid[i:i + 2]), 0.0, exposure,
                                num_frames) for i in range(0, 6, 2))
    np.testing.assert_array_equal(n(tr.finalize_duration(parts)), n(jr.finalize_duration(jacc)))


@pytest.mark.parametrize("count", [1, 17, 60])
def test_count_equals_jax(count):
    """COUNT windows of 1, 17 and 60 events, more windows than the stream
    fills: frames and end times exact, the unfilled windows -inf."""
    pos, neg, ts, valid = dense_maps(1, quiet_frames=(0,))
    num_frames = 40
    (tfr, tend), (jfr, jend) = both("render_count", pos, neg, ts, valid, count, num_frames)
    np.testing.assert_array_equal(n(tfr), n(jfr))
    np.testing.assert_array_equal(n(tend), n(jend))
    if count == 60:
        assert np.isneginf(n(tend)).any()


@pytest.mark.parametrize("count,dim", [(3, 2), (5, 4), (2, 3)])
def test_area_count_equals_jax(count, dim):
    """AREA_COUNT on blocks of 2, 4 and 3 (10x13 padded to whole blocks):
    frames and end times exact, unfilled windows -inf."""
    pos, neg, ts, valid = dense_maps(2, density=0.05, quiet_frames=(4,))
    (tfr, tend), (jfr, jend) = both("render_area_count", pos, neg, ts, valid, count, dim, 32)
    np.testing.assert_array_equal(n(tfr), n(jfr))
    np.testing.assert_array_equal(n(tend), n(jend))
    assert np.isneginf(n(tend)).any() and np.isfinite(n(tend)).any()


def test_render_frames_dispatches_like_jax():
    pos, neg, ts, valid = dense_maps(3)
    kw = dict(pos=pos, neg=neg, ts=ts, iter_valid=valid, count=10, num_frames=8)
    jout = jr.render_frames(jr.ExposureMode.COUNT, **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                                      for k, v in kw.items()})
    tout = tr.render_frames(tr.ExposureMode.COUNT, **{k: t(v) if isinstance(v, np.ndarray) else v
                                                      for k, v in kw.items()})
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(n(a), n(b))
