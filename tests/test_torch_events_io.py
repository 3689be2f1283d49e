"""The port's event readers and writers against the JAX package's: what one
package writes the other reads back exactly (CSV, AEDAT2, HDF5, AEDAT4
with NONE / LZ4 / ZSTD packets, DDD20), ``dense_to_events`` gives the same
events in the same order, and the accumulated exposure frames and the
synthetic sources are equal. The port's LZ4 codec is built from
``native/lz4.cpp`` with ``g++`` at first use."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.events import aedat4 as jaedat4
from spacecraft_pose_estimation_tpu.events import ddd20 as jddd20
from spacecraft_pose_estimation_tpu.events import io as jio
from spacecraft_pose_estimation_tpu.events import synthetic_input as jsyn
from spacecraft_pose_estimation_tpu_torch.events import aedat4 as taedat4
from spacecraft_pose_estimation_tpu_torch.events import ddd20 as tddd20
from spacecraft_pose_estimation_tpu_torch.events import io as tio
from spacecraft_pose_estimation_tpu_torch.events import synthetic_input as tsyn
from torch_port_util import few_threads, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def random_events(seed: int, num: int = 3000, width: int = 346, height: int = 260) -> np.ndarray:
    """Time-sorted (N, 4) [t s, x, y, p +-1], timestamps on the microsecond grid."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 400_000, num)) / 1e6
    return np.stack([ts, rng.integers(0, width, num), rng.integers(0, height, num),
                     rng.choice([-1.0, 1.0], num)], axis=1).astype(np.float64)


@pytest.mark.parametrize("layout", ["sequence", "frame"])
def test_dense_to_events_order_equals_jax(layout):
    """The same (N, 4) events in the same order from numpy arrays and from
    tensors: pos before neg, scanline order, a stable sort on t (frames
    whose timestamps repeat across iterations included)."""
    rng = np.random.default_rng(0)
    shape = (3, 4, 9, 11) if layout == "sequence" else (5, 9, 11)
    pos = rng.random(shape) < 0.2
    neg = (rng.random(shape) < 0.2) & ~pos
    ts = np.sort(rng.integers(0, 6, shape[:-2]).astype(np.float32).reshape(-1)).reshape(shape[:-2]) * 0.01
    valid = rng.random(shape[:-2]) < 0.8
    want = jio.dense_to_events(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(ts), jnp.asarray(valid))
    for args in ((pos, neg, ts, valid), tuple(t(a) for a in (pos, neg, ts, valid))):
        got = tio.dense_to_events(*args)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    empty = np.zeros_like(pos)
    assert tio.dense_to_events(t(empty), t(empty), t(ts), t(valid)).shape == (0, 4)


def test_csv_both_ways(tmp_path):
    ev = random_events(1)
    tio.write_events_csv(ev, tmp_path / "port.csv")
    jio.write_events_csv(ev, tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    tio.write_events_csv(ev[:3], tmp_path / "h.csv", header=True)
    jio.write_events_csv(ev[:3], tmp_path / "hj.csv", header=True)
    assert (tmp_path / "h.csv").read_text() == (tmp_path / "hj.csv").read_text()
    for path in ("port.csv", "jax.csv"):
        for kw in (dict(), dict(force_pos_polarity=False), dict(timestamp_unit="ms", swap_xy=True)):
            np.testing.assert_array_equal(tio.read_events_csv(str(tmp_path / path), **kw),
                                          jio.read_events_csv(str(tmp_path / path), **kw))
    # the v2e text contract: space-separated, sniffed
    (tmp_path / "space.txt").write_text("# comment\n0.5 3 4 1\n0.6 5 6 0\n")
    np.testing.assert_array_equal(tio.read_events_csv(str(tmp_path / "space.txt"), force_pos_polarity=False),
                                  jio.read_events_csv(str(tmp_path / "space.txt"), force_pos_polarity=False))


@pytest.mark.parametrize("size", [(346, 260), (1280, 720)])
def test_aedat2_both_ways(tmp_path, size):
    """Both writers write the same event words (the headers differ in the
    creation time and the writer's name); each reader reads either file as
    the other does (timestamps truncated to whole microseconds, as
    jAER's writer truncates them)."""
    ev = random_events(2, width=size[0], height=size[1])
    for writer, name in ((tio.AEDat2Writer, "p"), (jio.AEDat2Writer, "j")):
        w = writer(str(tmp_path / f"{name}.aedat"), *size)
        w.append(ev[:1000])
        w.append(ev[1000:])
        w.close()
    words = [(tmp_path / f"{name}.aedat").read_bytes()[-8 * len(ev):] for name in ("p", "j")]
    assert words[0] == words[1]
    want = jio.read_aedat2(str(tmp_path / "j.aedat"), *size)
    assert np.abs(want[:, 0] - ev[:, 0]).max() < 1.5e-6
    if size[1] <= 512:  # taller geometries spill y past the 9-bit field, in both packages
        assert (want[:, 1:] == ev[:, 1:]).all()
    for name in ("p", "j"):
        np.testing.assert_array_equal(tio.read_aedat2(str(tmp_path / f"{name}.aedat"), *size), want)
        np.testing.assert_array_equal(jio.read_aedat2(str(tmp_path / f"{name}.aedat"), *size), want)
    with pytest.raises(ValueError):
        tio.AEDat2Writer(str(tmp_path / "bad.aedat"), 100, 100)


def test_hdf5_both_ways(tmp_path):
    pytest.importorskip("h5py")
    ev = random_events(3)
    tio.write_events_h5(ev, str(tmp_path / "p.h5"))
    jio.write_events_h5(ev, str(tmp_path / "j.h5"))
    want = jio.read_events_h5(str(tmp_path / "j.h5"))
    for path in ("p.h5", "j.h5"):
        np.testing.assert_array_equal(jio.read_events_h5(str(tmp_path / path)), want)
        np.testing.assert_array_equal(tio.read_events_h5(str(tmp_path / path)), want)


@pytest.mark.parametrize("exposure,fsc", [(0.01, 3), (0.033, 2)])
def test_accumulate_exposure_frames_equals_jax(exposure, fsc):
    ev = random_events(4, num=5000, width=64, height=48)
    ev[:, 1] = np.minimum(ev[:, 1], 70)  # some x beyond the width: clipped
    got = list(tio.accumulate_exposure_frames(ev, 64, 48, exposure, fsc))
    want = list(jio.accumulate_exposure_frames(ev, 64, 48, exposure, fsc))
    assert len(got) == len(want) > 10
    for (g, gt), (w, wt) in zip(got, want):
        assert g.dtype == torch.float64 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
        assert gt == wt
    assert list(tio.accumulate_exposure_frames(np.zeros((0, 4)), 8, 8, 0.01)) == []


@pytest.mark.parametrize("compression", ["NONE", "LZ4", "ZSTD"])
def test_aedat4_both_ways(tmp_path, compression):
    """AEDAT4 from the JAX writer read by the port, and the port's writer
    read by JAX, each with packets of 700 events."""
    pytest.importorskip("flatbuffers")
    if compression == "ZSTD":
        pytest.importorskip("zstandard")
    code = getattr(jaedat4, f"COMPRESSION_{compression}")
    ev = random_events(5, num=2500)
    jaedat4.write_aedat4(str(tmp_path / "j.aedat4"), ev, compression=code, packet_size=700)
    taedat4.write_aedat4(str(tmp_path / "p.aedat4"), ev, compression=code, packet_size=700)
    want = jaedat4.read_aedat4(str(tmp_path / "j.aedat4"))
    assert want.shape == (2500, 4)
    np.testing.assert_array_equal(taedat4.read_aedat4(str(tmp_path / "j.aedat4")), want)
    np.testing.assert_array_equal(jaedat4.read_aedat4(str(tmp_path / "p.aedat4")), want)
    assert (tmp_path / "p.aedat4").read_bytes()[14:] == (tmp_path / "j.aedat4").read_bytes()[14:]


def test_lz4_codec_is_built_from_the_repo_source_and_matches():
    """The port builds ``native/lz4.cpp`` into its own ``_build/`` (not the
    committed ``native/libspelz4.so``) and round-trips what the JAX codec
    compresses, and the reverse."""
    path = taedat4.build_lz4()
    assert path.parent.name == "_build" and path.name.startswith("spelz4-")
    data = np.random.default_rng(6).integers(0, 4, 200_000).astype(np.uint8).tobytes() + b"x" * 70_000
    assert taedat4.lz4_frame_decompress(jaedat4.lz4_frame_compress(data)) == data
    assert jaedat4.lz4_frame_decompress(taedat4.lz4_frame_compress(data)) == data
    assert taedat4.lz4_frame_compress(data) == jaedat4.lz4_frame_compress(data)


def test_ddd20_both_ways(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(7)
    num = 3000
    ev = np.stack([np.sort(rng.integers(0, 10**6, num)), rng.integers(0, 346, num), rng.integers(0, 260, num),
                   rng.integers(0, 2, num)], axis=1).astype(np.int64)
    frames = [(0.01 * i, rng.integers(0, 2**16, (260, 346)).astype(np.uint16)) for i in range(2)]
    jddd20.write_ddd20(str(tmp_path / "j.h5"), ev, frames, packet_size=1000)
    tddd20.write_ddd20(str(tmp_path / "p.h5"), ev, frames, packet_size=1000)
    for path in ("j.h5", "p.h5"):
        for rotate in (True, False):
            jr, tr = jddd20.DDD20Reader(str(tmp_path / path), rotate), tddd20.DDD20Reader(str(tmp_path / path), rotate)
            np.testing.assert_array_equal(tr.events(), jr.events())
            for (ta, fa), (tb, fb) in zip(tr.frames(), jr.frames()):
                assert ta == tb
                np.testing.assert_array_equal(fa, fb)
            jr.close()
            tr.close()
    np.testing.assert_array_equal(tddd20.DDD20Reader(str(tmp_path / "j.h5")).events(), ev)


@pytest.mark.parametrize("source", ["MovingDot", "MovingBar", "ParticleField"])
def test_synthetic_inputs_equal_jax(source):
    kw = dict(width=40, height=30, num_frames=12)
    jf, jt = getattr(jsyn, source)(**kw).frames_array()
    tf, tt = getattr(tsyn, source)(**kw).frames_array()
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tt, jt)
    assert issubclass(getattr(tsyn, source), tsyn.SyntheticInput)
    assert torch.as_tensor(tf).dtype == torch.float32
