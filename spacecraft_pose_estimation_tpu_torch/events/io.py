"""Event-stream IO: dense maps <-> sparse lists, CSV / AEDAT2 / HDF5.

Port of the JAX package's ``events/io.py``: the host-side edge of the
event subsystem, keeping the reference's file contracts:

* events CSV — rows ``t, x, y, p`` with t in seconds (v2e --dvs_text,
  DVSTextOutput; consumed by e2v.py:120-141, which collapses polarity to
  +1 and supports ms/us timestamp unit flags and swap_xy),
* AEDAT-2.0 — jAER binary: big-endian int32 (address, timestamp_us)
  pairs, DAVIS bit packing x<<12 | y<<22 | p<<11 with x/y flips
  (v2ecore/output/aedat2_output.py:19-178),
* HDF5 — `events` dataset of (N, 4) [t_us, x, y, p].
"""

from __future__ import annotations

import datetime
import getpass
import time as time_mod

import numpy as np
import torch

ACCUMULATE_BLOCK = 64  # exposure windows summed at once on a device
AEDAT2_SIZES = {(346, 260), (692, 520), (1280, 720), (640, 480), (240, 180), (346, 240)}


def dense_to_events(pos, neg, ts, iter_valid) -> np.ndarray:
    """Emulator dense output -> (N, 4) float64 [t, x, y, p(+-1)] sorted by time.

    Takes one frame's (I, H, W) maps or a sequence's (T, I, H, W), as
    tensors on any device or numpy arrays. The order is the JAX package's:
    the pos block before the neg block, each in row-major ``nonzero``
    order (iteration, y, x), then a stable sort on t, so equal timestamps
    keep pos before neg in scanline order. On a device the ``nonzero`` and
    the sort run there and only the sparse rows come to the host."""
    pos, neg, ts, valid = (torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
                           for a in (pos, neg, ts, iter_valid))
    h, w = pos.shape[-2:]
    vm = valid.reshape(-1).to(torch.bool)[:, None, None]
    p_idx, n_idx = (torch.nonzero(maps.reshape(-1, h, w) & vm) for maps in (pos, neg))
    idx = torch.cat([p_idx, n_idx])
    if idx.shape[0] == 0:
        return np.zeros((0, 4))
    t = ts.reshape(-1)[idx[:, 0]]
    order = torch.sort(t, stable=True).indices
    p = torch.where(order < p_idx.shape[0], 1, -1).to(torch.int8)
    yx = idx[order, 1:].to(torch.int32)
    t, yx, p = t[order].cpu().numpy(), yx.cpu().numpy(), p.cpu().numpy()
    return np.stack([t.astype(np.float64), yx[:, 1].astype(np.float64), yx[:, 0].astype(np.float64),
                     p.astype(np.float64)], axis=1)


def write_events_csv(events: np.ndarray, path: str, header: bool = False) -> None:
    """(N, 4) [t, x, y, p] -> CSV; polarity written as -1/1."""
    with open(path, "w") as f:
        if header:
            f.write("t,x,y,p\n")
        for t, x, y, p in events:
            f.write(f"{t:.9f},{int(x)},{int(y)},{int(p)}\n")


def read_events_csv(
    path: str,
    timestamp_unit: str = "s",
    swap_xy: bool = False,
    force_pos_polarity: bool = True,
    delim_whitespace: bool | None = None,
) -> np.ndarray:
    """CSV -> (N, 4) [t_seconds, x, y, p]. Mirrors e2v.py:120-141:
    ms/us unit conversion, optional xy swap, polarity collapsed to +1.

    ``delim_whitespace``: the reference's --delim_whitespace flag — the
    v2e DVSTextOutput contract is SPACE-separated (ae_text_output.py:75).
    Default None sniffs the first data line, so both file families read."""
    import pandas as pd

    if delim_whitespace is None:
        with open(path) as f:
            line = "#"
            while line.startswith("#"):
                line = f.readline()
                if not line:
                    break
        delim_whitespace = "," not in line
    df = pd.read_csv(
        path, header=None, comment="#",
        sep=r"\s+" if delim_whitespace else ",",
    )
    ev = df.values.astype(np.float64)[:, :4]
    scale = {"s": 1.0, "ms": 1e-3, "us": 1e-6}[timestamp_unit]
    ev[:, 0] *= scale
    if swap_xy:
        ev[:, [1, 2]] = ev[:, [2, 1]]
    if force_pos_polarity:
        ev[:, 3] = 1.0
    else:
        ev[:, 3] = np.where(ev[:, 3] > 0, 1.0, -1.0)
    return ev


class AEDat2Writer:
    """jAER AEDAT-2.0 binary writer (aedat2_output.py semantics)."""

    Y_SHIFT, X_SHIFT, POL_SHIFT = 22, 12, 11

    def __init__(self, path: str, width: int = 346, height: int = 260):
        if (width, height) not in AEDAT2_SIZES:
            raise ValueError(f"unsupported AEDAT2 size {width}x{height}")
        self.width, self.height = width, height
        self.f = open(path, "wb")
        self.num_written = 0
        self._write_header()

    def _write_header(self):
        now = datetime.datetime.now().strftime("# Creation time: %I:%M%p %B %d %Y\r\n")
        lines = [
            "#!AER-DAT2.0\r\n",
            "# This is a raw AE data file created by AEDat2Writer "
            "(spacecraft_pose_estimation_tpu_torch) per "
            "https://inivation.com/support/software/fileformat/#aedat-20\r\n",
            "# Data format is int32 address, int32 timestamp (8 bytes total), "
            "repeated for each event\r\n",
            "# Timestamps tick is 1 us\r\n",
            now,
            f"# Creation time: System.currentTimeMillis() {int(time_mod.time() * 1000)}\r\n",
            f"# User name: {getpass.getuser()}\r\n",
        ]
        for s in lines:
            self.f.write(s.encode("utf-8"))

    def append(self, events: np.ndarray) -> None:
        if len(events) == 0:
            return
        t = (1e6 * events[:, 0]).astype(np.int32)
        x = (self.width - 1) - events[:, 1].astype(np.int32)  # flipx
        y = (self.height - 1) - events[:, 2].astype(np.int32)  # flipy
        p = ((events[:, 3] + 1) / 2).astype(np.int32)
        addr = (x << self.X_SHIFT) | (y << self.Y_SHIFT) | (p << self.POL_SHIFT)
        out = np.empty(2 * len(events), np.int32)
        out[0::2] = addr
        out[1::2] = t
        data = out.byteswap().tobytes()
        if self.num_written == 0:
            while data[0:1] == b"#":
                data = data[8:]
        self.f.write(data)
        self.num_written += len(events)

    def close(self):
        self.f.close()


def read_aedat2(path: str, width: int = 346, height: int = 260) -> np.ndarray:
    """Inverse of AEDat2Writer, and reader for real jAER DAVIS
    recordings: keeps only polarity events — bit 31 set marks an APS
    sample, bit 10 a special/external event (aedat2_output.py:33-38);
    both interleave with DVS events in real .aedat files."""
    with open(path, "rb") as f:
        raw = f.read()
    offset = 0
    while raw[offset : offset + 1] == b"#":
        offset = raw.index(b"\n", offset) + 1
    data = np.frombuffer(raw[offset:], dtype=">i4").astype(np.int64)
    addr = data[0::2]
    ts_us = data[1::2]
    if height <= 512:
        # >512-row geometries legitimately spill y into bit 31 (the
        # reference writer shares this quirk), so only small-geometry
        # reads can disambiguate APS/special words
        dvs = ((addr >> 31) & 1 == 0) & ((addr >> 10) & 1 == 0)
        addr, ts_us = addr[dvs], ts_us[dvs]
    t = ts_us / 1e6
    x = (width - 1) - ((addr >> AEDat2Writer.X_SHIFT) & 0x3FF)
    y = (height - 1) - ((addr >> AEDat2Writer.Y_SHIFT) & 0x1FF)
    p = 2 * ((addr >> AEDat2Writer.POL_SHIFT) & 1) - 1
    return np.stack([t, x, y, p], axis=1).astype(np.float64)


def write_events_h5(events: np.ndarray, path: str) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        ev = events.copy()
        ev[:, 0] *= 1e6  # us, matching v2e h5 convention
        f.create_dataset("events", data=ev.astype(np.int64), compression="gzip")


def read_events_h5(path: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        ev = f["events"][...].astype(np.float64)
    ev[:, 0] /= 1e6
    return ev


def accumulate_exposure_frames(
    events: np.ndarray,
    width: int,
    height: int,
    exposure: float,
    full_scale_count: int = 3,
    device="cpu",
):
    """Shared duration-exposure accumulation core of e2v.py:54-71 and
    convert_aedats.py: yields (frame01 (H, W) float64 tensor on ``device``
    in [0, 1], end_time_seconds) per frame. One pass over the time-sorted
    events, frame boundaries from a searchsorted on the bin edges; the sums
    run on ``device``, ACCUMULATE_BLOCK frames at a time (``index_put_``
    with accumulation, float64: sums of +-1 are exact in any order, so the
    frames equal the JAX package's ``np.add.at``)."""
    if len(events) == 0:
        return
    t0 = float(events[0, 0])
    bins = np.floor((events[:, 0] - t0) / exposure).astype(np.int64)
    num_frames = int(bins.max()) + 1
    # events are time-sorted, so bins is non-decreasing
    edges = np.searchsorted(bins, np.arange(num_frames + 1))
    inv_scale = 1.0 / float(full_scale_count * 2)
    for b0 in range(0, num_frames, ACCUMULATE_BLOCK):
        nb = min(ACCUMULATE_BLOCK, num_frames - b0)
        sel = slice(edges[b0], edges[b0 + nb])
        idx = (torch.from_numpy(bins[sel] - b0),
               torch.from_numpy(events[sel, 2].astype(np.int64).clip(0, height - 1)),
               torch.from_numpy(events[sel, 1].astype(np.int64).clip(0, width - 1)))
        acc = torch.zeros((nb, height, width), dtype=torch.float64, device=device)
        acc.index_put_(tuple(i.to(device) for i in idx), torch.from_numpy(events[sel, 3].copy()).to(device),
                       accumulate=True)
        frames = (torch.clamp(acc, -full_scale_count, full_scale_count) + full_scale_count) * inv_scale
        for k in range(nb):
            yield frames[k], t0 + (b0 + k + 1) * exposure
