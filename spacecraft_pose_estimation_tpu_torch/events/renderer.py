"""Events -> frames: the emulator's dense maps integrated into exposure windows.

Port of the JAX package's ``events/renderer.py`` (v2e's EventRenderer,
renderer.py:19-387):

* DURATION: each sub-interval's timestamp picks an exposure window; a
  window sums its (pos - neg) maps (``index_add_``), clipped to
  +-full_scale_count and normalised around grey 0.5;
* COUNT: a window closes every ``count`` events, from the cumulative
  per-iteration totals;
* AREA_COUNT: a window closes when any KxK block reaches ``count``
  events, a sequential scan over the iterations that stays on the device.

A window's end time is the largest timestamp it took
(``scatter_reduce("amax")`` into ``-inf``); an empty window stays ``-inf``,
and v2e drops it by ``isfinite``.
"""

from __future__ import annotations

import enum

import torch

Tensor = torch.Tensor


class ExposureMode(enum.Enum):
    DURATION = "duration"
    COUNT = "count"
    AREA_COUNT = "area_count"


def normalize_frame(acc: Tensor, full_scale_count: int, reciprocal: bool = False) -> Tensor:
    """``(acc + c) / 2c``. ``reciprocal``: times float32(1 / 2c) instead,
    as XLA rounds it inside the JAX package's jitted COUNT and AREA_COUNT
    renderers (the eager ``finalize_duration`` divides)."""
    scale = float(full_scale_count * 2)
    if reciprocal:
        return (acc + full_scale_count) * torch.full((), 1.0 / scale, device=acc.device)
    return (acc + full_scale_count) / torch.full((), scale, device=acc.device)


def _flatten_iters(pos, neg, ts, iter_valid):
    """(T, I, H, W) maps -> time-ordered (T*I, ...) with validity."""
    t, i = ts.shape
    pos, neg = pos.to(torch.int32), neg.to(torch.int32)
    delta = (pos - neg).reshape(t * i, *pos.shape[2:])
    counts = (pos + neg).reshape(t * i, *pos.shape[2:])
    return delta, counts, ts.reshape(-1), iter_valid.reshape(-1)


def _segment_sum(values: Tensor, bins: Tensor, num_frames: int) -> Tensor:
    out = values.new_zeros((num_frames + 1, *values.shape[1:]))
    return out.index_add_(0, bins, values)[:num_frames]


def _segment_max_times(tflat: Tensor, valid: Tensor, bins: Tensor, num_frames: int) -> Tensor:
    vals = torch.where(valid, tflat, torch.full_like(tflat, -float("inf")))
    out = torch.full((num_frames + 1,), -float("inf"), dtype=tflat.dtype, device=tflat.device)
    return out.scatter_reduce(0, bins, vals, "amax", include_self=False)[:num_frames]


def duration_acc(pos: Tensor, neg: Tensor, ts: Tensor, iter_valid: Tensor, t_start, exposure_s: float,
                 num_frames: int) -> Tensor:
    """Raw per-window (pos - neg) sums, (num_frames, H, W) int32.

    Additive over stream chunks that share (t_start, exposure_s,
    num_frames): summing the chunks' sums, then clipping and normalising,
    equals one pass over the whole stream."""
    delta, _, tflat, valid = _flatten_iters(pos, neg, ts, iter_valid)
    t_start = torch.as_tensor(t_start, dtype=torch.float32).to(tflat.device)
    bins = torch.floor((tflat - t_start) / torch.full_like(tflat, exposure_s)).to(torch.int64)
    bins = torch.where(valid, torch.clamp(bins, 0, num_frames - 1), num_frames)  # invalid -> overflow bin
    return _segment_sum(delta * valid[:, None, None], bins, num_frames)


def finalize_duration(acc: Tensor, full_scale_count: int = 3, reciprocal: bool = False) -> Tensor:
    """Clip and grey-normalise a (summed) duration accumulator."""
    return normalize_frame(torch.clamp(acc, -full_scale_count, full_scale_count), full_scale_count, reciprocal)


def render_duration(pos, neg, ts, iter_valid, t_start, exposure_s: float, num_frames: int,
                    full_scale_count: int = 3) -> Tensor:
    """DURATION exposure: (num_frames, H, W) in [0, 1]."""
    return finalize_duration(duration_acc(pos, neg, ts, iter_valid, t_start, exposure_s, num_frames),
                             full_scale_count, reciprocal=True)


def render_count(pos, neg, ts, iter_valid, count: int, num_frames: int,
                 full_scale_count: int = 3) -> tuple[Tensor, Tensor]:
    """COUNT exposure: a frame closes every ``count`` events. Returns
    (frames (num_frames, H, W), frame_end_times (num_frames,))."""
    delta, counts, tflat, valid = _flatten_iters(pos, neg, ts, iter_valid)
    ev_per_iter = (counts * valid[:, None, None]).sum((1, 2))
    cum = torch.cumsum(ev_per_iter, 0)
    bins = torch.clamp((cum - 1) // count, 0, num_frames - 1)  # floors: cum = 0 -> -1 -> 0
    bins = torch.where(valid, bins, num_frames)
    acc = torch.clamp(_segment_sum(delta * valid[:, None, None], bins, num_frames),
                      -full_scale_count, full_scale_count)
    end_times = _segment_max_times(tflat, valid, bins, num_frames)
    return normalize_frame(acc, full_scale_count, reciprocal=True), end_times


def render_area_count(pos, neg, ts, iter_valid, area_count: int, area_dimension: int, num_frames: int,
                      full_scale_count: int = 3) -> tuple[Tensor, Tensor]:
    """AREA_COUNT exposure: a frame closes when any area_dimension^2 block
    reaches ``area_count`` events (renderer.py:252-266), evaluated at
    sub-iteration granularity."""
    delta, counts, tflat, valid = _flatten_iters(pos, neg, ts, iter_valid)
    n, h, w = delta.shape
    ph, pw = -h % area_dimension, -w % area_dimension
    cpad = torch.nn.functional.pad(counts, (0, pw, 0, ph))
    blocks = cpad.reshape(n, (h + ph) // area_dimension, area_dimension,
                          (w + pw) // area_dimension, area_dimension).sum((2, 4))
    blocks = blocks * valid[:, None, None]
    # the scan, on the device: no step reads a value back to the host
    acc_blocks = torch.zeros_like(blocks[0])
    frame_idx = torch.zeros((), dtype=torch.int64, device=delta.device)
    bins = torch.empty(n, dtype=torch.int64, device=delta.device)
    for k in range(n):
        acc_blocks = acc_blocks + blocks[k]
        close = (acc_blocks >= area_count).any()
        acc_blocks = torch.where(close, torch.zeros_like(acc_blocks), acc_blocks)
        bins[k] = frame_idx
        frame_idx = frame_idx + close.to(torch.int64)
    bins = torch.where(valid, torch.clamp(bins, 0, num_frames - 1), num_frames)
    acc = torch.clamp(_segment_sum(delta * valid[:, None, None], bins, num_frames),
                      -full_scale_count, full_scale_count)
    end_times = _segment_max_times(tflat, valid, bins, num_frames)
    return normalize_frame(acc, full_scale_count, reciprocal=True), end_times


def render_frames(mode: ExposureMode, **kwargs):
    if mode == ExposureMode.DURATION:
        return render_duration(**kwargs)
    if mode == ExposureMode.COUNT:
        return render_count(**kwargs)
    return render_area_count(**kwargs)
