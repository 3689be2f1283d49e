"""DVS pixel-model event emulator: one frame step at a time, on tensors.

Port of the JAX package's ``events/emulator.py`` (v2e's EventEmulator,
v2e/v2ecore/emulator.py:225-612): the lin-log mapping snapped to a 2^-21
grid, per-pixel Gaussian-mismatch thresholds, the intensity-dependent IIR
low-pass, leak events, Poisson shot noise, refractory filtering and the
base frame moved only by emitted events. As in JAX the per-frame loop runs
to a static ``max_iters`` with masked iterations, and the events stay
dense: (max_iters, H, W) bool maps per frame. ``events/io.py`` makes the
sparse (t, x, y, p) lists.

The random draws are arguments. ``init_state`` takes ``draws={"pos",
"neg", "noise"}`` (standard normals of the frame's shape) and
``emulate_frame`` ``draws={"leak": (H, W) normal, "shot": (max_iters, H,
W) uniform}``, which is how the tests hand the port the JAX package's
draws. Without them the port draws from a ``torch.Generator`` on the
state's device seeded per (seed, frame index), so a chunked run equals one
run over the whole stream.

Float32 throughout. Where JAX divides by a Python number the port divides
by a tensor (:func:`_div`): PyTorch turns ``scalar / tensor``, and on CUDA
``tensor / scalar``, into a multiplication by a reciprocal, which rounds
differently.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EmulatorConfig:
    pos_thres: float = 0.2
    neg_thres: float = 0.2
    sigma_thres: float = 0.03
    cutoff_hz: float = 0.0
    leak_rate_hz: float = 0.0
    leak_jitter_fraction: float = 0.1
    noise_rate_cov_decades: float = 0.1
    shot_noise_rate_hz: float = 0.0
    shot_noise_inten_factor: float = 0.25
    refractory_period_s: float = 0.0
    max_iters: int = 8  # static cap for per-frame event iterations

    @classmethod
    def preset(cls, model: str) -> "EmulatorConfig":
        """set_dvs_params presets (emulator.py:289-310)."""
        if model == "clean":
            return cls(pos_thres=0.2, neg_thres=0.2, sigma_thres=0.02)
        if model == "noisy":
            return cls(
                pos_thres=0.2, neg_thres=0.2, sigma_thres=0.05, cutoff_hz=30.0,
                leak_rate_hz=0.1, shot_noise_rate_hz=5.0, refractory_period_s=0.01,
            )
        raise ValueError(model)


@dataclasses.dataclass
class EmulatorState:
    base_log: Tensor  # memorized lin-log brightness
    lp0: Tensor  # IIR stage 0
    lp1: Tensor  # IIR stage 1 (output)
    pos_thres: Tensor
    neg_thres: Tensor
    pos_pre_prob: Tensor
    neg_pre_prob: Tensor
    noise_rate: Tensor
    timestamp_mem: Tensor
    t_previous: Tensor  # () float32
    seed: int = 0
    frame_index: int = 0  # frames emulated so far: the next frame's generator


def _div(a: Tensor, b: float) -> Tensor:
    """``a / b`` rounded as a true float32 division on every device."""
    return a / a.new_full((), b)


def _rdiv(a: float, b: Tensor) -> Tensor:
    """``a / b`` for a Python ``a``, rounded as a true division."""
    return b.new_full((), a) / b


def lin_log(x: Tensor, threshold: float = 20.0) -> Tensor:
    """Linear below threshold, log above, snapped to the 2^-21 grid (the
    JAX package's ``lin_log``: equal intensities give bit-identical
    values; ``torch.round`` rounds half to even, as ``jnp.round``)."""
    f = (1.0 / threshold) * math.log(threshold)
    y = torch.where(x <= threshold, x * f, torch.log(torch.clamp(x, min=1e-6)))
    rounding = float(2 ** 21)
    return torch.round(y * rounding) / rounding


def rescale_intensity(frame: Tensor) -> Tensor:
    return _div(frame + 20.0, 275.0)


def frame_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of frame ``index`` of a stream seeded ``seed``
    (index -1: ``init_state``'s)."""
    s = int(np.random.SeedSequence([seed, index + 1]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


def init_state(first_frame: Tensor, cfg: EmulatorConfig, seed: int = 0, draws: dict | None = None) -> EmulatorState:
    """The state before the stream: base, IIR stages at the first frame's
    lin-log, thresholds ``max(nominal + sigma * pos/neg, 0.01)`` and the
    noise rates ``10 ** (cov * noise)`` from ``draws`` (standard normals)
    or from the stream's own generator."""
    frame = first_frame.to(torch.float32)
    shape, dev = frame.shape, frame.device
    if draws is None:
        gen = frame_generator(seed, -1, dev)
        draws = {k: torch.randn(shape, generator=gen, device=dev) for k in ("pos", "neg", "noise")}
    base = lin_log(frame)
    if cfg.sigma_thres > 0:
        pos = torch.clamp(cfg.pos_thres + cfg.sigma_thres * draws["pos"].to(dev, torch.float32), min=0.01)
        neg = torch.clamp(cfg.neg_thres + cfg.sigma_thres * draws["neg"].to(dev, torch.float32), min=0.01)
    else:
        pos = torch.full(shape, cfg.pos_thres, device=dev)
        neg = torch.full(shape, cfg.neg_thres, device=dev)
    noise_rate = torch.exp(math.log(10.0) * cfg.noise_rate_cov_decades * draws["noise"].to(dev, torch.float32))
    return EmulatorState(
        base_log=base, lp0=base, lp1=base, pos_thres=pos, neg_thres=neg,
        pos_pre_prob=_rdiv(cfg.pos_thres, pos), neg_pre_prob=_rdiv(cfg.neg_thres, neg),
        noise_rate=noise_rate, timestamp_mem=torch.full(shape, -cfg.refractory_period_s, device=dev),
        t_previous=torch.zeros((), device=dev), seed=seed, frame_index=0,
    )


def frame_draws(state: EmulatorState, cfg: EmulatorConfig) -> dict:
    """One frame's draws from its own generator: only those its noise terms use."""
    dev, shape = state.base_log.device, state.base_log.shape
    gen = frame_generator(state.seed, state.frame_index, dev)
    out = {}
    if cfg.leak_rate_hz > 0:
        out["leak"] = torch.randn(shape, generator=gen, device=dev)
    if cfg.shot_noise_rate_hz > 0:
        out["shot"] = torch.rand((cfg.max_iters, *shape), generator=gen, device=dev)
    return out


def emulate_frame(state: EmulatorState, new_frame: Tensor, t_frame, cfg: EmulatorConfig,
                  draws: dict | None = None) -> tuple[EmulatorState, dict]:
    """One DVS frame step. Returns the new state and the dense maps:

    ``pos`` / ``neg`` (max_iters, H, W) bool: an event fired at that pixel
    in that sub-interval; ``ts`` (max_iters,) timestamps; ``iter_valid``
    (max_iters,): the iterations below ``num_iters``; ``num_events`` and
    ``overflow`` () int tensors. Nothing here waits for the device.
    """
    dev = state.base_log.device
    if draws is None:
        draws = frame_draws(state, cfg)
    new_frame = new_frame.to(dev, torch.float32)
    t_frame = torch.as_tensor(t_frame, dtype=torch.float32).to(dev)
    log_new = lin_log(new_frame)
    dt = t_frame - state.t_previous
    inten01 = rescale_intensity(new_frame)

    # IIR low-pass (1st order; stage 1's output lags one step, per reference)
    if cfg.cutoff_hz > 0:
        tau = 1.0 / (math.pi * 2 * cfg.cutoff_hz)
        eps = torch.clamp(inten01 * _div(dt, tau), max=1.0)
        lp0 = (1 - eps) * state.lp0 + eps * log_new
        lp1 = state.lp0
    else:
        lp0 = log_new
        lp1 = log_new

    base = state.base_log
    if cfg.leak_rate_hz > 0:
        rand = draws["leak"].to(dev, torch.float32)
        leak_rate = cfg.leak_rate_hz * state.noise_rate * (1 - cfg.leak_jitter_fraction * rand)
        base = base - dt * leak_rate * state.pos_thres

    diff = lp1 - base
    pos_counts_raw = torch.floor(torch.clamp(diff, min=0.0) / state.pos_thres).to(torch.int32)
    neg_counts_raw = torch.floor(torch.clamp(-diff, min=0.0) / state.neg_thres).to(torch.int32)
    pos_counts = torch.clamp(pos_counts_raw, max=cfg.max_iters)
    neg_counts = torch.clamp(neg_counts_raw, max=cfg.max_iters)
    # events clipped by the static cap: not lost, the base frame moves only by
    # emitted events, so the residual fires again on the next frame
    overflow = (pos_counts_raw - pos_counts).sum() + (neg_counts_raw - neg_counts).sum()
    # num_iters may be 0: then the frame emits nothing, shot noise included
    num_iters = torch.maximum(pos_counts.max(), neg_counts.max())
    num_iters_div = torch.clamp(num_iters, min=1)

    ts_step = dt / num_iters_div
    iters = torch.arange(cfg.max_iters, device=dev)
    ts = state.t_previous + ts_step * (iters + 1)
    iter_valid = iters < num_iters

    shape = (cfg.max_iters, *base.shape)
    if cfg.shot_noise_rate_hz > 0:
        factor = (cfg.shot_noise_rate_hz / 2) * dt / num_iters_div
        factor = factor * ((cfg.shot_noise_inten_factor - 1) * inten01 + 1)
        rand01 = draws["shot"].to(dev, torch.float32)
        shot_on = rand01 > (1 - factor * state.pos_pre_prob)[None]
        shot_off = rand01 < (factor * state.neg_pre_prob)[None]
    else:
        shot_on = shot_off = None

    level = (iters + 1).view(-1, 1, 1)
    if cfg.refractory_period_s <= 0:
        # no carried dependence between iterations: all at once
        pos_maps = (pos_counts[None] >= level) & iter_valid.view(-1, 1, 1)
        neg_maps = (neg_counts[None] >= level) & iter_valid.view(-1, 1, 1)
        if shot_on is not None:
            pos_maps = pos_maps | (shot_on & iter_valid.view(-1, 1, 1))
            neg_maps = neg_maps | (shot_off & iter_valid.view(-1, 1, 1))
        ts_mem = state.timestamp_mem
    else:
        pos_maps = torch.empty(shape, dtype=torch.bool, device=dev)
        neg_maps = torch.empty(shape, dtype=torch.bool, device=dev)
        ts_mem = state.timestamp_mem
        # only filter when the refractory period exceeds the step
        use_filter = cfg.refractory_period_s > ts_step
        for i in range(cfg.max_iters):
            active = iter_valid[i]
            pos_cord = pos_counts >= i + 1
            neg_cord = neg_counts >= i + 1
            if shot_on is not None:
                pos_cord = pos_cord | shot_on[i]
                neg_cord = neg_cord | shot_off[i]
            pos_cord = pos_cord & active
            neg_cord = neg_cord & active
            t_i = ts[i]
            pos_f = torch.where(use_filter, (pos_cord * t_i - ts_mem) > cfg.refractory_period_s, pos_cord)
            neg_f = torch.where(use_filter, (neg_cord * t_i - ts_mem) > cfg.refractory_period_s, neg_cord)
            pos_cord, neg_cord = pos_f & pos_cord, neg_f & neg_cord
            ts_mem = torch.where(pos_cord | neg_cord, t_i, ts_mem)
            pos_maps[i], neg_maps[i] = pos_cord, neg_cord
    final_pos = pos_maps.sum(0, dtype=torch.int32)
    final_neg = neg_maps.sum(0, dtype=torch.int32)

    # the base frame moves only by emitted events (emulator.py:606-609)
    base = base + final_pos * state.pos_thres - final_neg * state.neg_thres

    new_state = dataclasses.replace(state, base_log=base, lp0=lp0, lp1=lp1, timestamp_mem=ts_mem,
                                    t_previous=t_frame, frame_index=state.frame_index + 1)
    out = {
        "pos": pos_maps, "neg": neg_maps, "ts": ts, "iter_valid": iter_valid,
        "num_events": final_pos.sum() + final_neg.sum(), "overflow": overflow,
    }
    return new_state, out


def emulate_sequence(state: EmulatorState, frames: Tensor, timestamps, cfg: EmulatorConfig,
                     draws: dict | None = None) -> tuple[EmulatorState, dict]:
    """:func:`emulate_frame` over (T, H, W) frames; the outputs gain a
    leading T axis: pos/neg (T, max_iters, H, W), ts (T, max_iters).
    ``draws``, when given, holds each frame's draws stacked on a leading T
    axis."""
    dev = state.base_log.device
    frames = torch.as_tensor(frames).to(dev)
    timestamps = torch.as_tensor(timestamps, dtype=torch.float32).to(dev)
    outs = []
    for i in range(frames.shape[0]):
        fd = None if draws is None else {k: v[i] for k, v in draws.items()}
        state, out = emulate_frame(state, frames[i], timestamps[i], cfg, fd)
        outs.append(out)
    if not outs:
        raise ValueError("emulate_sequence needs at least one frame")
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
