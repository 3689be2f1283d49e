"""Threshold estimation: bisect the nominal pos/neg threshold so the
emulated event count matches a real recording's.

Port of the JAX package's ``events/thres_estimator.py``
(v2e/v2ecore/thres_estimator.py:18-149) on the port's emulator: each probe
re-runs the emulator over the frames from the same seed (or draws).
"""

from __future__ import annotations

import dataclasses

import torch

from .emulator import EmulatorConfig, emulate_sequence, init_state


def count_events(frames, timestamps, threshold: float, base_cfg: EmulatorConfig, seed: int = 0,
                 draws: dict | None = None) -> int:
    """Events the emulator emits over ``frames[1:]`` at ``threshold``;
    ``draws``: {"init": init_state's, "frames": emulate_sequence's}."""
    cfg = dataclasses.replace(base_cfg, pos_thres=float(threshold), neg_thres=float(threshold))
    frames = torch.as_tensor(frames)
    draws = draws or {}
    state = init_state(frames[0], cfg, seed=seed, draws=draws.get("init"))
    _, out = emulate_sequence(state, frames[1:], torch.as_tensor(timestamps)[1:], cfg, draws.get("frames"))
    return int(out["num_events"].sum())


def estimate_threshold(frames, timestamps, target_count: int, base_cfg: EmulatorConfig = EmulatorConfig(),
                       lo: float = 0.02, hi: float = 1.0, steps: int = 12, seed: int = 0,
                       draws: dict | None = None) -> float:
    """Bisect the nominal threshold so the event count matches the target
    (the count falls as the threshold rises)."""
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        c = count_events(frames, timestamps, mid, base_cfg, seed, draws)
        if c > target_count:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
