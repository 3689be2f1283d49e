"""Synthetic frame sources for the event simulator.

A copy of the JAX package's numpy-only ``events/synthetic_input.py``.

Equivalent of v2e's synthetic-input plugin path
(v2ecore/base_synthetic_input.py + the --synthetic_input CLI hook,
v2e.py:122-160): a source yields (frame, time) pairs that feed the
emulator directly instead of video files. `MovingDot` is the bundled
example source; users subclass `SyntheticInput`.
"""

from __future__ import annotations

import numpy as np


class SyntheticInput:
    """Base class: iterate (frame float32 [0,255] (H, W), t_seconds)."""

    def __init__(self, width: int, height: int, frame_rate: float = 100.0):
        self.width = width
        self.height = height
        self.frame_rate = frame_rate

    def total_frames(self) -> int:
        raise NotImplementedError

    def frame(self, i: int) -> np.ndarray:
        raise NotImplementedError

    def __iter__(self):
        for i in range(self.total_frames()):
            yield self.frame(i), i / self.frame_rate

    def frames_array(self):
        """(T, H, W) frames + (T,) timestamps, ready for emulate_sequence."""
        frames = np.stack([self.frame(i) for i in range(self.total_frames())])
        ts = np.arange(self.total_frames()) / self.frame_rate
        return frames.astype(np.float32), ts.astype(np.float32)


class MovingDot(SyntheticInput):
    """A bright dot orbiting the frame center — deterministic event rates
    for emulator validation (the moving-dot example of v2e)."""

    def __init__(self, width=64, height=64, frame_rate=200.0, num_frames=100,
                 radius_frac=0.3, dot_radius=3, background=10.0, foreground=250.0):
        super().__init__(width, height, frame_rate)
        self.num_frames = num_frames
        self.radius_frac = radius_frac
        self.dot_radius = dot_radius
        self.background = background
        self.foreground = foreground

    def total_frames(self) -> int:
        return self.num_frames

    def frame(self, i: int) -> np.ndarray:
        angle = 2 * np.pi * i / self.num_frames
        cx = self.width / 2 + self.radius_frac * self.width * np.cos(angle)
        cy = self.height / 2 + self.radius_frac * self.height * np.sin(angle)
        ys, xs = np.mgrid[0 : self.height, 0 : self.width]
        dot = (xs - cx) ** 2 + (ys - cy) ** 2 <= self.dot_radius**2
        return np.where(dot, self.foreground, self.background).astype(np.float32)


class MovingBar(SyntheticInput):
    """A vertical bright bar sweeping horizontally at constant speed —
    the classic v2e speed-test stimulus (upstream v2e ships it as its
    moving-bar synthetic input; the vendored tree keeps only the
    abstract base, base_synthetic_input.py). Constant edge speed gives
    an analytically known event rate: each pixel column fires once per
    bar transit edge."""

    def __init__(self, width=64, height=64, frame_rate=500.0,
                 num_frames=200, bar_width=4, speed_px_per_frame=1.0,
                 background=10.0, foreground=250.0):
        super().__init__(width, height, frame_rate)
        self.num_frames = num_frames
        self.bar_width = bar_width
        self.speed = speed_px_per_frame
        self.background = background
        self.foreground = foreground

    def total_frames(self) -> int:
        return self.num_frames

    def frame(self, i: int) -> np.ndarray:
        x0 = (i * self.speed) % (self.width + self.bar_width) - self.bar_width
        xs = np.arange(self.width)
        bar = (xs >= x0) & (xs < x0 + self.bar_width)
        row = np.where(bar, self.foreground, self.background)
        return np.broadcast_to(row, (self.height, self.width)).astype(np.float32)


class ParticleField(SyntheticInput):
    """Random bright particles drifting with a shared velocity field —
    a flow-style stimulus for noise/threshold studies. Deterministic
    per seed; particles wrap at the borders."""

    def __init__(self, width=64, height=64, frame_rate=300.0,
                 num_frames=120, num_particles=30, radius=1,
                 velocity=(0.7, 0.3), seed=0,
                 background=10.0, foreground=250.0):
        super().__init__(width, height, frame_rate)
        self.num_frames = num_frames
        self.radius = radius
        self.velocity = np.asarray(velocity, np.float64)
        self.background = background
        self.foreground = foreground
        rng = np.random.default_rng(seed)
        self.origins = rng.uniform(0, [width, height], size=(num_particles, 2))

    def total_frames(self) -> int:
        return self.num_frames

    def frame(self, i: int) -> np.ndarray:
        pos = (self.origins + i * self.velocity) % [self.width, self.height]
        ys, xs = np.mgrid[0 : self.height, 0 : self.width]
        img = np.full((self.height, self.width), self.background, np.float32)
        for px, py in pos:
            mask = (xs - px) ** 2 + (ys - py) ** 2 <= self.radius**2
            img[mask] = self.foreground
        return img
