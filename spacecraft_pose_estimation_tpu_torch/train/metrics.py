"""Metric storage and writers (port of ``train/metrics.py``, detectron2's ``utils/events.py:26-377``).

:class:`MetricStorage` keeps step-indexed scalar histories; writers flush
them: JSON lines (:class:`JSONWriter`), TensorBoard through tensorboardX
(:class:`TensorboardWriter`, nothing when tensorboardX is absent) and a
terminal line with smoothed values and an ETA (:class:`TerminalPrinter`).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from collections import defaultdict, deque

logger = logging.getLogger(__name__)


class MetricStorage:
    def __init__(self, window_size: int = 20):
        self._history: dict[str, deque] = defaultdict(lambda: deque(maxlen=window_size))
        self._latest: dict[str, tuple[float, int]] = {}
        self.step = 0

    def put_scalar(self, name: str, value: float) -> None:
        value = float(value)
        self._history[name].append(value)
        self._latest[name] = (value, self.step)

    def put_scalars(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def latest(self) -> dict[str, tuple[float, int]]:
        return dict(self._latest)

    def median(self, name: str) -> float:
        h = sorted(self._history[name])
        return h[len(h) // 2] if h else float("nan")

    def avg(self, name: str) -> float:
        h = self._history[name]
        return sum(h) / len(h) if h else float("nan")


class JSONWriter:
    """One JSON line of the latest metrics per flush (``metrics.json``)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: MetricStorage) -> None:
        row = {"iteration": storage.step}
        row.update({k: v for k, (v, _) in storage.latest().items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TensorboardWriter:
    """tensorboardX scalars; writes nothing when tensorboardX is not installed."""

    def __init__(self, log_dir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._w = None
        else:
            self._w = SummaryWriter(log_dir)

    def write(self, storage: MetricStorage) -> None:
        if self._w is None:
            return
        for k, (v, step) in storage.latest().items():
            self._w.add_scalar(k, v, step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


class TerminalPrinter:
    """Smoothed metrics and an ETA (detectron2's CommonMetricPrinter)."""

    def __init__(self, max_iter: int | None = None):
        self.max_iter = max_iter
        self._last: tuple[int, float] | None = None

    def write(self, storage: MetricStorage) -> None:
        eta = ""
        now = time.perf_counter()
        if self.max_iter and self._last is not None:
            it0, t0 = self._last
            if storage.step > it0:
                remaining = (now - t0) / (storage.step - it0) * (self.max_iter - storage.step)
                eta = f" eta: {datetime.timedelta(seconds=int(remaining))}"
        self._last = (storage.step, now)
        parts = [f"iter: {storage.step}{eta}"]
        parts += [f"{k}: {storage.median(k):.4g}" for k in sorted(storage.latest())]
        logger.info("  ".join(parts))

    def close(self) -> None:
        pass
