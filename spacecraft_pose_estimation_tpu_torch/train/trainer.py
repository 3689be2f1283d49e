"""Hook-driven training loop (port of ``train/trainer.py``, detectron2's ``engine/train_loop.py:88-295``).

:class:`Trainer` owns the state, the storage and the hooks, and runs a
step over a data iterator. The hooks are detectron2's
(``engine/hooks.py``): :class:`IterationTimer`, :class:`PeriodicWriter`,
:class:`PeriodicCheckpointer` and :class:`EvalHook`. The port's step
updates its state in place and returns the metrics.

One deviation: checkpoints are saved, and resumed, at the number of
updates done (``state.step``), where the JAX hooks save at the index of
the step just taken and a resumed JAX run takes that step again.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterable, Sequence

from .metrics import MetricStorage

logger = logging.getLogger(__name__)


class Hook:
    def before_train(self, trainer: "Trainer") -> None: ...

    def after_train(self, trainer: "Trainer") -> None: ...

    def before_step(self, trainer: "Trainer") -> None: ...

    def after_step(self, trainer: "Trainer") -> None: ...


class Trainer:
    """TrainerBase / SimpleTrainer: state + hooks + a step ``(state, batch) -> metrics``."""

    def __init__(self, step_fn: Callable, state: Any, data_iter: Iterable, hooks: Sequence[Hook] = (),
                 storage: MetricStorage | None = None):
        self.step_fn = step_fn
        self.state = state
        self.data_iter = iter(data_iter)
        self.hooks = list(hooks)
        self.storage = storage or MetricStorage()
        self.iteration = 0
        self.max_iter = 0

    def train(self, start_iter: int, max_iter: int) -> None:
        self.iteration = start_iter
        self.max_iter = max_iter
        for h in self.hooks:
            h.before_train(self)
        try:
            while self.iteration < max_iter:
                self.storage.step = self.iteration
                for h in self.hooks:
                    h.before_step(self)
                self.run_step()
                for h in self.hooks:
                    h.after_step(self)
                self.iteration += 1
        finally:
            for h in self.hooks:
                h.after_train(self)

    def run_step(self) -> None:
        batch = next(self.data_iter)
        metrics = self.step_fn(self.state, batch)
        self.storage.put_scalars(**{k: float(v) for k, v in metrics.items()})


class IterationTimer(Hook):
    def before_step(self, trainer):
        self._t0 = time.perf_counter()

    def after_step(self, trainer):
        trainer.storage.put_scalar("time", time.perf_counter() - self._t0)


class PeriodicWriter(Hook):
    def __init__(self, writers, period: int = 20):
        self.writers = writers
        self.period = period

    def after_step(self, trainer):
        if (trainer.iteration + 1) % self.period == 0 or trainer.iteration == trainer.max_iter - 1:
            for w in self.writers:
                w.write(trainer.storage)

    def after_train(self, trainer):
        for w in self.writers:
            w.write(trainer.storage)
            w.close()


class PeriodicCheckpointer(Hook):
    """Save every ``period`` updates and after the last, under the number
    of updates done."""

    def __init__(self, manager, period: int):
        self.manager = manager
        self.period = period

    def after_step(self, trainer):
        if (trainer.iteration + 1) % self.period == 0 or trainer.iteration == trainer.max_iter - 1:
            self.manager.save(trainer.state.step, trainer.state)


class EvalHook(Hook):
    def __init__(self, period: int, fn: Callable[["Trainer"], dict]):
        self.period = period
        self.fn = fn

    def _do_eval(self, trainer):
        results = self.fn(trainer)
        if results:
            trainer.storage.put_scalars(**results)

    def after_step(self, trainer):
        next_iter = trainer.iteration + 1
        # the final iteration's evaluation belongs to after_train (d2 hooks.py:550-560)
        if self.period > 0 and next_iter % self.period == 0 and next_iter != trainer.max_iter:
            self._do_eval(trainer)

    def after_train(self, trainer):
        # only a finished run is evaluated: the loop's finally also runs on an exception
        if trainer.iteration >= trainer.max_iter:
            self._do_eval(trainer)
