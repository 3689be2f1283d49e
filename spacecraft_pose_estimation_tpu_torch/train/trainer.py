"""Hook-driven training loop (port of ``train/trainer.py``, detectron2's ``engine/train_loop.py:88-295``).

:class:`Trainer` owns the state, the storage and the hooks, and runs a
step over a data iterator. The hooks are detectron2's
(``engine/hooks.py``): :class:`IterationTimer`, :class:`PeriodicWriter`,
:class:`PeriodicCheckpointer`, :class:`BestCheckpointer`, :class:`EvalHook`,
:class:`MemoryStats` (TorchMemoryStats) and :class:`TraceProfiler`
(TorchProfiler, a Chrome trace of ``torch.profiler``); and PreciseBN's
:func:`recompute_batch_stats`. The port's step updates its state in place
and returns the metrics.

One deviation: checkpoints are saved, and resumed, at the number of
updates done (``state.step``), where the JAX hooks save at the index of
the step just taken and a resumed JAX run takes that step again.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Iterable, Sequence

import torch

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


class BestCheckpointer(Hook):
    """Save when the watched metric (the storage's latest value) is higher
    than the best so far (detectron2 ``hooks.py:209``), through
    ``CheckpointManager.save_best``, which also keeps the state in
    ``best/``; checked every ``period`` steps. Put it after the
    :class:`EvalHook` that puts the metric."""

    def __init__(self, manager, metric: str, period: int = 1):
        self.manager = manager
        self.metric = metric
        self.period = period

    def after_step(self, trainer):
        if (trainer.iteration + 1) % self.period:
            return
        latest = trainer.storage.latest().get(self.metric)
        if latest is None:
            return
        if self.manager.save_best(trainer.state.step, latest[0], state=trainer.state):
            self.manager.save(trainer.state.step, trainer.state, {"best": latest[0]})


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


class MemoryStats(Hook):
    """Every ``period`` steps, put ``device_mem_gb``: the bytes the caching
    allocator holds in tensors on the current CUDA device
    (``torch.cuda.memory_allocated``) over 2^30. Without a CUDA device
    nothing is put, as the JAX hook puts nothing for a device without
    memory statistics (the CPU)."""

    def __init__(self, period: int = 100):
        self.period = period

    def after_step(self, trainer):
        if (trainer.iteration + 1) % self.period or not torch.cuda.is_available():
            return
        trainer.storage.put_scalar("device_mem_gb", torch.cuda.memory_allocated() / 2**30)


class TraceProfiler(Hook):
    """``torch.profiler`` over the steps ``start``..``stop`` (CPU, and CUDA
    where there is a card): started before step ``start``, stopped after
    step ``stop``, its Chrome trace written to
    ``log_dir/trace_{start}-{stop}.json``. A run that ends before ``stop``
    stops it and writes what it traced."""

    def __init__(self, log_dir: str, start: int, stop: int):
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self._prof = None

    @property
    def path(self) -> str:
        return os.path.join(self.log_dir, f"trace_{self.start}-{self.stop}.json")

    def before_step(self, trainer):
        if trainer.iteration == self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()

    def after_step(self, trainer):
        if trainer.iteration == self.stop:
            self._finish()

    def after_train(self, trainer):
        self._finish()

    def _finish(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(self.path)


def recompute_batch_stats(state, batches: Iterable[dict], momentum: float = 0.0):
    """PreciseBN (detectron2 ``hooks.py:566``): set every ``BatchNorm``'s
    running ``mean`` and ``var`` of ``state.model`` to the average of its
    batch moments over ``batches`` (each with an ``image``), the model in
    train mode; returns ``state`` with the model updated in place and in the
    mode it had. ``momentum`` is accepted and ignored, as in the JAX package.

    The JAX function recovers each batch's moments by inverting the EMA
    update of the running statistics, ``(new - 0.9 old) / 0.1``; here each
    BN's batch mean and biased variance over N, H, W are read from its
    input in float32 (what the EMA was fed, up to rounding), so no rounding
    error is multiplied by 10.
    """
    from ..models.layers import BatchNorm

    del momentum
    model = state.model
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    sums = {bn: [0.0, 0.0] for bn in bns}

    def record(bn, args):
        var, mean = torch.var_mean(args[0].float(), dim=(0, 2, 3), unbiased=False)
        sums[bn][0] = sums[bn][0] + mean
        sums[bn][1] = sums[bn][1] + var

    handles = [bn.register_forward_pre_hook(record) for bn in bns]
    was_training, n = model.training, 0
    model.train()
    try:
        with torch.no_grad():
            for batch in batches:
                model(batch["image"])
                n += 1
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    if n:
        with torch.no_grad():
            for bn, (mean, var) in sums.items():
                bn.mean.copy_(mean / n)
                bn.var.copy_(var / n)
    return state
