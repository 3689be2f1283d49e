"""Optimizers and the learning-rate schedule (port of ``train/optim.py``).

The reference's two solver stacks: HRNet's ``get_optimizer``
(``lib/utils/utils.py:58-77``, Adam, or SGD with momentum, weight decay and
Nesterov) stepped with MultiStepLR, and detectron2's multistep schedule
with linear warmup and gradient clipping. The JAX package builds them from
optax; here they are ``torch.optim`` optimizers whose learning rate is set
before every update from :func:`multistep_schedule` at the number of
updates done so far, as optax evaluates a schedule on its count (no torch
scheduler).
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch

Schedule = Callable[[int], float]


def multistep_schedule(base_lr: float, milestones: Sequence[int], factor: float = 0.1,
                       warmup_steps: int = 0, warmup_factor: float = 1e-3) -> Schedule:
    """step -> learning rate: ``base_lr`` times ``factor`` for every milestone
    m with step >= m (optax ``piecewise_constant_schedule``: the drop is at
    step m itself), times a linear warmup from ``warmup_factor`` to 1 over
    ``warmup_steps`` (optax ``linear_schedule``)."""
    milestones = sorted(int(m) for m in milestones)

    def schedule(step: int) -> float:
        lr = base_lr * factor ** sum(step >= m for m in milestones)
        if warmup_steps > 0:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            lr *= (warmup_factor - 1.0) * frac + 1.0
        return lr

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (``optax.global_norm``), float32."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class Optimizer:
    """A ``torch.optim`` optimizer driven by a schedule, with optax's
    ``clip_by_global_norm`` in front when ``grad_clip_norm`` is set:
    gradients whose global norm is ``>= max`` are scaled by max / norm."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Schedule, grad_clip_norm: float | None = None):
        self.inner, self.schedule, self.grad_clip_norm = inner, schedule, grad_clip_norm

    def step(self, count: int) -> None:
        """One update at ``count`` updates done (the schedule's argument)."""
        lr = self.schedule(count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        if self.grad_clip_norm is not None:
            grads = [p.grad for g in self.inner.param_groups for p in g["params"] if p.grad is not None]
            norm = global_norm(grads)
            scale = torch.where(norm < self.grad_clip_norm, 1.0, self.grad_clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        self.inner.step()

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Load the per-parameter state of a :meth:`state_dict` (momentum
        traces, Adam moments) and keep this optimizer's own hyperparameters
        (``weight_decay``, ``momentum``, ``nesterov``, ``betas`` ...): as in
        optax, they come from the optimizer that was built, never from the
        checkpoint. Where the saved state does not fit this optimizer
        (another kind, i.e. other hyperparameter names, or other group or
        parameter counts) nothing is loaded."""
        groups, saved = self.inner.param_groups, state.get("param_groups", [])
        n_params = sum(len(g["params"]) for g in groups)
        fits = (len(saved) == len(groups)
                and all(set(s) == set(g) and len(s["params"]) == len(g["params"]) for s, g in zip(saved, groups))
                and all(0 <= int(i) < n_params for i in state.get("state", {})))
        if fits:
            own = [{k: v for k, v in g.items() if k != "params"} | {"params": s["params"]} for s, g in zip(saved, groups)]
            self.inner.load_state_dict({"state": state["state"], "param_groups": own})


def build_optimizer(name: str, params, learning_rate: Schedule | float, weight_decay: float = 0.0,
                    momentum: float = 0.9, nesterov: bool = False,
                    grad_clip_norm: float | None = None) -> Optimizer:
    """``adam``: Adam (b1 0.9, b2 0.999, eps 1e-8) with no weight decay, as
    the JAX package's ``optax.adam`` branch ignores it; ``adamw``: decoupled
    decay, ``p *= 1 - lr * wd``; ``sgd``: the decay added to the gradient
    before the momentum trace (``add_decayed_weights`` then ``optax.sgd``,
    no dampening)."""
    schedule = learning_rate if callable(learning_rate) else (lambda _step, lr=float(learning_rate): lr)
    lr0 = schedule(0)
    name = name.lower()
    if name == "adam":
        inner = torch.optim.Adam(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    elif name == "adamw":
        inner = torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    elif name == "sgd":
        inner = torch.optim.SGD(params, lr=lr0, momentum=momentum, dampening=0.0, nesterov=nesterov,
                                weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {name}")
    return Optimizer(inner, schedule, grad_clip_norm)
