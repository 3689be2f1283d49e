"""Train state and the train / eval steps of the landmark stage (port of ``train/state.py``).

One step is the reference's epoch-loop body (``lib/core/function.py:27-94``):
forward in train mode (batch-statistics BN) -> JointsMSELoss -> gradients
-> one optimizer update. The JAX ``TrainState`` is an immutable tree that
each step replaces; here it holds the model and its optimizer, which the
step updates in place, and the count of updates done.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from .accuracy import pck_accuracy
from .loss import joints_mse_loss
from .optim import Optimizer, global_norm

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN ``mean``/``var``), its optimizer and
    ``step``, the number of updates done: the schedule's argument."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": int(self.step)}

    def load_state_dict(self, payload: dict) -> None:
        """Load a :meth:`state_dict`: the model, the step and the optimizer's
        per-parameter state. The optimizer keeps its own hyperparameters,
        and where the saved state does not fit it (another optimizer kind,
        e.g. an imported checkpoint's placeholder) only the model and the
        step are taken (``Optimizer.load_state_dict``), as the JAX
        ``CheckpointManager.restore`` keeps the template's ``opt_state``."""
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])


def make_train_step(use_target_weight: bool = True) -> Callable[[TrainState, dict], dict]:
    """Returns step(state, batch) -> metrics, updating ``state`` in place.

    ``batch``: ``image`` (B, H, W, 3) normalized crops, ``target``
    (B, h, w, J), ``target_weight`` (B, J). The loss is summed over the
    model's outputs when it returns several (the CMS heads' deep
    supervision). The metrics stay on the device: ``loss``, ``grad_norm``
    (the global norm of the gradients) and ``acc`` (PCK@0.5 of the last
    output's detached float32 heatmaps).
    """

    def step(state: TrainState, batch: dict) -> dict[str, Tensor]:
        model = state.model
        model.train()
        outputs = model(batch["image"])
        tw = batch["target_weight"] if use_target_weight else None
        outs = outputs if isinstance(outputs, (tuple, list)) else (outputs,)
        loss = sum(joints_mse_loss(o, batch["target"], tw) for o in outs)
        state.optimizer.zero_grad()
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        grad_norm = global_norm(p.grad for p in params)
        state.optimizer.step(state.step)
        state.step += 1
        _, acc = pck_accuracy(outs[-1].detach().float(), batch["target"].float())
        return {"loss": loss.detach(), "grad_norm": grad_norm, "acc": acc}

    return step


def make_eval_step() -> Callable[[TrainState, Tensor], Tensor]:
    """Returns eval(state, images) -> heatmaps with the running BN statistics."""

    @torch.no_grad()
    def step(state: TrainState, images: Tensor) -> Tensor:
        state.model.eval()
        return state.model(images)

    return step
