"""The detector's train state and train step (port of ``train/detection_state.py``).

One step is detectron2's ``SimpleTrainer.run_step``
(``engine/train_loop.py:216-295``): the model's training losses ->
gradients -> one optimizer update. As in the JAX package every parameter
takes part in the update, the frozen ones too: FrozenBN's tensors and the
weights ``freeze_at`` stops get a zero gradient, and SGD's weight decay,
which optax's ``add_decayed_weights`` applies to every leaf, still shrinks
them through the momentum. ``torch.optim.SGD`` skips a parameter without a
``.grad``, so the step gives each of them a zero one.
"""

from __future__ import annotations

from typing import Callable

import torch

from .optim import global_norm
from .state import TrainState

Tensor = torch.Tensor

# the detector's state: the model, its optimizer and the updates done
DetTrainState = TrainState


def make_detection_train_step(ema_loss_normalizer: bool = False) -> Callable[..., dict]:
    """Returns step(state, batch, generator=None, draws=None) -> metrics,
    updating ``state`` in place.

    ``batch``: ``image`` (B, H, W, 3) raw 0-255, ``gt_boxes`` (B, G, 4),
    ``gt_classes`` (B, G), ``gt_valid`` (B, G). The sampling's priorities
    come from ``draws`` or ``generator`` (``GeneralizedRCNN.losses``). The
    metrics stay on the device: every loss and ``grad_norm``, the global
    norm of the gradients. ``ema_loss_normalizer`` is RetinaNet's, which
    the port does not have: it raises.
    """
    if ema_loss_normalizer:
        raise NotImplementedError("the EMA loss normalizer is RetinaNet's, which is not ported")

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None,
             draws: dict | None = None) -> dict[str, Tensor]:
        model = state.model
        losses = model.losses(batch["image"], batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"],
                              generator=generator, draws=draws)
        state.optimizer.zero_grad()
        losses["loss_total"].backward()
        params = list(model.parameters())
        for p in params:
            if p.grad is None:  # frozen: optax's gradient there is zero, and the decay still applies
                p.grad = torch.zeros_like(p)
        grad_norm = global_norm(p.grad for p in params)
        state.optimizer.step(state.step)
        state.step += 1
        return {**{k: v.detach() for k, v in losses.items()}, "grad_norm": grad_norm}

    return step
