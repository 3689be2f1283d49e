"""The detector's train state and train step (port of ``train/detection_state.py``).

One step is detectron2's ``SimpleTrainer.run_step``
(``engine/train_loop.py:216-295``): the model's training losses ->
gradients -> one optimizer update. As in the JAX package every parameter
takes part in the update, the frozen ones too: FrozenBN's tensors and the
weights ``freeze_at`` stops get a zero gradient, and SGD's weight decay,
which optax's ``add_decayed_weights`` applies to every leaf, still shrinks
them through the momentum. ``torch.optim.SGD`` skips a parameter without a
``.grad``, so the step gives each of them a zero one.

RetinaNet's step normalizes its summed losses by an EMA of the batches'
foreground-anchor counts (detectron2's ``loss_normalizer``, momentum 0.9,
starting at 100), which the state carries and its checkpoints keep.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .optim import global_norm
from .state import TrainState

Tensor = torch.Tensor

LOSS_NORMALIZER_INIT = 100.0  # detectron2 RetinaNet's _ema_update initial value
LOSS_NORMALIZER_MOMENTUM = 0.9


@dataclasses.dataclass
class DetTrainState(TrainState):
    """The model, its optimizer, the updates done and ``loss_normalizer``,
    RetinaNet's EMA of the foreground count: a float32 scalar on the
    model's device, 100 until an EMA step updates it."""

    loss_normalizer: Tensor | None = None

    def __post_init__(self):
        if self.loss_normalizer is None:
            device = next(self.model.parameters()).device
            self.loss_normalizer = torch.tensor(LOSS_NORMALIZER_INIT, dtype=torch.float32, device=device)

    def state_dict(self) -> dict:
        return {**super().state_dict(), "loss_normalizer": self.loss_normalizer.detach().clone()}

    def load_state_dict(self, payload: dict) -> None:
        super().load_state_dict(payload)
        if "loss_normalizer" in payload:
            self.loss_normalizer = payload["loss_normalizer"].to(self.loss_normalizer.device, torch.float32)


def make_detection_train_step(needs_sampling_rng: bool = True,
                              ema_loss_normalizer: bool = False) -> Callable[..., dict]:
    """Returns step(state, batch, generator=None, draws=None) -> metrics,
    updating ``state`` in place.

    ``batch``: ``image`` (B, H, W, 3) raw 0-255, ``gt_boxes`` (B, G, 4),
    ``gt_classes`` (B, G), ``gt_valid`` (B, G), and, for a Mask / Keypoint
    R-CNN, ``gt_masks`` (B, G, H, W) and ``gt_keypoints`` (B, G, K, 3),
    which ``GeneralizedRCNN.losses`` trains its heads on. With ``needs_sampling_rng``
    (the Faster R-CNN) the sampling's priorities come from ``draws`` or
    ``generator`` (``GeneralizedRCNN.losses``); RetinaNet samples nothing
    and ignores both. The metrics stay on the device: every loss,
    ``grad_norm`` (the global norm of the gradients the optimizer takes)
    and ``loss_normalizer``.

    ``ema_loss_normalizer``: RetinaNet's normalization. The model's
    ``num_fg`` (already at least 1) does not depend on the parameters, so
    the gradients of its ``loss_total`` (the sums over ``num_fg``) are
    rescaled by num_fg / max(new normalizer, 1e-6), the new normalizer
    0.9 * old + 0.1 * num_fg; the reported losses stay the batch-normalized
    ones, as in JAX's metrics.
    """

    def step(state: DetTrainState, batch: dict, generator: torch.Generator | None = None,
             draws: dict | None = None) -> dict[str, Tensor]:
        model = state.model
        sampling = {"generator": generator, "draws": draws} if needs_sampling_rng else {}
        heads = {k: batch[k] for k in ("gt_masks", "gt_keypoints") if k in batch}
        losses = model.losses(batch["image"], batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"],
                              **sampling, **heads)
        state.optimizer.zero_grad()
        losses["loss_total"].backward()
        params = list(model.parameters())
        for p in params:
            if p.grad is None:  # frozen: optax's gradient there is zero, and the decay still applies
                p.grad = torch.zeros_like(p)
        if ema_loss_normalizer and "num_fg" in losses:
            num_fg = losses["num_fg"].detach()
            m = LOSS_NORMALIZER_MOMENTUM
            state.loss_normalizer = m * state.loss_normalizer + (1 - m) * num_fg
            torch._foreach_mul_([p.grad for p in params], num_fg / torch.clamp(state.loss_normalizer, min=1e-6))
        grad_norm = global_norm(p.grad for p in params)
        state.optimizer.step(state.step)
        state.step += 1
        return {**{k: v.detach() for k, v in losses.items()}, "grad_norm": grad_norm,
                "loss_normalizer": state.loss_normalizer}

    return step
