"""Adversarial domain-adaptation training: a generator and a discriminator, two optimizers (port of ``train/adversarial.py``).

The reference's ``lib/core/function.py`` ``train_da_ms`` (:96-258). Per step:

1. the discriminator learns to tell the generator's detached heatmaps of
   the source images (label 0) from those of the target-domain images
   (label 1): softmax cross-entropy, its BatchNorms on batch statistics;
2. the generator learns: the per-scale JointsMSELoss on the source half
   plus ``beta`` times the adversarial term, read through the updated
   discriminator in eval mode (its new running statistics), whose
   parameters take no gradient. ``d_loss_mode`` 1 pushes every image
   toward the source label; 2 maximizes the discriminator's error,
   ``1 - CE(domain)``.

The JAX step runs the generator forward twice on the same parameters,
statistics and images (once detached for phase 1, once under the gradient
for phase 2) and keeps the statistics of the second. Both forwards give
the same numbers, so here one forward under the gradient serves both
phases: its outputs, detached, feed phase 1, and phase 2 reuses them. The
generator's BN running statistics are updated once a step, as in JAX.
The three phases are separate functions so that a caller can time them;
:func:`make_da_train_step` runs them in order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .loss import joints_mse_loss
from .optim import Optimizer
from .state import TrainState

Tensor = torch.Tensor

# the batch keys of the four per-scale targets, finest first
SCALE_KEYS = (("target", "target_weight"), ("target2", "target_weight2"),
              ("target3", "target_weight3"), ("target4", "target_weight4"))


@dataclasses.dataclass
class DAState:
    """Both models, both optimizers and ``step``, the number of updates
    done (each optimizer's schedule argument)."""

    generator: nn.Module
    discriminator: nn.Module
    gen_optimizer: Optimizer
    disc_optimizer: Optimizer
    step: int = 0

    @property
    def model(self) -> nn.Module:
        """The generator: the model whose ``.npz`` a checkpoint holds."""
        return self.generator

    def generator_state(self) -> TrainState:
        """The generator side as a ``TrainState`` (the evaluation's checkpoint)."""
        return TrainState(self.generator, self.gen_optimizer, self.step)

    def state_dict(self) -> dict:
        return {"generator": self.generator.state_dict(), "discriminator": self.discriminator.state_dict(),
                "gen_optimizer": self.gen_optimizer.state_dict(),
                "disc_optimizer": self.disc_optimizer.state_dict(), "step": int(self.step)}

    def load_state_dict(self, payload: dict) -> None:
        """Both models, the step and each optimizer's per-parameter state where
        it fits; the optimizers keep their own hyperparameters
        (``Optimizer.load_state_dict``)."""
        self.generator.load_state_dict(payload["generator"])
        self.discriminator.load_state_dict(payload["discriminator"])
        self.gen_optimizer.load_state_dict(payload["gen_optimizer"])
        self.disc_optimizer.load_state_dict(payload["disc_optimizer"])
        self.step = int(payload["step"])


def softmax_ce(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean softmax cross-entropy of (B, C) logits against (B,) labels."""
    return F.cross_entropy(logits.float(), labels)


def domain_labels(batch: dict) -> Tensor:
    """0 for each source image, 1 for each target-domain image."""
    ns, nt = batch["source_image"].shape[0], batch["target_image"].shape[0]
    dev = batch["source_image"].device
    return torch.cat([torch.zeros(ns, dtype=torch.int64, device=dev), torch.ones(nt, dtype=torch.int64, device=dev)])


def generator_forward(state: DAState, batch: dict) -> tuple[Tensor, ...]:
    """The generator in train mode on the source images, then the target
    images: its four maps, under the gradient."""
    state.generator.train()
    outs = state.generator(torch.cat([batch["source_image"], batch["target_image"]]))
    if not isinstance(outs, (tuple, list)):
        raise ValueError("domain adaptation needs a multi-scale generator (hrnet_cms*)")
    return outs


def discriminator_update(state: DAState, outs: tuple[Tensor, ...], domain: Tensor) -> Tensor:
    """Phase 1: one discriminator update on the detached maps -> ``d_loss``."""
    disc = state.discriminator
    disc.train()
    d_loss = softmax_ce(disc(*(o.detach() for o in outs)), domain)
    state.disc_optimizer.zero_grad()
    d_loss.backward()
    state.disc_optimizer.step(state.step)
    return d_loss.detach()


def generator_update(state: DAState, outs: tuple[Tensor, ...], batch: dict, domain: Tensor, beta: float,
                     d_loss_mode: int) -> tuple[Tensor, Tensor, Tensor]:
    """Phase 2: one generator update from ``outs`` -> (loss, hm_loss, adv_loss).
    The gradient flows through the discriminator (eval mode, parameters
    frozen for the call) into the generator only."""
    ns = batch["source_image"].shape[0]
    hm_loss = sum(joints_mse_loss(o[:ns], batch[tk], batch[wk]) for o, (tk, wk) in zip(outs, SCALE_KEYS)
                  if tk in batch)
    disc = state.discriminator
    disc.eval()
    disc.requires_grad_(False)
    try:
        logits = disc(*outs)
        if d_loss_mode == 1:
            adv = softmax_ce(logits, torch.zeros_like(domain))
        else:
            adv = 1.0 - softmax_ce(logits, domain)
        loss = hm_loss + beta * adv
        state.gen_optimizer.zero_grad()
        loss.backward()
    finally:
        disc.requires_grad_(True)
    state.gen_optimizer.step(state.step)
    return loss.detach(), hm_loss.detach(), adv.detach()


def make_da_train_step(beta: float = 0.0002, d_loss_mode: int = 1) -> Callable[[DAState, dict], dict]:
    """Returns step(state, batch) -> metrics, updating ``state`` in place.

    ``batch``: ``source_image`` (Ns, H, W, 3) and ``target_image`` (Nt, H,
    W, 3) normalized crops, and the source half's per-scale targets
    ``target``, ``target2``... with their ``target_weight``... (see
    ``SCALE_KEYS``; the scales present are summed). The metrics stay on the
    device: ``loss``, ``hm_loss``, ``d_loss`` and ``adv_loss``.
    """
    if d_loss_mode not in (1, 2):
        raise ValueError(f"d_loss_mode must be 1 or 2, got {d_loss_mode}")

    def step(state: DAState, batch: dict) -> dict[str, Tensor]:
        domain = domain_labels(batch)
        outs = generator_forward(state, batch)
        d_loss = discriminator_update(state, outs, domain)
        loss, hm_loss, adv = generator_update(state, outs, batch, domain, beta, d_loss_mode)
        state.step += 1
        return {"loss": loss, "hm_loss": hm_loss, "d_loss": d_loss, "adv_loss": adv}

    return step
