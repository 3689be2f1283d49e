"""Ensemble evaluation: the mean of k landmark models' heatmaps.

Port of ``train/ensemble.py`` (``validate_cv`` / ``tools/test_cv_ensemble.py``
of the reference): the JAX package stacks the k variable trees and maps
one apply over them; here the k models are a list of modules, each run on
the same crops.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class EnsembleModel(nn.Module):
    """k landmark models as one: (B, H, W, 3) crops -> their mean (B, h, w, J) heatmaps."""

    def __init__(self, models: Sequence[nn.Module]):
        super().__init__()
        self.members = nn.ModuleList(models)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return torch.stack([m(images) for m in self.members]).mean(0)
