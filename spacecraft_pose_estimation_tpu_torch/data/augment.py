"""Photometric augmentations of the domain-adaptation trainer (port of the part of ``data/augment.py`` it calls).

``color_jitter``, ``random_noise_01`` and ``random_erasing`` (JAX
``augment.py:349-420``), batched over (B, H, W, C) float32 images on their
device. Each takes its random draws as arguments; ``sample_*`` beside it
draws them from a CPU ``torch.Generator`` (so one seed gives the same
draws on every device). ``jax.random`` cannot be reproduced in PyTorch:
the tests feed the JAX package's own draws to these functions.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _per_image(v: Tensor, like: Tensor) -> Tensor:
    return v.to(like.device, torch.float32)[:, None, None, None]


def sample_color_jitter(generator: torch.Generator, batch: int, brightness: float = 0.4, contrast: float = 0.4,
                        saturation: float = 0.4) -> Tensor:
    """(B, 3) brightness, contrast and saturation factors, each
    U(1 - f, 1 + f)."""
    f = torch.tensor([brightness, contrast, saturation])
    return (1.0 - f) + 2.0 * f * torch.rand(batch, 3, generator=generator)


def color_jitter(img: Tensor, factors: Tensor) -> Tensor:
    """torchvision's ColorJitter in a fixed order (brightness, contrast,
    saturation) on [0, 255] images: scale; blend with the image's mean;
    blend with each pixel's grey (channel mean); clip to [0, 255]."""
    b, c, s = (_per_image(f, img) for f in factors.unbind(-1))
    img = img * b
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    img = (img - mean) * c + mean
    grey = img.mean(dim=-1, keepdim=True)
    img = (img - grey) * s + grey
    return img.clamp(0.0, 255.0)


def sample_noise_01(generator: torch.Generator, batch: int, height: int, width: int,
                    std_range: tuple[float, float] = (0.03, 0.05),
                    mean_range: tuple[float, float] = (0.05, 0.15)) -> dict[str, Tensor]:
    """``std`` (B,) and ``mean`` (B,) uniform in their ranges, and ``noise``
    (B, H, W, 1) standard normal, one value per pixel for every channel."""
    std = std_range[0] + (std_range[1] - std_range[0]) * torch.rand(batch, generator=generator)
    mean = mean_range[0] + (mean_range[1] - mean_range[0]) * torch.rand(batch, generator=generator)
    return {"std": std, "mean": mean, "noise": torch.randn(batch, height, width, 1, generator=generator)}


def random_noise_01(img01: Tensor, std: Tensor, mean: Tensor, noise: Tensor) -> Tensor:
    """The reference's RandomNoise on [0, 1] images: ``std * noise + mean``
    added to every channel, clipped to [0, 1]."""
    noise = noise.to(img01.device, torch.float32)
    return (_per_image(std, img01) * noise + _per_image(mean, img01) + img01).clamp(0.0, 1.0)


def sample_erasing(generator: torch.Generator, batch: int, height: int, width: int, min_frac: float = 0.05,
                   max_frac: float = 0.3) -> Tensor:
    """(B, 4) int64 rectangles (eh, ew, y0, x0): the height and width are
    U(min_frac, max_frac) of the image's, truncated to pixels; the corner
    uniform over the image (the rectangle may run off its far edges)."""
    frac = min_frac + (max_frac - min_frac) * torch.rand(batch, 2, generator=generator)
    eh, ew = (frac * torch.tensor([height, width])).to(torch.int64).unbind(-1)
    y0 = torch.randint(0, height, (batch,), generator=generator)
    x0 = torch.randint(0, width, (batch,), generator=generator)
    return torch.stack([eh, ew, y0, x0], dim=-1)


def random_erasing(img: Tensor, rects: Tensor) -> Tensor:
    """Zero the rectangle (eh, ew, y0, x0) of each (H, W, C) image."""
    eh, ew, y0, x0 = (v.to(img.device)[:, None, None] for v in rects.unbind(-1))
    ys = torch.arange(img.shape[1], device=img.device)[None, :, None]
    xs = torch.arange(img.shape[2], device=img.device)[None, None, :]
    inside = (ys >= y0) & (ys < y0 + eh) & (xs >= x0) & (xs < x0 + ew)
    return torch.where(inside[..., None], 0.0, img)
