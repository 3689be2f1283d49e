"""Device-side photometric augmentations: the DA trainer's ops and the event / SPEED+ stacks (port of ``data/augment.py``).

The reference's two augmentation families (the detectron2 fork's
``augmentation_impl.py:639-1120`` and the HRNet side's
``lib/utils/transforms.py:131-484``), batched over (B, H, W, C) float32
images in [0, 255] on their device:

* the DA trainer's ``color_jitter``, ``random_noise_01`` and
  ``random_erasing`` (JAX ``augment.py:349-420``);
* the helpers: separable ``gaussian_blur`` and ``box_blur`` with edge
  padding and a per-image truncation of their taps (a depthwise
  ``F.conv2d`` an axis), the affine warps on ``ops.warp.affine_warp``, and
  ``blend``;
* the event stack (``event_noise``, ``event_lines``; ``fill_black``) and the
  SPEED+ stack (``random_haze``, ``random_flares``, ``random_streaks``,
  ``random_bloom``, ``random_stars``), run by ``apply_stack`` in order.

Each function takes its random draws as arguments; ``sample_*`` beside it
draws them. The DA ops draw from a CPU ``torch.Generator`` (one seed, the
same draws on every device). The stacks draw from a generator on the
images' device (``stack_generator``), so their (H, W) fields never cross
the bus: one seed gives other draws on the card than on the CPU.
``jax.random`` cannot be reproduced in PyTorch: the tests feed the JAX
package's own draws to these functions. The blurs' convolutions run in
float32 without TF32 on every device.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.warp import affine_warp

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


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _col(v, like: Tensor, dims: int = 3) -> Tensor:
    """A per-image value (B,) (or a Python number) as a float32 tensor on
    ``like``'s device, shaped (B, 1, ..., 1) with ``dims`` ones."""
    v = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return v.reshape(v.shape + (1,) * dims) if v.dim() else v


def _no_tf32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                       allow_tf32=False)


def _taps(kernel_size: int, b: int, device) -> Tensor:
    r = kernel_size // 2
    return torch.arange(-r, r + 1, dtype=torch.float32, device=device).expand(b, -1)


def _trunc_mask(x: Tensor, trunc_ksize) -> Tensor:
    """Taps within (trunc_ksize - 1) / 2 of the centre, per image."""
    half = (_col(trunc_ksize, x, 1) - 1.0) / torch.tensor(2.0, device=x.device)
    return (x.abs() <= half).to(torch.float32)


def _separable(img: Tensor, w: Tensor) -> Tensor:
    """Correlate each (H, W) plane of (B, H, W, C) ``img`` with the (B, K)
    taps ``w`` over H, then over W, edge-padded, as the JAX helpers' gather."""
    b, h, wd, c = img.shape
    k = w.shape[1]
    r = k // 2
    x = img.permute(0, 3, 1, 2).reshape(1, b * c, h, wd)
    taps = w.repeat_interleave(c, dim=0)  # (B * C, K)
    with _no_tf32():
        x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), taps.view(b * c, 1, k, 1), groups=b * c)
        x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), taps.view(b * c, 1, 1, k), groups=b * c)
    return x.reshape(b, c, h, wd).permute(0, 2, 3, 1)


def gaussian_blur(img: Tensor, sigma, kernel_size: int, trunc_ksize=None) -> Tensor:
    """Separable Gaussian blur of (B, H, W, C) images with a per-image
    ``sigma`` (B,) (or one number) over a static support of ``kernel_size``
    taps; ``trunc_ksize`` (B,) zeroes the taps beyond (trunc_ksize - 1) / 2,
    cv2.GaussianBlur's ksize under a static maximum. Weights normalised to
    sum 1; edges padded by replication."""
    b = img.shape[0]
    x = _taps(kernel_size, b, img.device)
    s = torch.clamp(_col(sigma, img, 1), min=1e-3).expand(b, 1)
    w = torch.exp(-0.5 * (x / s) ** 2)
    if trunc_ksize is not None:
        w = w * _trunc_mask(x, trunc_ksize)
    return _separable(img, w / w.sum(dim=1, keepdim=True))


def box_blur(img: Tensor, kernel_size: int, trunc_ksize=None) -> Tensor:
    """Separable box blur: ``kernel_size`` equal taps, or with
    ``trunc_ksize`` (B,) the ones within (trunc_ksize - 1) / 2 of the
    centre (cv2.blur with a random ksize under a static maximum)."""
    b = img.shape[0]
    if trunc_ksize is None:
        w = torch.full((b, kernel_size), 1.0, device=img.device) / torch.tensor(float(kernel_size), device=img.device)
    else:
        inside = _trunc_mask(_taps(kernel_size, b, img.device), trunc_ksize)
        w = inside / inside.sum(dim=1, keepdim=True)
    return _separable(img, w)


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """a * b + c rounded once to float32 (the float64 product of two float32
    values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _cos(x: Tensor) -> Tensor:
    """cos of float32 ``x`` rounded once from float64: the same on every
    device (the float32 cos of the CPU and of CUDA differ in the last bit,
    and a hexagon's edge or a warp's coordinates then move)."""
    return torch.cos(x.double()).float()


def _sin(x: Tensor) -> Tensor:
    return torch.sin(x.double()).float()


def _inverse_affine(M: Tensor) -> Tensor:
    """(B, 2, 3) inverse of the forward (B, 2+, 3) affine maps, rounded as
    the JAX package's ``jnp.linalg.inv`` and ``-A_inv @ b`` round on the
    CPU: LU with partial pivoting by reciprocal multiplies, the back
    substitution's update and the matrix-vector product's second term fused.
    A warp is continuous in its coordinates except where a tap leaves the
    frame: there a coordinate an ulp off moves the output by up to 255 grey
    times that ulp."""
    a, b, c, d = M[:, 0, 0], M[:, 0, 1], M[:, 1, 0], M[:, 1, 1]
    swap = c.abs() > a.abs()
    a, b, c, d = torch.where(swap, c, a), torch.where(swap, d, b), torch.where(swap, a, c), torch.where(swap, b, d)
    one = torch.ones_like(a)
    ra = one / a
    lo = c * ra
    ru = one / (d - lo * b)
    e0 = torch.stack([~swap, swap], -1).to(torch.float32)  # row 0 of P I
    x1 = (e0.flip(-1) - lo[:, None] * e0) * ru[:, None]  # (B, 2): row 1 of A^-1
    x0 = _fma(-b[:, None], x1, e0) * ra[:, None]
    A_inv = torch.stack([x0, x1], 1)  # (B, 2, 2)
    t0 = (-A_inv[:, :, 0]) * M[:, None, 0, 2]
    shift = _fma(-A_inv[:, :, 1], M[:, None, 1, 2].expand_as(t0), t0)
    return torch.cat([A_inv, shift[..., None]], dim=2)


def _warp_matrix(img: Tensor, M: Tensor) -> Tensor:
    """Warp (B, H, W, C) by the forward (B, 2, 3) matrices, source ->
    destination, bilinear with a zero border."""
    return affine_warp(img, _inverse_affine(M), (img.shape[2], img.shape[1]))


def _affine(a00, a01, a10, a11, b0, b1) -> Tensor:
    """(B, 2, 3) from (B,) entries."""
    return torch.stack([torch.stack([a00, a01, b0], -1), torch.stack([a10, a11, b1], -1)], -2)


def scale_warp(img: Tensor, sx, sy) -> Tensor:
    b = img.shape[0]
    sx, sy = (_col(v, img, 0).expand(b) for v in (sx, sy))
    zero = torch.zeros_like(sx)
    return _warp_matrix(img, _affine(sx, zero, zero, sy, zero, zero))


def shear_warp(img: Tensor, shear) -> Tensor:
    b = img.shape[0]
    shear = _col(shear, img, 0).expand(b)
    one, zero = torch.ones_like(shear), torch.zeros_like(shear)
    return _warp_matrix(img, _affine(one, shear, zero, one, zero, zero))


def rotate_about_center(img: Tensor, angle_deg) -> Tensor:
    """Rotate by ``angle_deg`` (B,) about the image centre, counter-clockwise
    for a positive angle (cv2.getRotationMatrix2D)."""
    b, h, w = img.shape[:3]
    t = _col(angle_deg, img, 0).expand(b) * torch.tensor(math.pi / 180.0, device=img.device)
    cs, sn = _cos(t), _sin(t)
    cx, cy = w / 2.0, h / 2.0
    return _warp_matrix(img, _affine(cs, sn, -sn, cs, (1 - cs) * cx - sn * cy, sn * cx + (1 - cs) * cy))


def blend(img: Tensor, src: Tensor, src_weight, dst_weight=1.0) -> Tensor:
    return torch.clamp(_col(src_weight, img) * src + dst_weight * img, 0.0, 255.0)


def _linspace(start: float, stop: float, n: int, device) -> Tensor:
    """``jnp.linspace`` as XLA computes it on the CPU: with r = 1 / (n - 1)
    in float32, start * (1 - i r) + i (stop r), the last product fused into
    the sum; the last entry ``stop``. Equal to JAX's at the tests' 96 and
    128 entries; XLA's vectorised loop rounds some entries of longer ones
    another way (1 ulp)."""
    i = torch.arange(n - 1, dtype=torch.float32, device=device)
    r = torch.ones((), device=device) / torch.tensor(float(n - 1), device=device)
    out = _fma(i, stop * r, start * (1 - i * r))
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def _uniform(gen: torch.Generator, shape, lo, hi) -> Tensor:
    """U(lo, hi) as ``jax.random.uniform`` spreads it: max(lo, lo + (hi - lo) u)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    lo, hi = torch.as_tensor(lo, dtype=torch.float32, device=gen.device), torch.as_tensor(hi, device=gen.device)
    return torch.maximum(lo, lo + (hi - lo) * u)


def _randint(gen: torch.Generator, shape, lo: int, hi: int) -> Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


# ---------------------------------------------------------------------------
# the event stack
# ---------------------------------------------------------------------------


def sample_event_noise(gen: torch.Generator, b: int, h: int, w: int) -> dict[str, Tensor]:
    """``t`` (B,) U(0.001, 0.05), ``u`` (B, H, W) U(0, 1), ``apply`` (B,) U(0, 1)."""
    return {"t": _uniform(gen, (b,), 0.001, 0.05), "u": torch.rand((b, h, w), generator=gen, device=gen.device),
            "apply": torch.rand((b,), generator=gen, device=gen.device)}


def event_noise(img: Tensor, draws: dict, apply_prob: float = 0.7) -> Tensor:
    """Salt noise: a ``t`` fraction of the pixels (those whose ``u`` < t)
    turned white, in the images whose ``apply`` < ``apply_prob``."""
    mask = draws["u"].to(img.device) < _col(draws["t"], img, 2)
    noised = torch.where(mask[..., None], 255.0, img)
    return torch.where(_col(draws["apply"], img) < apply_prob, noised, img)


def fill_black(img: Tensor) -> Tensor:
    """Near-black pixels (every channel <= 100) -> mid grey 127."""
    black = torch.all(img <= 100.0, dim=-1, keepdim=True)
    return torch.where(black, 127.0, img)


EVENT_LINES = 3  # lines an image


def sample_event_lines(gen: torch.Generator, b: int, h: int, w: int, x_jitter: float = 5.0,
                       max_points: int = 2048) -> dict[str, Tensor]:
    """Per image ``skip_all`` (B,); per line (B, 3) ``skip``, ``x_shift``
    U(-200, 200), ``x1`` U(x_shift, w - x_shift), ``density`` in [100,
    10000); per dot (B, 3, max_points) ``jx`` U(-x_jitter, x_jitter) and
    ``jy`` U(-100 + x_shift / 2, 100 - x_shift / 2)."""
    n = (b, EVENT_LINES)
    skip_all, skip = torch.rand((b,), generator=gen, device=gen.device), torch.rand(n, generator=gen, device=gen.device)
    x_shift = _uniform(gen, n, -200.0, 200.0)
    x1 = _uniform(gen, n, x_shift, w - x_shift)
    density = _randint(gen, n, 100, 10000)
    jx = _uniform(gen, n + (max_points,), -x_jitter, x_jitter)
    half = (x_shift / 2)[..., None]
    jy = _uniform(gen, n + (max_points,), -100 + half, 100 - half)
    return {"skip_all": skip_all, "skip": skip, "x_shift": x_shift, "x1": x1, "density": density, "jx": jx, "jy": jy}


def event_lines(img: Tensor, draws: dict, max_points: int = 2048) -> Tensor:
    """Up to 3 noisy white dot lines an image (transforms.py:158-211), JAX's
    static-shape form: each line spans the full height from ``x1`` to
    ``x1 + x_shift``; min(density, max_points) evenly spaced of its
    ``max_points`` jittered dots are white. Drawn as a scatter-max of 255
    on the flattened pixels (order-free, so exact); a line whose ``skip`` <
    0.3 is not drawn, nor any in an image whose ``skip_all`` < 0.3."""
    b, h, w, c = img.shape
    dev = img.device
    d = {k: v.to(dev) for k, v in draws.items()}
    x_shift, x1 = d["x_shift"][..., None], d["x1"][..., None]  # (B, 3, 1)
    tt = _linspace(0.0, 1.0, max_points, dev)
    xs = x1 + tt * x_shift
    m = torch.tensor(float(h), device=dev) / torch.where(x_shift.abs() > 1e-3, x_shift, 1e-3)
    ys = m * (xs - x1)
    xs = xs + d["jx"]
    ys = ys + d["jy"]
    density = d["density"][..., None]
    marks = torch.floor(torch.arange(max_points, device=dev).to(torch.float32)
                        * (density.to(torch.float32) / torch.tensor(float(max_points), device=dev)))
    first = torch.ones(marks.shape[:-1] + (1,), dtype=torch.bool, device=dev)
    active = torch.cat([first, marks[..., 1:] != marks[..., :-1]], dim=-1) | (density >= max_points)
    active = active & (d["skip"] >= 0.3)[..., None]
    xi = torch.clamp(torch.floor(xs), 0, w - 1).to(torch.int64)
    yi = torch.clamp(torch.floor(ys), 0, h - 1).to(torch.int64)
    flat = (torch.arange(b, device=dev)[:, None, None] * (h * w) + yi * w + xi).reshape(-1)
    white = torch.where(active, 255.0, 0.0).reshape(-1)
    out = img.reshape(b * h * w, c).scatter_reduce(
        0, flat[:, None].expand(-1, c), white[:, None].expand(-1, c), "amax", include_self=True)
    return torch.where(_col(d["skip_all"], img) < 0.3, img, out.reshape(b, h, w, c))


# ---------------------------------------------------------------------------
# the SPEED+ stack
# ---------------------------------------------------------------------------


def _noise_draws(gen: torch.Generator, b: int, h: int, w: int) -> dict[str, Tensor]:
    return {"std": _uniform(gen, (b,), 0.03, 0.05), "mean": _uniform(gen, (b,), 0.05, 0.15),
            "noise": torch.randn((b, h, w, 1), generator=gen, device=gen.device)}


def noise_field(like: Tensor, draws: dict) -> Tensor:
    """(B, H, W, 1): (255 std)(255 noise) + 255 mean, clipped to [0, 255];
    one value a pixel for every channel (the stacks broadcast it last)."""
    noise = draws["noise"].to(like.device)
    return torch.clamp((255.0 * _col(draws["std"], like)) * (255.0 * noise) + 255.0 * _col(draws["mean"], like),
                       0.0, 255.0)


def _channels(field: Tensor, img: Tensor) -> Tensor:
    return field.expand(-1, -1, -1, img.shape[-1])


def sample_random_stars(gen: torch.Generator, b: int, h: int, w: int) -> dict[str, Tensor]:
    """The noise field's draws, ``sigma2`` (B,) U(1.5, 2) and ``apply`` (B,) in {0, 1}."""
    return _noise_draws(gen, b, h, w) | {"sigma2": _uniform(gen, (b,), 1.5, 2.0), "apply": _randint(gen, (b,), 0, 2)}


def star_field(img: Tensor, draws: dict) -> Tensor:
    """The stars' field before its threshold: the noise field blurred, sigma 3.5 over 21 taps."""
    return gaussian_blur(noise_field(img, draws), 3.5, 21)


def random_stars(img: Tensor, draws: dict) -> Tensor:
    """A star field: the noise field blurred, the pixels under 160 zeroed,
    blurred again by ``sigma2`` (13 taps), added where ``apply`` is 1."""
    field = star_field(img, draws)
    field = gaussian_blur(torch.where(field < 160.0, 0.0, field), draws["sigma2"], 13)
    return torch.where(_col(draws["apply"], img) == 1, blend(img, _channels(field, img), 1.0), img)


def sample_random_haze(gen: torch.Generator, b: int, h: int, w: int) -> dict[str, Tensor]:
    """The noise field's draws, ``thresh`` (B,) in [125, 140), ``sigma`` U(25, 40), ``weight`` U(0.1, 0.8)."""
    return _noise_draws(gen, b, h, w) | {"thresh": _randint(gen, (b,), 125, 140),
                                         "sigma": _uniform(gen, (b,), 25.0, 40.0),
                                         "weight": _uniform(gen, (b,), 0.1, 0.8)}


def haze_field(img: Tensor, draws: dict) -> Tensor:
    """The haze's field before its threshold: the noise field blurred, sigma 5 over 31 taps."""
    return gaussian_blur(noise_field(img, draws), 5.0, 31)


def random_haze(img: Tensor, draws: dict) -> Tensor:
    """A cloud: the noise field blurred, the pixels under ``thresh`` zeroed,
    stretched 1.5 x 1.8 (the reference's ``_scale_image`` ignores its
    arguments: transforms.py:236-240), blurred by ``sigma`` over 121 taps,
    blended at ``weight``."""
    field = haze_field(img, draws)
    field = torch.where(field < _col(draws["thresh"], img), 0.0, field)
    field = gaussian_blur(scale_warp(field, 1.5, 1.8), draws["sigma"], 121)
    return blend(img, _channels(field, img), draws["weight"])


def _hexagon_mask(h: int, w: int, cx: Tensor, cy: Tensor, radius: Tensor) -> Tensor:
    """(B, H, W) filled regular hexagons: inside every edge's half-plane."""
    dev = cx.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] - cy[:, None, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] - cx[:, None, None]
    angles = torch.arange(6, dtype=torch.float32, device=dev) * torch.tensor(math.pi / 3.0, device=dev)
    nx, ny = _cos(angles)[:, None, None, None], _sin(angles)[:, None, None, None]
    apothem = radius * _cos(torch.tensor(math.pi / 6.0, device=dev))
    return torch.all(xs * nx + ys * ny <= apothem[:, None, None], dim=0)


MAX_FLARES = 9


def sample_random_flares(gen: torch.Generator, b: int, h: int, w: int,
                         max_flares: int = MAX_FLARES) -> dict[str, Tensor]:
    """``n`` (B,) flares in [1, max_flares]; per flare (B, max_flares): the
    centre ``cx`` in [w//2 - 500, w//2 + 500) and ``cy`` in [h//2 - 400,
    h//2 + 400) (either may fall off the frame), ``radius`` [5, 100),
    ``angle`` [0, 180) degrees, ``shear`` U(0, 0.75), ``sigma`` U(1, 5),
    ``gain`` U(0.4, 1.2); ``weight`` (B,) U(0, 1)."""
    f = (b, max_flares)
    return {"n": _randint(gen, (b,), 1, max_flares + 1),
            "cx": _randint(gen, f, w // 2 - 500, w // 2 + 500), "cy": _randint(gen, f, h // 2 - 400, h // 2 + 400),
            "radius": _randint(gen, f, 5, 100), "angle": _randint(gen, f, 0, 180),
            "shear": _uniform(gen, f, 0.0, 0.75), "sigma": _uniform(gen, f, 1.0, 5.0),
            "gain": _uniform(gen, f, 0.4, 1.2), "weight": _uniform(gen, (b,), 0.0, 1.0)}


def random_flares(img: Tensor, draws: dict) -> Tensor:
    """``n`` flares on one canvas, each a white hexagon drawn on it, then the
    canvas rotated, sheared, blurred (31 taps) and scaled by the flare's
    gain; the canvas blended at ``weight``. Flare ``i`` runs only on the
    images with ``n > i`` (one read of ``n`` to the host), as JAX's
    ``lax.cond`` skips it on one image."""
    b, h, w = img.shape[:3]
    d = {k: v.to(img.device) for k, v in draws.items()}
    n = d["n"].tolist()
    canvas = torch.zeros((b, h, w, 1), dtype=torch.float32, device=img.device)
    for i in range(max(n)):
        rows = torch.tensor([j for j in range(b) if n[j] > i], device=img.device)
        f = lambda k: d[k][rows, i].to(torch.float32)  # noqa: E731
        drawn = torch.where(_hexagon_mask(h, w, f("cx"), f("cy"), f("radius"))[..., None], 255.0, canvas[rows])
        drawn = shear_warp(rotate_about_center(drawn, f("angle")), f("shear"))
        canvas[rows] = gaussian_blur(drawn, f("sigma"), 31) * _col(f("gain"), img)
    return blend(img, _channels(canvas, img), d["weight"])


def radial_blur(img: Tensor, amount, cx, cy, iterations: int = 5) -> Tensor:
    """Radial blur about (cx, cy) (B,): ``iterations`` times, the mean of
    the image sampled at the grown and at the shrunk coordinates |x ± (x -
    cx) amount| (bilinear, edge taps clamped, zero off the frame;
    transforms.py:367-382)."""
    b, h, w = img.shape[:3]
    dev = img.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    amount, cx, cy = (_col(v, img, 2) for v in (amount, cx, cy))
    bi = torch.arange(b, device=dev)[:, None, None]

    def sample(im, sx, sy):
        x0f, y0f = torch.floor(sx), torch.floor(sy)
        fx, fy = (sx - x0f)[..., None], (sy - y0f)[..., None]
        x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
        x0c, y0c = x0.clamp(0, w - 1), y0.clamp(0, h - 1)
        x1c, y1c = (x0 + 1).clamp(0, w - 1), (y0 + 1).clamp(0, h - 1)
        inb = ((sx >= 0) & (sx < w) & (sy >= 0) & (sy < h))[..., None]
        v = (im[bi, y0c, x0c] * (1 - fx) * (1 - fy) + im[bi, y0c, x1c] * fx * (1 - fy)
             + im[bi, y1c, x0c] * (1 - fx) * fy + im[bi, y1c, x1c] * fx * fy)
        return v * inb

    gx, sx_ = torch.abs(xs + (xs - cx) * amount), torch.abs(xs - (xs - cx) * amount)
    gy, sy_ = torch.abs(ys + (ys - cy) * amount), torch.abs(ys - (ys - cy) * amount)
    gx, sx_ = gx.expand(b, h, w), sx_.expand(b, h, w)
    gy, sy_ = gy.expand(b, h, w), sy_.expand(b, h, w)
    for _ in range(iterations):
        img = 0.5 * sample(img, gx, gy) + 0.5 * sample(img, sx_, sy_)
    return img


def radial_fade(img: Tensor) -> Tensor:
    """Fade to black with the distance from the centre (255 at the corners'
    diagonal, in [-255, 255] coordinates)."""
    h, w = img.shape[1], img.shape[2]
    ys = _linspace(-1.0, 1.0, h, img.device)[:, None] * 255.0
    xs = _linspace(-1.0, 1.0, w, img.device)[None, :] * 255.0
    # the square root in float64, rounded once: PyTorch's float32 sqrt on the CPU is
    # not correctly rounded (~0.7% of inputs an ulp off), JAX's is
    dist = torch.sqrt((ys ** 2 + xs ** 2).double()).float()
    alpha = 255.0 - torch.clamp(dist, 0.0, 255.0)
    return img * (alpha / torch.tensor(255.0, device=img.device))[None, :, :, None]


def sample_random_streaks(gen: torch.Generator, b: int, h: int, w: int) -> dict[str, Tensor]:
    """The noise field's draws; (B,) ``thresh`` in [150, 200), ``amount``
    U(0.01, 0.04), the blur's centre ``cx`` in [0, w), ``cy`` in [0, h),
    ``horizontal`` in {0, 1}, ``stretch`` U(2, 4), ``angle`` U(0, pi) (in
    degrees, as the reference draws it), ``weight`` U(0, 1)."""
    return _noise_draws(gen, b, h, w) | {
        "thresh": _randint(gen, (b,), 150, 200), "amount": _uniform(gen, (b,), 0.01, 0.04),
        "cx": _randint(gen, (b,), 0, w), "cy": _randint(gen, (b,), 0, h), "horizontal": _randint(gen, (b,), 0, 2),
        "stretch": _uniform(gen, (b,), 2.0, 4.0), "angle": _uniform(gen, (b,), 0.0, math.pi),
        "weight": _uniform(gen, (b,), 0.0, 1.0)}


def streak_field(img: Tensor, draws: dict) -> Tensor:
    """The streaks' field before its threshold: the noise field blurred, sigma 1 over 7 taps."""
    return gaussian_blur(noise_field(img, draws), 1.0, 7)


def random_streaks(img: Tensor, draws: dict) -> Tensor:
    """Streaks (transforms.py:320-422): the noise field blurred, the pixels
    under ``thresh`` zeroed, radially blurred about (cx, cy), faded,
    stretched by ``stretch`` along x (``horizontal``) or y, rotated by
    ``angle`` degrees, blended at ``weight``."""
    d = {k: v.to(img.device) for k, v in draws.items()}
    field = streak_field(img, d)
    field = torch.where(field < _col(d["thresh"], img), 0.0, field)
    field = radial_fade(radial_blur(field, d["amount"], d["cx"], d["cy"]))
    one = torch.ones_like(d["stretch"])
    horizontal = d["horizontal"] == 1
    field = scale_warp(field, torch.where(horizontal, d["stretch"], one), torch.where(horizontal, one, d["stretch"]))
    field = rotate_about_center(field, d["angle"])
    return blend(img, _channels(field, img), d["weight"])


def sample_random_bloom(gen: torch.Generator, b: int, h: int, w: int) -> dict[str, Tensor]:
    """``offset`` (B,) in [10, 100), before the odd -> even step."""
    return {"offset": _randint(gen, (b,), 10, 100)}


def random_bloom(img: Tensor, draws: dict) -> Tensor:
    """Additive glow (transforms.py:424-450): ``offset`` rounded up to even,
    a Gaussian of sigma 10 truncated to 9 + offset taps (of 109), then a box
    of 5 + offset taps (of 105), added to the image."""
    offset = draws["offset"].to(img.device)
    offset = offset + offset % 2
    bloom = box_blur(gaussian_blur(img, 10.0, 109, trunc_ksize=9 + offset), 105, trunc_ksize=5 + offset)
    return blend(img, bloom, 1.0)


# ---------------------------------------------------------------------------
# stacks (the per-domain pipelines of train_da_ms.py:145-166)
# ---------------------------------------------------------------------------

EVENT_STACK = ("event_noise", "event_lines")
SPEEDPLUS_STACK = ("random_haze", "random_flares", "random_streaks", "random_bloom", "random_stars")


def _sample_erasing_on(gen: torch.Generator, b: int, h: int, w: int) -> dict[str, Tensor]:
    frac = _uniform(gen, (b, 2), 0.05, 0.3)
    eh, ew = (frac * torch.tensor([h, w], dtype=torch.float32, device=gen.device)).to(torch.int64).unbind(-1)
    return {"rects": torch.stack([eh, ew, _randint(gen, (b,), 0, h), _randint(gen, (b,), 0, w)], dim=-1)}


# name -> (function of (images, draws), sampler of (generator, b, h, w))
_REGISTRY: dict[str, tuple[Callable, Callable]] = {
    "event_noise": (event_noise, sample_event_noise),
    "event_lines": (event_lines, sample_event_lines),
    "fill_black": (lambda img, draws: fill_black(img), lambda gen, b, h, w: {}),
    "random_stars": (random_stars, sample_random_stars),
    "random_haze": (random_haze, sample_random_haze),
    "random_flares": (random_flares, sample_random_flares),
    "random_streaks": (random_streaks, sample_random_streaks),
    "random_bloom": (random_bloom, sample_random_bloom),
    "random_erasing": (lambda img, draws: random_erasing(img, draws["rects"]), _sample_erasing_on),
}


def stack_generator(base_seed: int, step: int, device) -> torch.Generator:
    """The stacks' draws of update ``step``: a generator on ``device`` seeded
    from (``base_seed``, ``step``, 1) (the JAX trainer folds the step, then 1,
    into its key)."""
    seed = int(np.random.SeedSequence((base_seed, step, 1)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def sample_stack(gen: torch.Generator, b: int, h: int, w: int, names: Sequence[str] = EVENT_STACK) -> list[dict]:
    """Each stage's draws for a batch of (B, H, W, C) images, on ``gen``'s device."""
    return [_REGISTRY[name][1](gen, b, h, w) for name in names]


def apply_stack(img: Tensor, names: Sequence[str], draws: Sequence[dict]) -> Tensor:
    """The stages ``names`` in order on (B, H, W, C) float32 images, with
    ``draws`` (one dict a stage, from :func:`sample_stack`)."""
    for name, d in zip(names, draws, strict=True):
        img = _REGISTRY[name][0](img, d)
    return img
