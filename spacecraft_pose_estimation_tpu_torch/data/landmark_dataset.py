"""The landmark stage's data: the example table, its batch streams and the training transform.

Port of the JAX package's ``data/landmark_dataset.py`` (the reference's
``lib/dataset/JointsDataset.py:121-229``), split as there:

* host: COCO json -> :class:`LandmarkExamples`, whose frames come from
  files, read with OpenCV, or from a mapping of frames already in memory
  (how a machine without OpenCV, the card's, hands them over); shuffled
  batches (:func:`batch_iterator`, decoded on a thread pool) or their
  index stream alone (:func:`index_iterator`) for
  :class:`DeviceDatasetCache`, which keeps every uint8 frame on the device;
* device: :func:`device_transform`, the random scale and rotation, the
  rotated crop, ImageNet normalization and the Gaussian targets.

The random draws are the port's own: ``jax.random`` cannot be reproduced
in PyTorch. They come from an explicit CPU ``torch.Generator`` (so one seed
gives the same draws on every device), or are handed in (``draws``), which
is how the tests feed the JAX package's draws to the port.
"""

from __future__ import annotations

import os
from typing import Iterator, Mapping

import numpy as np
import torch

from ..ops import geometry, heatmap, warp
from ..pipeline import normalize_crops
from . import coco_io
from .loader import parallel_batches

Tensor = torch.Tensor


def read_bgr(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 BGR, read with OpenCV (imported here only)."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("reading frames from image files needs OpenCV (cv2), which is not installed; "
                           "hand the frames over in memory (frames=)") from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img


class LandmarkExamples:
    """COCO json -> one example per annotation, in the json's order.

    ``image_dir``: the frames are the files named by the json there, read as
    BGR with ``cv2.imread`` (cv2 is imported only then). ``frames``: a
    mapping of file name -> (H, W, 3) uint8 BGR frame (a numpy array or a
    tensor on any device), used in place of the files. A frame comes out
    as uint8, RGB unless ``color_rgb`` is False; the JAX copy casts it to
    float32, which holds the integers exactly.
    """

    def __init__(self, coco_json: str, image_dir: str | None = None, frames: Mapping | None = None):
        if (image_dir is None) == (frames is None):
            raise ValueError("LandmarkExamples takes the frames from image_dir or from frames, one of them")
        self.records = coco_io.coco_to_examples(coco_io.load_coco(coco_json))
        self.image_dir, self.frames = image_dir, frames
        self.num_joints = self.records[0]["joints"].shape[0]

    def __len__(self) -> int:
        return len(self.records)

    def load_image(self, i: int, color_rgb: bool = True):
        name = self.records[i]["file_name"]
        if self.frames is not None:
            img = self.frames[name]
            if not color_rgb:
                return img
            return img.flip(-1) if hasattr(img, "flip") else np.ascontiguousarray(img[..., ::-1])
        img = read_bgr(os.path.join(self.image_dir, name))
        return np.ascontiguousarray(img[..., ::-1]) if color_rgb else img

    def example(self, i: int, color_rgb: bool = True) -> dict:
        rec = self.records[i]
        return {
            "image": self.load_image(i, color_rgb),
            "bbox": rec["bbox"].astype(np.float32),
            "joints": rec["joints"].astype(np.float32),
            "joints_vis": rec["joints_vis"].astype(np.float32),
            "image_id": rec["image_id"],
        }


def _stack(items: list):
    return torch.stack(items) if isinstance(items[0], torch.Tensor) else np.stack(items)


def batch_iterator(examples: LandmarkExamples, batch_size: int, shuffle: bool = True, seed: int = 0,
                   loop: bool = True, prefetch: int = 4, num_workers: int | None = None,
                   start: int = 0) -> Iterator[dict]:
    """Shuffled batches of whole examples (uint8 ``image``, ``bbox``,
    ``joints``, ``joints_vis``, ``image_id``), decoded on a thread pool with
    ``prefetch`` batches in flight; endless unless ``loop`` is False. The
    order is :func:`index_iterator`'s, from its batch ``start`` on."""

    def index_gen():
        for idx in index_iterator(len(examples), batch_size, shuffle, seed, loop, start):
            yield None, [int(i) for i in idx]

    def collate(_meta, exs):
        out = {k: _stack([e[k] for e in exs]) for k in ("image", "bbox", "joints", "joints_vis")}
        out["image_id"] = np.array([e["image_id"] for e in exs])
        return out

    yield from parallel_batches(index_gen(), examples.example, collate, num_workers=num_workers,
                                prefetch_batches=prefetch)


def index_iterator(n: int, batch_size: int, shuffle: bool = True, seed: int = 0,
                   loop: bool = True, start: int = 0) -> Iterator[np.ndarray]:
    """Batches of example indices: a ``np.random.default_rng(seed)``
    permutation per pass, cut into whole batches (the tail dropped), the
    JAX package's stream index for index. ``start`` skips that many batches
    first: a resumed run passes its step count and goes on where the
    interrupted one stopped (the JAX trainer starts the stream over)."""
    rng = np.random.default_rng(seed)
    skip = start
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for first in range(0, n - batch_size + 1, batch_size):
            if skip:
                skip -= 1
                continue
            yield order[first:first + batch_size]
        if not loop:
            return


class DeviceDatasetCache:
    """Every example on ``device``: the uint8 frames (N, H, W, 3), uploaded
    once, and the boxes and joints; a batch is gathered by index, so no
    frame crosses to the device per step. The same numbers as the host
    path: the crop reads uint8 and interpolates in float32."""

    def __init__(self, examples: LandmarkExamples, device):
        device = torch.device(device)
        self.images = torch.stack([torch.as_tensor(examples.load_image(i)).to(device)
                                   for i in range(len(examples))])
        self.nbytes = self.images.numel() * self.images.element_size()

        def table(key):
            return torch.from_numpy(np.stack([r[key] for r in examples.records]).astype(np.float32)).to(device)

        self.bboxes, self.joints, self.joints_vis = table("bbox"), table("joints"), table("joints_vis")

    def gather(self, idx) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        """(images, bboxes, joints, joints_vis) of the examples ``idx``."""
        i = torch.as_tensor(np.asarray(idx, np.int64)).to(self.images.device)
        return self.images[i], self.bboxes[i], self.joints[i], self.joints_vis[i]


def sample_augmentation(generator: torch.Generator, batch: int, scale_factor: float, rot_factor: float,
                        rot_prob: float = 0.6) -> tuple[Tensor, Tensor]:
    """Per-example scale multiplier and rotation in degrees, the reference's
    distributions (``JointsDataset.py:158-170``): scale ~ clip(N(1, sf),
    1 - sf, 1 + sf); rotation ~ clip(N(0, rf), -2 rf, 2 rf) with
    probability ``rot_prob``, else 0. CPU float32 tensors."""
    s = torch.randn(batch, generator=generator) * scale_factor + 1.0
    s = s.clamp(1.0 - scale_factor, 1.0 + scale_factor)
    r = (torch.randn(batch, generator=generator) * rot_factor).clamp(-2 * rot_factor, 2 * rot_factor)
    r = torch.where(torch.rand(batch, generator=generator) <= rot_prob, r, 0.0)
    return s, r


def half_body_center_scale(joints: Tensor, joints_vis: Tensor, coins: Tensor, upper_mask: Tensor,
                           aspect_ratio: float, pixel_std: float = 200.0) -> tuple[Tensor, Tensor, Tensor]:
    """The half-body crop (``JointsDataset.py:73-118``) of each example:
    ``joints`` (B, J, 2), ``joints_vis`` (B, J), ``coins`` (B,) normal draws,
    ``upper_mask`` (J,). The upper set of visible joints is taken when
    ``coin < 0.5`` and it has more than 2, or when the lower set has at most
    2; fewer than 2 selected joints is invalid. Center: the selected joints'
    mean; scale: their extent, aspect-corrected, / 200, x 1.5. Returns
    (valid (B,), centers (B, 2), scales (B, 2))."""
    vis = joints_vis > 0
    up_sel = vis & (upper_mask > 0)
    lo_sel = vis & (upper_mask <= 0)
    use_upper = ((coins < 0.5) & (up_sel.sum(1) > 2)) | (lo_sel.sum(1) <= 2)
    sel = torch.where(use_upper[:, None], up_sel, lo_sel)
    n_sel = sel.sum(1)
    center = (joints * sel.float()[..., None]).sum(1) / n_sel.float().clamp(min=1.0)[:, None]
    lt = torch.where(sel[..., None], joints, 1e9).amin(1)
    rb = torch.where(sel[..., None], joints, -1e9).amax(1)
    w, h = rb[:, 0] - lt[:, 0], rb[:, 1] - lt[:, 1]
    h = torch.where(w > aspect_ratio * h, w / aspect_ratio, h)
    w = torch.where(w < aspect_ratio * h, h * aspect_ratio, w)
    return n_sel >= 2, center, torch.stack([w, h], dim=-1) / pixel_std * 1.5


def apply_half_body(joints: Tensor, joints_vis: Tensor, centers: Tensor, scales: Tensor,
                    upper_body_ids: tuple[int, ...], aspect_ratio: float, num_joints_half_body: int,
                    prob_half_body: float, uniforms: Tensor, coins: Tensor) -> tuple[Tensor, Tensor]:
    """Replace an example's crop by its half-body crop where more than
    ``num_joints_half_body`` joints are visible, its uniform draw is below
    ``prob_half_body`` and the half-body crop is valid (``JointsDataset.py:155-162``)."""
    upper_mask = torch.zeros(joints.shape[1], device=joints.device)
    upper_mask[list(upper_body_ids)] = 1.0
    gate = ((joints_vis > 0).sum(1) > num_joints_half_body) & (uniforms < prob_half_body)
    valid, hb_c, hb_s = half_body_center_scale(joints, joints_vis, coins, upper_mask, aspect_ratio)
    use = (gate & valid)[:, None]
    return torch.where(use, hb_c, centers), torch.where(use, hb_s, scales)


def sample_draws(generator: torch.Generator, batch: int, scale_factor: float, rot_factor: float,
                 half_body: bool) -> dict[str, Tensor]:
    """Every random draw of one :func:`device_transform` call, in a fixed
    order: the half-body gates and coins (when ``half_body``), then the
    scale multipliers and rotations."""
    draws = {}
    if half_body:  # the gates' uniform draws, and the reference's normal coins
        draws["hb_uniform"] = torch.rand(batch, generator=generator)
        draws["hb_coin"] = torch.randn(batch, generator=generator)
    draws["s_mult"], draws["rots"] = sample_augmentation(generator, batch, scale_factor, rot_factor)
    return draws


def device_transform(images: Tensor, bboxes: Tensor, joints: Tensor, joints_vis: Tensor,
                     generator: torch.Generator | None = None, image_size: tuple[int, int] = (512, 512),
                     heatmap_size: tuple[int, int] = (128, 128), sigma: float = 2.0, train: bool = True,
                     scale_factor: float = 0.25, rot_factor: float = 30.0, upper_body_ids: tuple[int, ...] = (),
                     num_joints_half_body: int = 8, prob_half_body: float = 0.0,
                     draws: Mapping[str, Tensor] | None = None) -> dict[str, Tensor]:
    """Random affine crop, normalization and heatmap targets on the frames' device.

    ``images`` (B, H, W, 3) frames of 0..255 (uint8 or float), ``bboxes``
    (B, 4) xywh, ``joints`` (B, J, 2) frame pixels, ``joints_vis`` (B, J).
    In training the draws come from ``draws`` when given (keys of
    :func:`sample_draws`), else from ``generator``; the half-body crop runs
    only with ``prob_half_body > 0`` and some ``upper_body_ids``, which every
    preset leaves off. Returns ``image`` (normalized crops), ``target``,
    ``target_weight``, ``centers``, ``scales`` and ``rotations``.
    """
    b, dev = images.shape[0], images.device
    centers, scales = geometry.bbox_to_center_scale(bboxes.to(dev, torch.float32))
    joints, joints_vis = joints.to(dev, torch.float32), joints_vis.to(dev, torch.float32)
    if train:
        half_body = prob_half_body > 0.0 and len(upper_body_ids) > 0
        if draws is None:
            draws = sample_draws(generator, b, scale_factor, rot_factor, half_body)
        if half_body:
            centers, scales = apply_half_body(
                joints, joints_vis, centers, scales, upper_body_ids, image_size[0] / image_size[1],
                num_joints_half_body, prob_half_body, draws["hb_uniform"].to(dev), draws["hb_coin"].to(dev))
        scales = scales * draws["s_mult"].to(dev, torch.float32)[:, None]
        rots = draws["rots"].to(dev, torch.float32)
    else:
        rots = torch.zeros(b, device=dev)
    crops = warp.rotated_crop_and_resize(images, centers, scales, rots, image_size)
    joints_crop = geometry.apply_affine(joints, geometry.crop_affine_matrix(centers, scales, rots, image_size))
    target, target_weight = heatmap.generate_target(joints_crop, joints_vis, image_size, heatmap_size, sigma)
    return {"image": normalize_crops(crops), "target": target, "target_weight": target_weight,
            "centers": centers, "scales": scales, "rotations": rots}
