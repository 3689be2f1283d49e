"""The landmark stage's train epoch and validation pass.

Port of the JAX package's ``train/landmark_loop.py`` (the reference's
``lib/core/function.py``). :func:`train_epoch` runs the training transform
and the train step over a batch stream. The validation pass
(``make_validate_step``, ``validate``, ``oks_metrics``) takes batches of a fixed size with the tail
padded by its last example, the full-frame crop of each box (kernel K1,
``ops/warp.crop_and_resize``, the JAX package's exact mode), an optional
flip test, the sub-pixel decode back to frame pixels, and ``pred.mat``.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from ..data import coco_io
from ..data.landmark_dataset import LandmarkExamples, device_transform
from ..ops import geometry, heatmap, warp
from ..pipeline import normalize_crops
from .metrics import MetricStorage

logger = logging.getLogger(__name__)
Tensor = torch.Tensor


def make_validate_step(model, post_process: bool = True, flip_test: bool = False,
                       shift_heatmap: bool = True) -> Callable:
    """Returns fn(images, centers, scales) -> (preds (B, J, 2), maxvals (B, J),
    heatmaps (B, h, w, J)) for normalized (B, H, W, 3) crops.

    The flip test runs the model on the crops flipped in width, flips its
    heatmaps back and, with ``shift_heatmap``, shifts them right by one
    pixel (column 0 repeated, not rolled), then averages them with the
    unflipped heatmaps. Spacecraft landmarks have no left/right pairs to
    swap.
    """

    @torch.inference_mode()
    def step(images: Tensor, centers: Tensor, scales: Tensor):
        hm = model(images)
        if flip_test:
            hm_f = model(images.flip(2)).flip(2)
            if shift_heatmap:
                hm_f = torch.cat([hm_f[:, :, :1], hm_f[:, :, :-1]], dim=2)
            hm = (hm + hm_f) * 0.5
        preds, maxvals = heatmap.decode_heatmaps(hm, centers, scales, post_process)
        return preds, maxvals, hm

    return step


def _device(model) -> torch.device:
    return getattr(model, "device", None) or next(model.parameters()).device


def validate(model, examples: LandmarkExamples, batch_size: int, image_size: tuple[int, int],
             output_path: str | None = None, flip_test: bool = False, post_process: bool = True,
             shift_heatmap: bool = True) -> np.ndarray:
    """The validation pass over ``examples`` in their order -> (N, J, 3)
    [x, y, maxval] float32, written to ``output_path`` as pred.mat when
    given. The frames go to K1 as uint8 on the model's device. The model
    is put in eval mode (its running BN statistics)."""
    model.eval()
    step = make_validate_step(model, post_process, flip_test, shift_heatmap)
    device = _device(model)
    n = len(examples)
    all_preds = np.zeros((n, examples.num_joints, 3), np.float32)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        exs = [examples.example(i) for i in idx]
        exs += [exs[-1]] * (batch_size - len(idx))
        images = torch.stack([torch.as_tensor(e["image"]).to(device) for e in exs])
        bboxes = torch.from_numpy(np.stack([e["bbox"] for e in exs])).to(device)
        centers, scales = geometry.bbox_to_center_scale(bboxes)
        crops = warp.crop_and_resize(images, centers, scales, image_size)
        preds, maxvals, _ = step(normalize_crops(crops), centers, scales)
        all_preds[start:start + len(idx), :, :2] = preds[:len(idx)].cpu().numpy()
        all_preds[start:start + len(idx), :, 2] = maxvals[:len(idx)].cpu().numpy()
    if output_path:
        coco_io.save_pred_mat(all_preds, output_path)
        logger.info("wrote %s", output_path)
    return all_preds


def step_generator(base_seed: int, step: int) -> torch.Generator:
    """The augmentation draws of update ``step``: a CPU generator seeded from
    (``base_seed``, ``step``), so a resumed run draws what an uninterrupted one
    would (the JAX package folds the step into its key)."""
    seed = int(np.random.SeedSequence((base_seed, step)).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


def train_epoch(train_step: Callable, state, data_iter, steps: int, storage: MetricStorage,
                transform_kwargs: dict, base_seed: int, print_freq: int = 20, cache=None):
    """One epoch of ``steps`` updates: a batch from ``data_iter`` (example
    indices into ``cache`` when it is given, else whole batches), the
    training transform on the model's device with the draws of
    :func:`step_generator`, the train step. The metrics stay on the device
    until the epoch's end, then go into ``storage`` step by step."""
    device = _device(state.model)
    step0 = state.step
    collected = []
    for i in range(steps):
        raw = next(data_iter)
        if cache is not None:
            images, bboxes, joints, vis = cache.gather(raw)
        else:
            images, bboxes, joints, vis = (torch.as_tensor(raw[k]).to(device)
                                           for k in ("image", "bbox", "joints", "joints_vis"))
        batch = device_transform(images, bboxes, joints, vis, step_generator(base_seed, step0 + i),
                                 **transform_kwargs)
        collected.append(train_step(state, batch))
    if not collected:
        return state
    names = list(collected[0])
    values = torch.stack([torch.stack([m[k].float() for k in names]) for m in collected]).cpu().tolist()
    for j, row in enumerate(values):
        storage.step = step0 + j + 1
        storage.put_scalars(**dict(zip(names, row)))
        if (j + 1) % print_freq == 0:
            logger.info("step %d loss %.5f acc %.3f", step0 + j + 1, storage.avg("loss"), storage.avg("acc"))
    return state


def oks_metrics(all_preds: np.ndarray, examples: LandmarkExamples, sigmas=None) -> dict:
    """Keypoint-OKS AP of a validation pass against the examples' labeled
    keypoints (``coco_eval.evaluate_keypoints``). The examples' visibility
    weights are COCO vis - 1, mapped back (+1) so that every labeled
    keypoint (v >= 1) counts, as pycocotools' computeOks does."""
    from ..data import coco_eval

    dets, gts = [], []
    for i in range(len(examples)):
        # the example's float32 values, as the JAX example() hands them over
        rec = {k: examples.records[i][k].astype(np.float32).astype(np.float64)
               for k in ("joints", "joints_vis", "bbox")}
        dets.append({"keypoints": np.asarray(all_preds[i], np.float64)[None],
                     "scores": np.asarray([float(all_preds[i, :, 2].mean())])})
        gts.append({"keypoints": np.concatenate([rec["joints"], rec["joints_vis"][:, None] + 1.0], axis=1)[None],
                    "boxes": rec["bbox"][None]})
    return coco_eval.evaluate_keypoints(dets, gts, sigmas=sigmas)
