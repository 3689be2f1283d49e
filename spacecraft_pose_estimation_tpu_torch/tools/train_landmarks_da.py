"""Adversarial domain-adaptation training of a CMS landmark model (port of ``tools/train_landmarks_da.py``).

The reference's ``tools/train_da_ms.py:83-311``: a multi-scale CMS HRNet
learns on a labelled source domain (synthetic images) while a ResNet-34
discriminator pushes its heatmaps to look alike on an unlabelled target
domain (lightbox or sunlamp images); ``train/adversarial.py`` is the step.

    python -m spacecraft_pose_estimation_tpu_torch.tools.train_landmarks_da --preset lightbox_cms \\
        --train-json source.json --image-dir SOURCE --target-json target.json --target-image-dir TARGET \\
        [--val-json target_val.json] --output OUT [--device cpu] [KEY VALUE ...]

The config (preset, then ``--cfg`` YAML, then overrides) -> the generator
from ``build_landmark_model`` (it must return the four scales in train
mode) and the float32 discriminator -> two optimizers on one per-epoch LR
schedule (the generator's ``TRAIN.OPTIMIZER`` with ``TRAIN.WD``, the
discriminator's Adam) -> per step: the source batch's random rotated
crops with the preset's photometric augmentation and the targets at the
heatmap size /1, /2, /4 and /8 (``MODEL.SIGMA``..``SIGMA4``), the target
batch through the training transform, one DA step -> per epoch the
metrics line, the generator's checkpoint in ``OUT/checkpoints`` (whose
``model.npz`` ``tools/test_landmarks --checkpoint`` and ``evaluate`` read)
and both models with both optimizers in ``OUT/da_state``; with
``--val-json`` (target-domain frames in ``--target-image-dir``) every 5
epochs and at the last one ``pred_val_real.mat``, ``val_mean_conf`` and the
best checkpoint. ``TRAIN.AUTO_RESUME`` restores ``OUT/da_state`` and goes
on at the epoch after the saved one.

The random draws are the port's own: one CPU generator per update, seeded
from (``SEED`` + 2, step) (``landmark_loop.step_generator``). Frames go to
the device once when they fit (``train_landmarks.device_cache``). It runs on
CUDA unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Iterator, Sequence

import torch

from .. import config as C
from ..data import augment
from ..data.landmark_dataset import (
    LandmarkExamples, batch_iterator, device_transform, index_iterator, sample_augmentation, sample_draws,
)
from ..device import resolve_device
from ..models import build_landmark_model
from ..models.discriminator import MultiScaleDiscriminator
from ..ops import geometry, heatmap, warp
from ..pipeline import normalize_crops
from ..train import landmark_loop
from ..train.adversarial import DAState, make_da_train_step
from ..train.checkpoint import CheckpointManager
from ..train.metrics import JSONWriter, MetricStorage
from ..train.optim import build_optimizer, multistep_schedule
from .train_landmarks import device_cache

logger = logging.getLogger("train_landmarks_da")
Tensor = torch.Tensor


def photo_ranges(preset: str) -> dict:
    """The per-domain photometric source augmentation (``train_da_ms.py:146-166``):
    the noise's std and mean ranges and the erase probability."""
    if "sunlamp" in preset:
        return {"noise_std": (0.03, 0.05), "noise_mean": (0.01, 0.1), "erase_p": 0.3}
    return {"noise_std": (0.01, 0.1), "noise_mean": (0.03, 0.25), "erase_p": 0.4}  # lightbox and default


def sample_photo_draws(generator: torch.Generator, batch: int, height: int, width: int,
                       noise_std: tuple[float, float], noise_mean: tuple[float, float]) -> dict[str, Tensor]:
    """The draws of :func:`photo_aug` for ``batch`` crops of (height, width)."""
    noise = augment.sample_noise_01(generator, batch, height, width, noise_std, noise_mean)
    return {"jitter": augment.sample_color_jitter(generator, batch, 1.0, 1.0, 1.0), "noise_std": noise["std"],
            "noise_mean": noise["mean"], "noise": noise["noise"],
            "erase_u": torch.rand(batch, generator=generator),
            "erase": augment.sample_erasing(generator, batch, height, width)}


def photo_aug(crops: Tensor, draws: dict, erase_p: float) -> Tensor:
    """ColorJitter(1, 1, 1) -> RandomNoise in [0, 1] -> erase to black
    with probability ``erase_p`` on (B, H, W, 3) crops of [0, 255]."""
    im = augment.color_jitter(crops, draws["jitter"])
    im = augment.random_noise_01(im / 255.0, draws["noise_std"], draws["noise_mean"], draws["noise"]) * 255.0
    erased = augment.random_erasing(im, draws["erase"])
    return torch.where((draws["erase_u"].to(im.device) < erase_p)[:, None, None, None], erased, im)


def sample_step_draws(generator: torch.Generator, cfg: C.ExperimentConfig, preset: str) -> tuple[dict, dict]:
    """Every draw of one update, in a fixed order: the source batch's scale
    and rotation, its photometric draws, then the target batch's transform."""
    bs, bt = cfg.train.batch_size_per_chip, cfg.train.batch_size_adversarial
    w, h = cfg.model.image_size
    s_mult, rots = sample_augmentation(generator, bs, cfg.dataset.scale_factor, cfg.dataset.rot_factor)
    ranges = photo_ranges(preset)
    source = {"s_mult": s_mult, "rots": rots} | sample_photo_draws(generator, bs, h, w, ranges["noise_std"],
                                                                    ranges["noise_mean"])
    target = sample_draws(generator, bt, cfg.dataset.scale_factor, cfg.dataset.rot_factor, half_body=False)
    return source, target


def multi_scale_targets(images: Tensor, bboxes: Tensor, joints: Tensor, joints_vis: Tensor, draws: dict,
                        image_size: tuple[int, int], heatmap_size: tuple[int, int], sigmas: Sequence[float],
                        erase_p: float) -> dict[str, Tensor]:
    """The source batch of a DA step (``JointsDataset`` multi_scale_target):
    the rotated crops of the boxes scaled by ``draws["s_mult"]`` and turned
    by ``draws["rots"]``, :func:`photo_aug`, ImageNet normalization
    (``source_image``), and the Gaussian targets of the crop's joints at the
    heatmap size /1, /2, /4, /8 with ``sigmas`` (``target``,
    ``target_weight``, ``target2``, ...)."""
    dev = images.device
    centers, scales = geometry.bbox_to_center_scale(bboxes.to(dev, torch.float32))
    scales = scales * draws["s_mult"].to(dev, torch.float32)[:, None]
    rots = draws["rots"].to(dev, torch.float32)
    crops = photo_aug(warp.rotated_crop_and_resize(images, centers, scales, rots, image_size), draws, erase_p)
    joints_crop = geometry.apply_affine(joints.to(dev, torch.float32),
                                        geometry.crop_affine_matrix(centers, scales, rots, image_size))
    vis = joints_vis.to(dev, torch.float32)
    batch = {"source_image": normalize_crops(crops)}
    for idx, div in enumerate((1, 2, 4, 8)):
        tgt, tw = heatmap.generate_target(joints_crop, vis, image_size,
                                          (heatmap_size[0] // div, heatmap_size[1] // div), sigmas[idx])
        suffix = "" if idx == 0 else str(idx + 1)
        batch[f"target{suffix}"], batch[f"target_weight{suffix}"] = tgt, tw
    return batch


def batch_stream(examples: LandmarkExamples, batch: int, seed: int, start: int, device) -> Iterator[tuple]:
    """Endless shuffled batches (images, bboxes, joints, joints_vis) on
    ``device``, from batch ``start`` on: gathered from the device cache when
    the frames fit it, else read on the host."""
    cache = device_cache(examples, device)
    if cache is not None:
        for idx in index_iterator(len(examples), batch, seed=seed, start=start):
            yield cache.gather(idx)
    else:
        for raw in batch_iterator(examples, batch, seed=seed, start=start):
            yield tuple(torch.as_tensor(raw[k]).to(device) for k in ("image", "bbox", "joints", "joints_vis"))


def train(cfg: C.ExperimentConfig, source: LandmarkExamples, target: LandmarkExamples, output: str,
          device=None, val_examples: LandmarkExamples | None = None, preset: str = "lightbox_cms") -> DAState:
    """Train ``cfg.model`` against the discriminator on ``source`` (labelled)
    and ``target`` (its images only), checkpoints and metrics under
    ``output``; ``preset`` picks the photometric ranges. Returns the state."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    num_joints = source.num_joints
    model = build_landmark_model(cfg.model.name, num_joints, device=device, dtype=dtype,
                                 generator=torch.Generator().manual_seed(cfg.seed))
    if getattr(model.config, "head", "classic") == "classic":
        raise SystemExit("DA training requires a multi-scale model (hrnet_cms*)")
    disc = MultiScaleDiscriminator(num_joints, device=device, generator=torch.Generator().manual_seed(cfg.seed + 1))
    bs, bt = cfg.train.batch_size_per_chip, cfg.train.batch_size_adversarial
    steps_per_epoch = max(len(source) // bs, 1)
    milestones = [m * steps_per_epoch for m in cfg.train.lr_step]
    schedule = multistep_schedule(cfg.train.lr, milestones, cfg.train.lr_factor)
    gen_opt = build_optimizer(cfg.train.optimizer, model.parameters(), schedule, weight_decay=cfg.train.wd)
    # the reference steps the discriminator's Adam on the generator's schedule (train_da_ms.py:257-273)
    state = DAState(model, disc, gen_opt, build_optimizer("adam", disc.parameters(), schedule))

    mgr = CheckpointManager(os.path.join(output, "checkpoints"))
    mgr_da = CheckpointManager(os.path.join(output, "da_state"), max_to_keep=2)
    begin_epoch = cfg.train.begin_epoch
    if cfg.train.auto_resume:
        restored = mgr_da.restore(state)
        if restored:
            _, meta, step_no = restored
            begin_epoch = meta.get("epoch", -1) + 1
            logger.info("auto-resumed at epoch %d (step %d)", begin_epoch, step_no)

    step_fn = make_da_train_step(beta=cfg.train.beta, d_loss_mode=cfg.train.d_loss_mode)
    storage = MetricStorage()
    writer = JSONWriter(os.path.join(output, "metrics.json"))
    # a resumed run goes on with the batches after the last ones it took
    src_iter = batch_stream(source, bs, cfg.seed, state.step, device)
    tgt_iter = batch_stream(target, bt, cfg.seed + 1, state.step, device)
    image_size, hm_size = tuple(cfg.model.image_size), tuple(cfg.model.heatmap_size)
    sigmas = (cfg.model.sigma, cfg.model.sigma2, cfg.model.sigma3, cfg.model.sigma4)
    erase_p = photo_ranges(preset)["erase_p"]
    try:
        for epoch in range(begin_epoch, cfg.train.end_epoch):
            step0, collected = state.step, []
            for _ in range(steps_per_epoch):
                src_draws, tgt_draws = sample_step_draws(landmark_loop.step_generator(cfg.seed + 2, state.step),
                                                         cfg, preset)
                batch = multi_scale_targets(*next(src_iter), src_draws, image_size, hm_size, sigmas, erase_p)
                batch["target_image"] = device_transform(
                    *next(tgt_iter), image_size=image_size, heatmap_size=hm_size, sigma=cfg.model.sigma,
                    train=True, draws=tgt_draws)["image"]
                collected.append(step_fn(state, batch))
            names = list(collected[0])
            rows = torch.stack([torch.stack([m[k].float() for k in names]) for m in collected]).cpu().tolist()
            for j, row in enumerate(rows):
                storage.step = step0 + j + 1
                storage.put_scalars(**dict(zip(names, row)))
                if (j + 1) % cfg.print_freq == 0:
                    logger.info("epoch %d step %d loss %.5f d_loss %.5f", epoch, storage.step,
                                storage.avg("loss"), storage.avg("d_loss"))
            writer.write(storage)
            mgr.save(state.step, state.generator_state(), {"epoch": epoch})
            mgr_da.save(state.step, state, {"epoch": epoch})
            # validation on the target domain every 5 epochs and at the last (train_da_ms.py:277-288)
            if val_examples is not None and ((epoch + 1) % 5 == 0 or epoch == cfg.train.end_epoch - 1):
                preds = landmark_loop.validate(
                    model, val_examples, cfg.test.batch_size_per_chip, image_size,
                    output_path=os.path.join(output, "pred_val_real.mat"), flip_test=cfg.test.flip_test,
                    post_process=cfg.test.post_process, shift_heatmap=cfg.test.shift_heatmap)
                mean_conf = float(preds[:, :, 2].mean())
                storage.put_scalar("val_mean_conf", mean_conf)
                if mgr.save_best(state.step, mean_conf, state=state.generator_state()):
                    logger.info("new best at epoch %d (%.4f)", epoch, mean_conf)
            logger.info("epoch %d done (step %d)", epoch, state.step)
    finally:
        writer.close()
    return state


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="lightbox_cms")
    ap.add_argument("--cfg", default=None, help="a YAML file of config keys (needs PyYAML)")
    ap.add_argument("--train-json", required=True, help="source-domain COCO json")
    ap.add_argument("--image-dir", required=True, help="source-domain frames")
    ap.add_argument("--target-json", required=True, help="target-domain COCO json")
    ap.add_argument("--target-image-dir", required=True, help="target-domain frames (also the validation's)")
    ap.add_argument("--val-json", default=None, help="target-domain validation json")
    ap.add_argument("--output", default="output/da")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", help="KEY VALUE config override pairs")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    cfg = C.get_preset(args.preset)
    if args.cfg:
        cfg = C.load_yaml(cfg, args.cfg)
    cfg = C.apply_overrides(cfg, args.opts)
    logger.info("config: %s", cfg)
    val = LandmarkExamples(args.val_json, args.target_image_dir) if args.val_json else None
    train(cfg, LandmarkExamples(args.train_json, args.image_dir),
          LandmarkExamples(args.target_json, args.target_image_dir), args.output, device, val, args.preset)


if __name__ == "__main__":
    main()
