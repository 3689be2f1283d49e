"""Reference torch checkpoints -> a port checkpoint (port of ``tools/import_weights.py``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.import_weights --torch-checkpoint FILE \\
        --kind hrnet|detectron2 --output DIR [--model pose_hrnet] [--num-joints 17] [--all-layers]

Covers the reference's pretrained entry points:

* an HRNet ImageNet or pose state dict (``hrnet_w32-36af842e.pth``; the
  PRETRAINED_LAYERS filter unless ``--all-layers``) -> the landmark model
  ``--model`` with ``--num-joints`` heatmaps;
* a detectron2 GeneralizedRCNN ``.pth`` state dict -> the X101-32x8d FPN
  detector (``FASTER_RCNN_X101_SPACECRAFT``);
* a detectron2 or Caffe2 model-zoo ``.pkl`` (pickle and numpy, no torch;
  told apart by its ``.pkl`` suffix) -> the same detector.

A ``.pth`` may hold the state dict itself, or under ``"state_dict"`` or
``"model"``; ``module.`` prefixes are dropped. The output is step 0 of a
port checkpoint in ``DIR`` (``train/checkpoint.CheckpointManager``:
``0/state.pt``, ``0/model.npz`` and ``meta_0.json`` with
``{"imported_from": FILE}``) with the JAX tool's placeholder optimizer (Adam
1e-3 for a landmark model, SGD 1e-2 for the detector). ``tools.train_landmarks``
(``TRAIN.AUTO_RESUME``, ``--output`` the directory above ``DIR``, which is
then ``OUT/checkpoints``) and ``tools.train_detector`` resume from it and
keep their own optimizer's hyperparameters; ``evaluate
--landmark-checkpoint`` / ``--detector-checkpoint``,
``tools.test_landmarks`` and ``tools.export_boxes`` read ``DIR/0/model.npz``.
A format conversion on the host: no ``--device``, CPU tensors.
``--image-size`` is taken for the JAX tool's command lines; the port's
modules are built without an example input.
"""

from __future__ import annotations

import argparse
from typing import Any, Sequence

import torch

from ..models import build_landmark_model
from ..models.rcnn import FASTER_RCNN_X101_SPACECRAFT, GeneralizedRCNN
from ..train.checkpoint import CheckpointManager
from ..train.detection_state import DetTrainState
from ..train.optim import build_optimizer
from ..train.state import TrainState
from ..utils import torch_import as TI
from ..utils import zoo_import


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Import a reference torch checkpoint into a port checkpoint.")
    ap.add_argument("--torch-checkpoint", required=True)
    ap.add_argument("--kind", choices=["hrnet", "detectron2"], required=True)
    ap.add_argument("--model", default="pose_hrnet")
    ap.add_argument("--num-joints", type=int, default=17)
    ap.add_argument("--image-size", type=int, nargs=2, default=[512, 512])
    ap.add_argument("--output", required=True, help="checkpoint directory")
    ap.add_argument("--all-layers", action="store_true", help="import every layer (PRETRAINED_LAYERS='*')")
    return ap


def load_torch_state_dict(path: str) -> dict[str, Any]:
    """A ``.pth``'s state dict: unwrapped from ``"state_dict"`` or ``"model"``,
    ``module.`` prefixes dropped (the JAX tool's rules)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model" in sd and not hasattr(sd.get("model"), "shape"):
        sd = sd["model"]
    return {k.removeprefix("module."): v for k, v in sd.items()}


def main(argv: Sequence[str] | None = None) -> dict:
    """The command; returns what it did: ``sources`` (the file's entries),
    ``mapped`` (leaves loaded), ``skipped`` (the leaves the module lacks,
    as paths), ``ignored`` (entries the grammar maps to no leaf: unknown
    names, ``num_batches_tracked``, layers the filter leaves out) and
    ``output``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    path = args.torch_checkpoint
    is_pkl = path.endswith(".pkl")
    gen = torch.Generator().manual_seed(0)
    if args.kind == "hrnet":
        if is_pkl:
            ap.error("--kind hrnet expects a torch .pth checkpoint, not .pkl")
        sd = load_torch_state_dict(path)
        model = build_landmark_model(args.model, args.num_joints, device="cpu", generator=gen)
        layers = TI.ALL_LAYERS if args.all_layers else TI.PRETRAINED_LAYERS
        params, stats = TI.hrnet_torch_to_flax(sd, pretrained_layers=layers)
        n_sources = len(sd)
        state = TrainState(model, build_optimizer("adam", model.parameters(), 1e-3))
    else:
        model = GeneralizedRCNN(FASTER_RCNN_X101_SPACECRAFT, device="cpu", generator=gen)
        if is_pkl:
            data = zoo_import.load_detectron_pickle(path)
            params, n_sources = zoo_import.zoo_model_to_flax(data), len(data["model"])
        else:
            sd = load_torch_state_dict(path)
            params, n_sources = TI.detectron2_torch_to_flax(sd), len(sd)
        stats = {}
        state = DetTrainState(model, build_optimizer("sgd", model.parameters(), 1e-2))
    skipped, loaded = TI.merge_pretrained(model, params, stats)
    mgr = CheckpointManager(args.output)
    mgr.save(0, state, {"imported_from": path})
    report = {"sources": n_sources, "mapped": loaded, "skipped": skipped,
              "ignored": n_sources - TI.count_leaves(params) - TI.count_leaves(stats), "output": mgr.directory}
    print(f"imported {path} -> {args.output}: {n_sources} entries, {report['mapped']} leaves loaded, "
          f"{len(skipped)} skipped {skipped[:5]}, {report['ignored']} ignored")
    return report


if __name__ == "__main__":
    main()
