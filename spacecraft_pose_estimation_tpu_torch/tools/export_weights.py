"""A landmark checkpoint -> a reference ``.pth`` (port of ``tools/export_weights.py``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.export_weights --checkpoint DIR \\
        --num-joints J --output model.pth [--model pose_hrnet]

The inverse of ``tools.import_weights``: the latest step of a port
checkpoint directory (``train/checkpoint.CheckpointManager``, e.g.
``OUT/checkpoints`` of ``tools.train_landmarks``) under the reference's
``pose_hrnet`` names (``utils/torch_export.hrnet_flax_to_torch``: the trunk
and ``final_layer``; the CMS heads are not exported, as in the JAX
package), written with ``torch.save``, so that the reference's own
``landmark_regression/tools/test.py`` runs the model. A format conversion
on the host: no ``--device``, CPU tensors. ``--image-size`` is taken for
the JAX tool's command lines; the port's modules are built without an
example input.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import torch

from ..models import build_landmark_model
from ..train.checkpoint import CheckpointManager
from ..train.optim import build_optimizer
from ..train.state import TrainState
from ..utils.torch_export import export_hrnet


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Export a landmark checkpoint to a reference .pth state dict.")
    ap.add_argument("--checkpoint", required=True, help="port checkpoint directory")
    ap.add_argument("--model", default="pose_hrnet")
    ap.add_argument("--num-joints", type=int, required=True)
    ap.add_argument("--image-size", type=int, nargs=2, default=[512, 512])
    ap.add_argument("--output", required=True, help="output .pth path")
    return ap


def main(argv: Sequence[str] | None = None) -> dict[str, torch.Tensor]:
    """The command; returns the state dict it wrote."""
    args = build_parser().parse_args(argv)
    if not os.path.isdir(args.checkpoint):
        raise FileNotFoundError(f"no checkpoint directory {args.checkpoint}")
    model = build_landmark_model(args.model, args.num_joints, device="cpu")
    state = TrainState(model, build_optimizer("adam", model.parameters(), 1e-3))
    if CheckpointManager(args.checkpoint).restore(state) is None:
        raise FileNotFoundError(f"no checkpoint in {args.checkpoint}")
    sd = export_hrnet(state.model)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    torch.save(sd, args.output)
    print(f"exported {len(sd)} tensors -> {args.output}")
    return sd


if __name__ == "__main__":
    main()
