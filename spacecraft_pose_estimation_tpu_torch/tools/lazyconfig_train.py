"""LazyConfig trainer, detectron2's ``tools/lazyconfig_train_net.py`` (port of ``tools/lazyconfig_train.py``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.lazyconfig_train --config-file F \\
        [--device cpu] [KEY VALUE ...]

The config is a Python file run in its own namespace that defines
``LazyCall`` nodes (``spacecraft_pose_estimation_tpu_torch.config``):

    from spacecraft_pose_estimation_tpu_torch.config import LazyCall as L
    from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNet, POSE_HRNET_W32
    from spacecraft_pose_estimation_tpu_torch.train.optim import build_optimizer

    model = L(HRNet)(config=POSE_HRNET_W32.with_joints(11))
    optimizer = L(build_optimizer)(name="adam", learning_rate=1e-3)  # or L(torch.optim.Adam)(lr=1e-3)
    # optional: dataloader = L(my_loader_factory)(...)   # -> callable(step) -> batch
    train = dict(max_iter=40, batch_size=4, image_size=64, heatmap_size=16,
                 num_joints=11, out_dir="output/lazy", log_period=10)

``instantiate`` builds the nodes depth first. The model node gets the
run's ``device`` and a generator seeded from ``train["seed"]`` unless it
sets them (the port's models take both); the optimizer node gets the
model's parameters as ``params``, as detectron2's trainer hands them in
before it instantiates the optimizer. A ``torch.optim`` optimizer runs at
its own constant learning rate. ``KEY VALUE`` pairs override ``train``
entries. Then the landmark train step (``train/state.make_train_step``)
runs ``max_iter`` times and, with ``out_dir``, the state is saved as a
checkpoint of ``train/checkpoint.CheckpointManager`` (``{max_iter}/model.npz``
is what ``tools/test_landmarks --checkpoint`` reads). Without a
``dataloader`` node it trains on deterministic synthetic batches drawn as
the JAX tool draws them. It runs on CUDA unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import ast
import os
import runpy
import time
from typing import Sequence

import numpy as np
import torch

from ..config import instantiate
from ..convert import flax_to_state_dict
from ..device import resolve_device
from ..ops.heatmap import generate_target
from ..train.checkpoint import CheckpointManager
from ..train.optim import Optimizer
from ..train.state import TrainState, make_train_step


def load_lazy_config(path: str) -> dict:
    """Run the config file and return its namespace (LazyConfig.load)."""
    ns = runpy.run_path(path)
    return {k: v for k, v in ns.items() if not k.startswith("__")}


def apply_overrides(train_cfg: dict, pairs: Sequence[str]) -> dict:
    """``KEY VALUE`` pairs (Python literals where they parse) onto ``train``."""
    out = dict(train_cfg)
    for key, value in zip(pairs[::2], pairs[1::2]):
        try:
            out[key] = ast.literal_eval(value)
        except (SyntaxError, ValueError):
            out[key] = value
    return out


def synthetic_loader(train_cfg: dict, device):
    """Deterministic synthetic landmark batches: per step, N(0, 1) images
    (B, S, S, 3) and joints U(0.2 S, 0.8 S) from one numpy generator seeded
    by ``seed``, in the JAX tool's order, with their Gaussian targets
    (sigma 2) on ``device``."""
    size = int(train_cfg.get("image_size", 64))
    hm = int(train_cfg.get("heatmap_size", size // 4))
    bs = int(train_cfg.get("batch_size", 4))
    nj = int(train_cfg.get("num_joints", 11))
    rng = np.random.default_rng(int(train_cfg.get("seed", 0)))

    def batch(step: int) -> dict:
        del step
        imgs = rng.normal(0.0, 1.0, (bs, size, size, 3)).astype(np.float32)
        joints = rng.uniform(size * 0.2, size * 0.8, (bs, nj, 2)).astype(np.float32)
        target, weight = generate_target(torch.from_numpy(joints).to(device), torch.ones(bs, nj, device=device),
                                         (size, size), (hm, hm), 2.0)
        return {"image": torch.from_numpy(imgs).to(device), "target": target, "target_weight": weight}

    return batch


def build(ns: dict, train_cfg: dict, device, variables: dict | None = None):
    """The config's model, optimizer and loader: (TrainState, loader).
    ``variables``, a Flax variable tree, replaces the model's seeded start
    (``convert.flax_to_state_dict``)."""
    for req in ("model", "optimizer", "train"):
        if req not in ns:
            raise SystemExit(f"config must define a `{req}` node")
    seed = int(train_cfg.get("seed", 0))
    model_node = {"device": device, "generator": torch.Generator().manual_seed(seed), **ns["model"]}
    model = instantiate(model_node)
    if variables is not None:
        model.load_state_dict(flax_to_state_dict(variables))
    opt = instantiate({**ns["optimizer"], "params": list(model.parameters())})
    if isinstance(opt, torch.optim.Optimizer):
        opt = Optimizer(opt, lambda _step, lr=opt.param_groups[0]["lr"]: lr)
    loader = instantiate(ns["dataloader"]) if "dataloader" in ns else synthetic_loader(train_cfg, device)
    return TrainState(model, opt), loader


def run(state: TrainState, loader, train_cfg: dict) -> list[float]:
    """``max_iter`` train steps, the loss printed every ``log_period``; with
    ``out_dir`` the state is saved at step ``max_iter``. Returns every loss."""
    step_fn = make_train_step()
    max_iter = int(train_cfg.get("max_iter", 40))
    log_period = int(train_cfg.get("log_period", 10))
    t0 = time.time()
    losses = []
    for it in range(max_iter):
        losses.append(step_fn(state, loader(it))["loss"])
        if it % log_period == 0 or it == max_iter - 1:
            print(f"iter {it}/{max_iter} loss {float(losses[-1]):.5f} ({time.time() - t0:.1f}s)", flush=True)
    out_dir = train_cfg.get("out_dir")
    if out_dir:
        CheckpointManager(os.path.abspath(out_dir)).save(max_iter, state)
        print(f"saved checkpoint to {out_dir}", flush=True)
    return [float(v) for v in losses]


def main(argv: Sequence[str] | None = None) -> float | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", default=[], help="KEY VALUE override pairs for the train dict")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ns = load_lazy_config(args.config_file)
    train_cfg = apply_overrides(dict(ns.get("train", {})), args.opts)
    losses = run(*build(ns, train_cfg, device), train_cfg)
    return losses[-1] if losses else None


if __name__ == "__main__":
    main()
