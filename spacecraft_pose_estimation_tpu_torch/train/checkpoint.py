"""Checkpoints of the landmark trainer with the reference's resume rules (port of ``train/checkpoint.py``).

The rules are the JAX package's (detectron2's periodic saves and
``last_checkpoint`` resume; HRNet's ``model_best`` and AUTO_RESUME,
``lib/utils/utils.py:79-84``): ``save`` keeps the newest ``max_to_keep``
steps, ``restore`` takes the latest one, ``save_best`` tracks the best
value in ``best.json`` and keeps its state apart in ``best/``, and each
step's metadata (epoch, ...) rides in ``meta_{step}.json``.

The format is the port's own. Step ``s`` is a directory ``{s}/`` holding
``state.pt`` (``torch.save`` of the state's ``state_dict()``: for a
``TrainState`` the model, the optimizer's state and the step; for the
domain adaptation's ``DAState`` both models, both optimizers and the step)
and ``model.npz``, the Flax variable tree of the state's ``model`` (the
generator of a ``DAState``) with ``/``-joined keys
(``convert.module_to_flax``), which
``tools/test_landmarks --checkpoint`` and ``evaluate
--landmark-checkpoint`` read; a detector's is its ``params`` tree, which
``evaluate.load_detector`` reads. The port does not read the JAX package's
orbax directories.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..convert import flatten_variables, module_to_flax

STATE_FILE, NPZ_FILE = "state.pt", "model.npz"


def save_npz(model: torch.nn.Module, path: str) -> None:
    """The model's variables as the port's ``.npz`` checkpoint, written
    atomically: its parameters under ``params``, its buffers (BatchNorm
    statistics) under ``batch_stats``."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flatten_variables(module_to_flax(model)))
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._best_path = os.path.join(self.directory, "best.json")

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def npz_path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), NPZ_FILE)

    def save(self, step: int, state, metadata: dict | None = None) -> None:
        """Write step ``step`` of ``state`` (a ``TrainState`` or a ``DAState``), its ``.npz``
        and its metadata, then drop the oldest steps beyond ``max_to_keep``."""
        d = os.path.join(self.directory, str(step))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, STATE_FILE + ".tmp")
        torch.save(state.state_dict(), tmp)
        save_npz(state.model, os.path.join(d, NPZ_FILE))
        os.replace(tmp, os.path.join(d, STATE_FILE))
        with open(os.path.join(self.directory, f"meta_{step}.json"), "w") as f:
            json.dump(metadata or {}, f)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def save_best(self, step: int, perf: float, state=None) -> bool:
        """Track the best ``perf`` (higher is better); True when it improved.
        With ``state``, the improved state is also saved in ``best/``
        (``max_to_keep=1``), out of reach of the rolling window."""
        best = self.best_perf()
        if best is not None and perf <= best:
            return False
        with open(self._best_path, "w") as f:
            json.dump({"step": step, "perf": perf}, f)
        if state is not None:
            CheckpointManager(os.path.join(self.directory, "best"), max_to_keep=1).save(
                step, state, {"perf": perf})
        return True

    def best_perf(self) -> float | None:
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                return json.load(f)["perf"]
        return None

    def restore_best(self, state):
        """Restore the kept best state into ``state`` (None when there is none)."""
        best_dir = os.path.join(self.directory, "best")
        if not os.path.isdir(best_dir):
            return None
        return CheckpointManager(best_dir, max_to_keep=1).restore(state)

    def restore(self, state, step: int | None = None):
        """Load step ``step`` (default the latest) into ``state`` in place
        (its ``load_state_dict``) -> (state, metadata, step), or None when
        nothing is saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                             map_location=next(state.model.parameters()).device, weights_only=True)
        state.load_state_dict(payload)
        metadata = {}
        meta_path = os.path.join(self.directory, f"meta_{step}.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                metadata = json.load(f)
        return state, metadata, step
