"""Rules of the PyTorch port: no JAX on its side, CUDA unless asked otherwise."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "spacecraft_pose_estimation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "spacecraft_pose_estimation_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_ablate.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    """Neither the port nor its card scripts import JAX or the JAX package
    (the exact package; the ``_torch`` port itself is fine)."""
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_need_cuda_or_an_explicit_device():
    from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
    from spacecraft_pose_estimation_tpu_torch.models.rcnn import RCNN_TINY, GeneralizedRCNN

    if torch.cuda.is_available():
        assert next(HRNet(HRNET_TINY).parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HRNet(HRNET_TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GeneralizedRCNN(RCNN_TINY)
    assert next(HRNet(HRNET_TINY, device="cpu").parameters()).device.type == "cpu"


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor on neither the CPU nor CUDA never reaches a plain version."""
    from spacecraft_pose_estimation_tpu_torch.ops import nms, roi_align, warp

    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        nms.nms_mask_sorted(torch.zeros(1, 4, 4, device=meta), torch.ones(1, 4, dtype=torch.bool, device=meta), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        warp.crop_bilinear(torch.zeros(1, 8, 8, 3, dtype=torch.uint8, device=meta),
                           torch.zeros(1, 4, device=meta), (4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        roi_align.roi_align_multilevel(
            [torch.zeros(1, 8, 8, 4, device=meta)], torch.zeros(1, 4, device=meta),
            torch.zeros(1, dtype=torch.int32, device=meta), 7, (4,), window=16,
        )


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without CUDA, or without the repo around it, chip_smoke.py exits
    non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # hide any card this host has
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
