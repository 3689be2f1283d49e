"""Rules of the PyTorch port: no JAX on its side, CUDA unless asked otherwise."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "spacecraft_pose_estimation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "spacecraft_pose_estimation_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_ablate.py", ROOT / "chip_dvs_run.py",
                                       ROOT / "chip_fault_hunt.py"]


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
    # CUDA named explicitly raises the same way, where a card is missing
    from spacecraft_pose_estimation_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    from spacecraft_pose_estimation_tpu_torch import evaluate
    from spacecraft_pose_estimation_tpu_torch.models import build_landmark_model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_landmark_model("hrnet_tiny", 11)
    # evaluate.main's --device defaults to cuda (run_scene runs on its models' device)
    with pytest.raises(RuntimeError, match="--device cpu"):
        evaluate.main(["--scenes-dir", ".", "--landmarks-file", "l.csv", "--calibration-file", "c.json",
                       "--detector-checkpoint", "d.npz", "--landmark-checkpoint", "h.npz", "--output-dir", "."])
    # so do the staged evaluation's stage commands, and the PnP stage's function
    from spacecraft_pose_estimation_tpu_torch.tools import (
        export_boxes, export_poses, test_landmarks, train_landmarks, train_landmarks_da,
    )

    for tool, args in ((export_boxes, ["--image-dir", ".", "--checkpoint", "d.npz", "--output-dir", "."]),
                       (test_landmarks, ["--test-json", "t.json", "--image-dir", ".", "--checkpoint", "h.npz"]),
                       (train_landmarks, ["--train-json", "t.json", "--image-dir", "."]),
                       (train_landmarks_da, ["--train-json", "t.json", "--image-dir", ".", "--target-json", "t.json",
                                             "--target-image-dir", "."]),
                       (export_poses, ["--frames-dir", ".", "--detection-annotations", "t.json",
                                       "--pose-annotations", "p.mat", "--landmarks-file", "l.csv",
                                       "--calibration-file", "c.json", "--output-dir", "."])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            tool.main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_poses.solve_poses(np.zeros((1, 11, 3), np.float32), np.zeros((11, 3)), None)
    # and the trainer's function
    from spacecraft_pose_estimation_tpu_torch import config

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_landmarks.train(config.get_preset("events"), None, ".")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_landmarks_da.train(config.get_preset("lightbox_cms"), None, None, ".")
    from spacecraft_pose_estimation_tpu_torch.models.discriminator import MultiScaleDiscriminator

    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiScaleDiscriminator(11)


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


CSRC = PORT / "csrc"


@pytest.mark.parametrize("path", sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")),
                         ids=lambda p: p.name)
def test_kernel_sources_take_no_torch_or_jax_headers(path):
    """Each kernel source (K2's backward and its shared geometry header too)
    includes only the CUDA toolkit's, the C++ library's and the port's own
    headers, and each ``.cu`` exports a plain C launcher for ``ctypes``:
    nothing of PyTorch's extension headers, nothing of JAX or XLA."""
    import re

    text = path.read_text()
    own = {p.name for p in CSRC.glob("*.cuh")}
    for inc in re.findall(r'#include\s*[<"]([^>"]+)[>"]', text):
        assert inc in own or inc in ("cuda_runtime.h", "cuda_bf16.h", "stdint.h", "numeric"), f"{path.name}: {inc}"
    if path.suffix == ".cu":
        assert 'extern "C"' in text


def test_pooler_backward_raises_off_the_card_and_never_falls_back():
    """K2's backward wrapper launches its kernel or raises: CPU and meta
    tensors are refused, and so are shapes and types the kernel does not
    take (the CPU's gradient is autograd of the plain version, through
    ``roi_align_multilevel``, not this wrapper)."""
    from spacecraft_pose_estimation_tpu_torch.ops import roi_align

    for dev in ("cpu", "meta"):
        boxes = torch.zeros(2, 4, device=dev)
        bidx = torch.zeros(2, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="CUDA"):
            roi_align.roi_align_multilevel_backward(torch.zeros(2, 7, 7, 8, device=dev), [(1, 8, 8, 8)],
                                                    torch.float32, boxes, bidx, 7, (4,), window=16)
    with pytest.raises(ValueError, match="impl"):
        roi_align._check_pyramid([(1, 8, 8, 8)], torch.float32, (4,), 7, 2, "gather")
    with pytest.raises(ValueError, match="multiple of 8"):
        roi_align._check_pyramid([(1, 8, 8, 12)], torch.float32, (4,), 7, 2, "pallas")


def test_detector_trainer_needs_cuda_or_an_explicit_device(tmp_path):
    from spacecraft_pose_estimation_tpu_torch.tools import train_detector

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_detector.main(["--train-json", "t.json", "--image-dir", "."])
    args = train_detector.parse_args(["--train-json", "t.json", "--image-dir", ".", "--tiny",
                                      "--output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_detector.train(args, None)


def test_event_commands_need_cuda_or_an_explicit_device(tmp_path):
    """The event half's commands and models run on CUDA unless given the
    CPU, and raise where the card is missing (``aedat_to_csv``, a format
    conversion with no tensor work, takes no device)."""
    if torch.cuda.is_available():
        return
    from spacecraft_pose_estimation_tpu_torch.events import slomo
    from spacecraft_pose_estimation_tpu_torch.tools import convert_aedats, e2v, evaluate_event_pipeline, v2e

    for tool, args in ((v2e, ["--synthetic_input", "spacecraft_pose_estimation_tpu_torch.events.synthetic_input",
                              "-o", str(tmp_path / "v2e")]),
                       (e2v, ["-i", "e.csv", "-o", str(tmp_path), "--width", "8", "--height", "8"]),
                       (convert_aedats, ["--recordings-dir", ".", "--output-dir", str(tmp_path),
                                         "--calibration-file", "c.json"]),
                       (evaluate_event_pipeline, ["--recordings-dir", ".", "--calibration-file", "c.json",
                                                  "--landmarks-file", "l.csv", "--detector-checkpoint", "d.npz",
                                                  "--landmark-checkpoint", "h.npz", "--output-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            tool.main(args)
        with pytest.raises(RuntimeError, match="--device cpu"):
            tool.main(args + ["--device", "cuda"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slomo.SuperSloMo()
    assert next(slomo.SuperSloMo(device="cpu").parameters()).device.type == "cpu"


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


def test_dvs_pipeline_commands_need_cuda_or_an_explicit_device(tmp_path):
    """The DVS training pipeline's driver runs on CUDA unless given the CPU;
    its data tools (the split, the synthetic scene, the COCO conversion) are
    host code and take no device."""
    from spacecraft_pose_estimation_tpu_torch.tools import (
        convert_to_coco, make_synthetic_scene, split_images, train_pipeline_dvs,
    )

    for tool in (convert_to_coco, make_synthetic_scene, split_images):
        with pytest.raises(SystemExit):
            tool.main(["--device", "cpu"])
    if torch.cuda.is_available():
        return
    args = ["--frames-dir", ".", "--gt-dir", ".", "--landmarks-file", "l.csv", "--work-dir", str(tmp_path / "w")]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_pipeline_dvs.main(args + extra)


def test_no_jax_check_covers_the_weight_modules():
    """The weight bridges keep their own copies of the JAX package's numpy
    modules: the import check above reaches each of them."""
    sources = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert {"utils/torch_import.py", "utils/zoo_import.py", "utils/torch_export.py", "tools/import_weights.py",
            "tools/export_weights.py", "tools/export_model.py"} <= sources


def test_weight_commands_device_rules(tmp_path):
    """``import_weights`` and ``export_weights`` are host conversions and take
    no ``--device``; ``export_model`` runs on CUDA unless given ``--device
    cpu`` and raises where the card is missing."""
    from spacecraft_pose_estimation_tpu_torch.tools import export_model, export_weights, import_weights

    for tool, args in ((import_weights, ["--torch-checkpoint", "w.pth", "--kind", "hrnet", "--output", "o"]),
                       (export_weights, ["--checkpoint", ".", "--num-joints", "11", "--output", "w.pth"])):
        with pytest.raises(SystemExit):
            tool.main(args + ["--device", "cpu"])
    if torch.cuda.is_available():
        return
    args = ["--checkpoint", str(tmp_path), "--landmarks-file", "l.csv", "--calibration-file", "c.json",
            "--output", str(tmp_path / "p.pt2")]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            export_model.main(args + extra)


def test_registered_k1_launches_or_raises_and_never_takes_the_plain_version():
    """K1's registered operator: its CUDA implementation launches the kernel
    (it names no plain version) and refuses CPU tensors; CPU tensors
    dispatch to the plain version."""
    import inspect

    from spacecraft_pose_estimation_tpu_torch.ops import warp

    tree = ast.parse(inspect.getsource(warp._crop_bilinear_cuda))
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert "crop_bilinear_plain" not in names and "launch" in names
    frames, params = torch.zeros(1, 8, 8, 3, dtype=torch.uint8), torch.zeros(1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        warp._crop_bilinear_cuda(frames, params, 4, 4)
    out = torch.ops.spe_port.crop_bilinear(frames, params, 4, 4)
    assert torch.equal(out, warp.crop_bilinear_plain(frames, params, (4, 4)))
