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
        roi_align._check_pyramid([(1, 8, 8, 8)], torch.float32, (4,), 7, 2, "nearest")
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


def test_no_jax_check_covers_the_heads_modules():
    """The mask, keypoint and cascade heads, FCOS and the mask ops are under
    the import check above."""
    sources = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert {"models/cascade.py", "models/fcos.py", "ops/masks.py", "ops/roi_align.py", "data/coco_eval.py"} <= sources


def test_gather_read_launches_k2_or_raises_and_never_takes_the_plain_version():
    """K2's gather read (the heads' and the cascade's pooler): on a tensor off
    the CPU the wrapper goes to K2 and its backward kernel, whose functions
    name no plain version, and a tensor neither on the CPU nor on CUDA is
    refused; the box head's config keeps the two windowed reads."""
    import inspect
    import textwrap

    from spacecraft_pose_estimation_tpu_torch.models import roi_heads
    from spacecraft_pose_estimation_tpu_torch.ops import roi_align

    assert tuple(roi_align.READS) == ("windowed", "pallas", "gather")
    for fn in (roi_align._forward_kernel, roi_align.roi_align_multilevel_backward,
               roi_align._RoIAlignMultilevel.forward, roi_align._RoIAlignMultilevel.backward):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} | {
            n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert not {"roi_align_multilevel_plain", "roi_align_multilevel_backward_plain"} & names, fn.__name__
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        roi_align.roi_align_multilevel([torch.zeros(1, 8, 8, 8, device=meta)], torch.zeros(1, 4, device=meta),
                                       torch.zeros(1, dtype=torch.int32, device=meta), 14, (4,), impl="gather")
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA"):
            roi_align.roi_align_multilevel_backward(
                torch.zeros(1, 14, 14, 8, device=dev), [(1, 8, 8, 8)], torch.float32, torch.zeros(1, 4, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), 14, (4,), impl="gather")
    with pytest.raises(ValueError, match="pooler_impl"):
        roi_heads.ROIHeadsConfig(pooler_impl="gather")


def test_heads_and_fcos_need_cuda_or_an_explicit_device():
    if torch.cuda.is_available():
        return
    import dataclasses

    from spacecraft_pose_estimation_tpu_torch.models.cascade import CascadeROIHeads
    from spacecraft_pose_estimation_tpu_torch.models.fcos import FCOS, FCOS_TINY
    from spacecraft_pose_estimation_tpu_torch.models.rcnn import RCNN_TINY, GeneralizedRCNN

    for build in (lambda: FCOS(FCOS_TINY), lambda: CascadeROIHeads(),
                  lambda: GeneralizedRCNN(dataclasses.replace(RCNN_TINY, with_mask=True, with_keypoints=True))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_no_jax_check_covers_the_library_modules():
    """The detection library's rest (TTA, RegNet, deformable conv, ASPP and
    the tracker, rotated boxes, the structures, the LVIS and panoptic
    evaluators, the trainer's hooks) is under the import check above."""
    sources = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert {"models/tta.py", "models/regnet.py", "models/extra_layers.py", "ops/deform_conv.py",
            "ops/rotated_boxes.py", "structures.py", "data/lvis_panoptic.py", "data/coco_eval.py",
            "train/trainer.py"} <= sources


def test_tta_merge_launches_k4_or_raises_and_never_takes_the_plain_version(monkeypatch):
    """TTA's merge goes through ``nms.batched_nms_mask`` to K4's wrapper: on
    a tensor off the CPU (here the meta device, as no card is needed) that
    wrapper launches the kernel or raises, and the plain version is never
    called; the module names no plain version."""
    import inspect

    from spacecraft_pose_estimation_tpu_torch.models import tta
    from spacecraft_pose_estimation_tpu_torch.ops import nms

    tree = ast.parse(inspect.getsource(tta))
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert "batched_nms_mask" in names and "nms_mask_sorted_plain" not in names

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version was called")

    monkeypatch.setattr(nms, "nms_mask_sorted_plain", refuse)
    meta = torch.device("meta")

    def infer(images):
        b = images.shape[0]
        return {"boxes": torch.zeros(b, 3, 4, device=meta), "scores": torch.zeros(b, 3, device=meta),
                "classes": torch.zeros(b, 3, dtype=torch.int32, device=meta),
                "valid": torch.ones(b, 3, dtype=torch.bool, device=meta)}

    run = tta.make_tta_inference(infer, scales=(1.0,), flip=True, max_dets=4)
    with pytest.raises(ValueError, match="CUDA"):
        run(torch.zeros(2, 16, 16, 3, device=meta))


def test_library_modules_need_cuda_or_an_explicit_device():
    if torch.cuda.is_available():
        return
    from spacecraft_pose_estimation_tpu_torch.data.coco_eval import evaluate_rotated_detections
    from spacecraft_pose_estimation_tpu_torch.models.extra_layers import ASPP, IouTracker
    from spacecraft_pose_estimation_tpu_torch.models.regnet import REGNET_TINY, RegNet
    from spacecraft_pose_estimation_tpu_torch.ops.deform_conv import DeformConv

    for build in (lambda: RegNet(REGNET_TINY), lambda: DeformConv(4, 4), lambda: ASPP(4, 8), IouTracker,
                  lambda: evaluate_rotated_detections([{"boxes": np.zeros((0, 5)), "scores": np.zeros(0)}],
                                                      [{"boxes": np.zeros((0, 5))}])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert next(RegNet(REGNET_TINY, device="cpu").parameters()).device.type == "cpu"


def test_demo_benchmark_and_mesh_need_cuda_or_an_explicit_device(tmp_path):
    """``tools.demo``, ``tools.benchmark`` and ``parallel.make_mesh`` run on
    CUDA unless given the CPU, and raise where the card is missing, before
    any file is read or any process group is started."""
    if torch.cuda.is_available():
        return
    import torch.distributed as dist

    from spacecraft_pose_estimation_tpu_torch.parallel import make_mesh
    from spacecraft_pose_estimation_tpu_torch.tools import benchmark, demo

    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            demo.main(["--image", "f.png", "--checkpoint", str(tmp_path)] + extra)
        for task in ("data", "train", "train-det", "eval"):
            with pytest.raises(RuntimeError, match="--device cpu"):
                benchmark.main(["--task", task] + extra)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(device)
    assert not dist.is_initialized()


def test_no_jax_check_covers_the_tools_utils_and_parallel_modules():
    """The utils, the demo, the benchmark and ``parallel/`` keep their own
    copies of what they need: the import check above reaches each of them."""
    sources = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert {f"utils/{name}.py" for name in ("registry", "logger", "env", "collect_env", "serialize", "zipreader",
                                            "file_io", "memory", "analysis", "vis")} <= sources
    assert {"tools/demo.py", "tools/benchmark.py", "parallel/__init__.py", "parallel/mesh.py",
            "parallel/multihost.py"} <= sources


def test_no_jax_check_covers_the_projects_modules():
    """PointRend, PointSup, DeepLab and Panoptic-DeepLab (with its own copy of
    the target generator's numpy code) are under the import check above."""
    sources = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert {f"projects/{name}.py" for name in ("__init__", "point_rend", "pointsup", "deeplab",
                                               "panoptic_deeplab")} <= sources


def test_projects_modules_need_cuda_or_an_explicit_device():
    if torch.cuda.is_available():
        return
    from spacecraft_pose_estimation_tpu_torch.projects import deeplab, panoptic_deeplab, point_rend

    tiny = point_rend.PointRendConfig(fc_dim=8, num_fc=1)
    for build in (lambda: point_rend.PointRendMaskHead(tiny, 8), lambda: point_rend.ImplicitPointRendMaskHead(tiny, 8),
                  lambda: point_rend.PointRendSemSegHead(3, 8, fc_dim=8, num_fc=1),
                  lambda: point_rend.regular_grid_coords(2, 4),
                  lambda: deeplab.DeepLabResNet(deeplab.DEEPLAB_TINY),
                  lambda: deeplab.DeepLabV3Head(3, 16, aspp_channels=8),
                  lambda: deeplab.DeepLabV3PlusHead(3, (8, 16), aspp_channels=8, decoder_channels=(8, 8)),
                  lambda: panoptic_deeplab.PanopticDeepLabSemSegHead(3, (8, 16), decoder_channels=(8, 8)),
                  lambda: panoptic_deeplab.PanopticDeepLabInsEmbedHead((8, 16), decoder_channels=(8, 8))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert next(deeplab.DeepLabResNet(deeplab.DEEPLAB_TINY, device="cpu").parameters()).device.type == "cpu"


def test_no_jax_check_covers_the_last_projects_modules():
    """DensePose, TridentNet, ViTDet, MViTv2, TensorMask and Rethinking-BN take
    the point_rend resizes and ViTDet's rel-pos from the port's own modules:
    the import check above reaches each of them."""
    sources = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert {f"projects/{name}.py" for name in ("densepose", "tridentnet", "vitdet", "mvitv2", "tensormask",
                                               "rethinking_bn")} <= sources


def test_last_projects_modules_need_cuda_or_an_explicit_device():
    if torch.cuda.is_available():
        return
    from spacecraft_pose_estimation_tpu_torch.projects import densepose, mvitv2, rethinking_bn, tridentnet, vitdet

    dp = densepose.DensePoseConfig(num_stacked_convs=1, conv_head_dim=32, num_patches=3, decoder_channels=8)
    builds = (lambda: densepose.DensePoseHead(dp, 8), lambda: densepose.DensePoseDecoder(dp, 8),
              lambda: densepose.DensePoseHead(densepose.DensePoseConfig(**{**dp.__dict__, "head": "deeplab"}), 8),
              lambda: tridentnet.TridentStage(1, 8, 16, 4), lambda: vitdet.ViTDetBackbone(vitdet.VITDET_TINY, (64, 64)),
              lambda: mvitv2.MViTv2Backbone(mvitv2.MVITV2_TINY, (64, 64)),
              lambda: rethinking_bn.BNConvTower(2, 4, 8), lambda: rethinking_bn.CycleBatchNorm(2, 8))
    for build in builds:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    for module in (densepose.DensePoseHead(dp, 8, device="cpu"), tridentnet.TridentStage(1, 8, 16, 4, device="cpu"),
                   vitdet.ViTDetBackbone(vitdet.VITDET_TINY, (64, 64), device="cpu"),
                   mvitv2.MViTv2Backbone(mvitv2.MVITV2_TINY, (64, 64), device="cpu"),
                   rethinking_bn.BNConvTower(2, 4, 8, device="cpu")):
        assert next(module.parameters()).device.type == "cpu"
    # the layers inside them are built on the CPU, as models.layers' are, and placed by the module that holds them
    for layer in (densepose.DensePoseChartPredictor(dp, 8), tridentnet.TridentConv(4, 4),
                  tridentnet.TridentBottleneckBlock(8, 16, 4), vitdet.Attention(8, 2, True, (4, 4)),
                  mvitv2.MultiScaleAttention(8, 8, 1, 1, 1, True, True, (4, 4))):
        assert next(layer.parameters()).device.type == "cpu"
