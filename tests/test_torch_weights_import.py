"""Weights in and out: the port's ``utils/torch_import``, ``utils/zoo_import``,
``utils/torch_export`` and ``tools.import_weights`` / ``tools.export_weights``
against the JAX package's functions on the same synthetic files.

The sources are made by the JAX tests' own helpers over the port's seeded
``hrnet_tiny`` / ``RCNN_TINY`` modules (``convert.module_to_flax``), with
seeded noise on every leaf: ``hrnet_flax_to_torch`` for HRNet ``.pth``
files (plus ``num_batches_tracked``, as a real file has),
``test_d2_import.build_synthetic_sd`` for detectron2 ``.pth`` files and
``test_zoo_import.build_c2_pickle`` for Caffe2 ``.pkl`` files. The JAX side
is numpy and regex (``merge_pretrained`` over the port module's own tree);
only the CMS forward runs a JAX model. Checked:

* (i) a ``pose_hrnet``-named file, filtered and ``--all-layers``, at the
  destination's joint count and at another: the port's state dict equals
  JAX's ``merge_pretrained`` result carried through ``flax_to_state_dict``
  bit for bit, and the skipped leaves are JAX's;
* (ii) the CMS heads (``final_layer{N}_equal_to_image``) into
  ``hrnet_tiny_cms``: exact, and the forward of both packages agrees
  within the CMS test's 1e-5 of scale;
* (iii) a detectron2 ``.pth``: exact, the source's own tensors; the box
  head's forward equals the reference's NCHW flatten, which a copy of
  ``fc1`` by name alone does not;
* (iv) a Caffe2 ``.pkl`` (FrozenBN statistics left at 0/1) and a d2-native
  ``.pkl``: exact; ``c2_blob_to_d2_name`` equals JAX's over the X101
  zoo's 342 blobs and ``EXPECTED_D2``;
* (v) the export equals JAX's ``hrnet_flax_to_torch`` key for key and bit
  for bit, and import -> export is the identity (``tools.export_weights``
  on a checkpoint too);
* (vi) ``tools.import_weights`` on files: ``tools.train_detector
  --tiny`` resumes from the detector (keeping its own SGD weight decay
  and momentum) and ``tools.train_landmarks`` from the HRNet, beginning
  at epoch 1, as the JAX trainer does.
"""

import copy
import dataclasses
import json
import logging
import pickle

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.utils import torch_import as JTI
from spacecraft_pose_estimation_tpu.utils import zoo_import as JZI
from spacecraft_pose_estimation_tpu.utils.torch_export import hrnet_flax_to_torch as jax_export
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, module_to_flax
from spacecraft_pose_estimation_tpu_torch.data import coco_io
from spacecraft_pose_estimation_tpu_torch.models import build_landmark_model
from spacecraft_pose_estimation_tpu_torch.models.rcnn import RCNN_TINY, GeneralizedRCNN
from spacecraft_pose_estimation_tpu_torch.tools import export_weights, import_weights, train_detector, train_landmarks
from spacecraft_pose_estimation_tpu_torch.utils import torch_export as TE
from spacecraft_pose_estimation_tpu_torch.utils import torch_import as TI
from spacecraft_pose_estimation_tpu_torch.utils import zoo_import as ZI

from test_d2_import import build_synthetic_sd
from test_zoo_import import EXPECTED_D2, build_c2_pickle, c2_blob_names
from torch_port_util import few_threads, n, t, to_jax  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

J = 12


def perturbed(module, seed):
    """``module`` with seeded noise on every leaf (BN and FrozenBN variances
    kept in [0.5, 1.5]), so that a misplaced leaf shows."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, v in module.state_dict().items():
            noise = rng.uniform(0.5, 1.5, v.shape) if name.endswith(".var") else rng.normal(0, 0.1, v.shape)
            v.copy_(torch.from_numpy(noise.astype(np.float32)) + (0 if name.endswith(".var") else v))
    return module


def hrnet(name="hrnet_tiny", joints=J, seed=0):
    return build_landmark_model(name, joints, device="cpu", generator=torch.Generator().manual_seed(seed))


def detector(seed=0):
    return GeneralizedRCNN(RCNN_TINY, device="cpu", generator=torch.Generator().manual_seed(seed))


def with_batches_tracked(sd):
    """A reference file's tensors, with the ``num_batches_tracked`` entry of every BN."""
    out = {}
    for k, v in sd.items():
        out[k] = torch.as_tensor(np.ascontiguousarray(v))
        if k.endswith(".running_var"):
            out[k.removesuffix("running_var") + "num_batches_tracked"] = torch.tensor(7)
    return out


def hrnet_source(module):
    tree = module_to_flax(module)
    return with_batches_tracked(jax_export(tree["params"], tree["batch_stats"]))


def jax_merged(template, params, stats, caplog):
    """JAX's ``merge_pretrained`` over the module's tree -> (state dict, (count, first five skipped))."""
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=JTI.__name__):
        merged = JTI.merge_pretrained(module_to_flax(template), params, stats)
    logged = [r.args for r in caplog.records if r.name == JTI.__name__]
    return flax_to_state_dict(merged), (logged[0] if logged else (0, []))


def port_imported(template, params, stats):
    """The port's import into a copy of ``template`` -> (module, skipped, loaded)."""
    module = copy.deepcopy(template)
    skipped, loaded = TI.merge_pretrained(module, params, stats)
    return module, skipped, loaded


def assert_state_equal(got: dict, want: dict, skip=()):
    assert set(got) == set(want)
    for k, v in want.items():
        if not any(k.startswith(s) for s in skip):
            assert torch.equal(got[k], v), k


def same_tree(a, b):
    """Two partial trees with the same paths and bit-equal leaves."""
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, dict):
            same_tree(v, b[k])
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]))


# --- (i) HRNet pose_hrnet names ---------------------------------------------------------------


@pytest.mark.parametrize("layers", ["filtered", "all"])
@pytest.mark.parametrize("joints", [J, J + 2], ids=["same_joints", "other_joints"])
def test_hrnet_import_matches_jax(layers, joints, caplog):
    source = hrnet_source(perturbed(hrnet(joints=joints, seed=1), 1))
    assert any(k.endswith("num_batches_tracked") for k in source)
    pretrained = TI.ALL_LAYERS if layers == "all" else TI.PRETRAINED_LAYERS
    params, stats = TI.hrnet_torch_to_flax(source, pretrained)
    jparams, jstats = JTI.hrnet_torch_to_flax(source, pretrained)
    same_tree(params, jparams)
    same_tree(stats, jstats)
    assert ("final_layer" in params) == (layers == "all")
    template = hrnet(seed=2)
    want, jax_skipped = jax_merged(template, jparams, jstats, caplog)
    module, skipped, loaded = port_imported(template, params, stats)
    assert_state_equal(module.state_dict(), want)
    assert (len(skipped), skipped[:5]) == tuple(jax_skipped)
    mismatched = layers == "all" and joints != J
    assert skipped == (["/final_layer/kernel", "/final_layer/bias"] if mismatched else [])
    assert loaded == TI.count_leaves(params) + TI.count_leaves(stats) - len(skipped)
    # every trunk leaf is the source's; final_layer the source's only where it was imported and fits
    src = perturbed(hrnet(joints=joints, seed=1), 1).state_dict()
    keep_own = ("final_layer",) if layers == "filtered" or mismatched else ()
    got = module.state_dict()
    for k, v in got.items():
        assert torch.equal(v, template.state_dict()[k] if k.startswith(keep_own or ("-",)) else src[k]), k


# --- (ii) the CMS heads ------------------------------------------------------------------------


def test_cms_heads_import_matches_jax(caplog):
    src = perturbed(hrnet("hrnet_tiny_cms", seed=3), 3)
    source = hrnet_source(src)
    sd = src.state_dict()
    for i in range(4):  # final_layer_equal_to_image, final_layer2_equal_to_image, ...
        ref = f"final_layer{'' if i == 0 else i + 1}_equal_to_image"
        for unit, idx in (("deconv", 0), ("conv", 1)):
            for leaf in ("weight", "bias"):
                source[f"{ref}.{idx}.{leaf}"] = sd[f"head{i}.{unit}.{leaf}"].clone()
    params, stats = TI.hrnet_torch_to_flax(source, TI.ALL_LAYERS)
    jparams, jstats = JTI.hrnet_torch_to_flax(source, ("*",))
    same_tree(params, jparams)
    template = hrnet("hrnet_tiny_cms", seed=4)
    want, jax_skipped = jax_merged(template, jparams, jstats, caplog)
    module, skipped, _ = port_imported(template, params, stats)
    assert skipped == [] and tuple(jax_skipped) == (0, [])
    assert_state_equal(module.state_dict(), want)
    assert_state_equal(module.state_dict(), sd)
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JHRNet(config=dataclasses.replace(J_TINY.with_joints(J), head="cms"))
    merged = JTI.merge_pretrained(module_to_flax(template), jparams, jstats)
    want_hm = np.asarray(jm.apply(to_jax(merged), x, train=False))
    with torch.no_grad():
        got_hm = n(module(t(x)))
    np.testing.assert_allclose(got_hm, want_hm, atol=1e-5 * np.abs(want_hm).max())


# --- (iii) detectron2 .pth -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def det_source():
    src = perturbed(detector(seed=5), 5)
    return src, build_synthetic_sd(module_to_flax(src)["params"])


def test_detectron2_import_matches_jax(det_source, caplog):
    src, sd = det_source
    source = with_batches_tracked(sd)
    params = TI.detectron2_torch_to_flax(source)
    same_tree(params, JTI.detectron2_torch_to_flax(source))
    template = detector(seed=6)
    want, jax_skipped = jax_merged(template, params, {}, caplog)
    module, skipped, loaded = port_imported(template, params, {})
    assert skipped == [] and tuple(jax_skipped) == (0, []) and loaded == len(sd)
    assert_state_equal(module.state_dict(), want)
    assert_state_equal(module.state_dict(), src.state_dict())


def test_box_head_takes_the_nchw_flatten(det_source):
    """The imported fc1 gives the reference's ``torch.flatten`` of NCHW pooled
    features; fc1's d2 weight copied by name alone does not."""
    src, sd = det_source
    module = detector(seed=6)
    TI.merge_pretrained(module, TI.detectron2_torch_to_flax(sd), {})
    pooled = np.random.default_rng(8).normal(size=(5, 7, 7, 16)).astype(np.float32)
    w1, b1 = (t(sd[f"roi_heads.box_head.fc1.{k}"]) for k in ("weight", "bias"))
    w2, b2 = (t(sd[f"roi_heads.box_head.fc2.{k}"]) for k in ("weight", "bias"))
    nchw = t(pooled).permute(0, 3, 1, 2).reshape(5, -1)
    want = torch.relu(torch.relu(nchw @ w1.T + b1) @ w2.T + b2)
    head = module.roi_heads.box_head
    with torch.no_grad():
        got = head(t(pooled))
        np.testing.assert_allclose(n(got), n(want), atol=1e-4)
        head.fc1.weight.copy_(w1)  # the naive copy: the right name, the NCHW input order
        naive = head(t(pooled))
    assert (naive - want).abs().max() > 0.1 * want.abs().max()


# --- (iv) zoo .pkl ----------------------------------------------------------------------------------


def test_c2_blob_names_match_jax():
    blobs = c2_blob_names((3, 4, 23, 3))
    assert len(blobs) == 342
    for blob in blobs + list(EXPECTED_D2):
        assert ZI.c2_blob_to_d2_name(blob) == JZI.c2_blob_to_d2_name(blob), blob
    for blob, want in EXPECTED_D2.items():
        assert ZI.c2_blob_to_d2_name(blob) == want


@pytest.mark.parametrize("kind", ["caffe2", "d2_native"])
def test_zoo_pickle_import_matches_jax(det_source, kind, tmp_path, caplog):
    src, sd = det_source
    path = str(tmp_path / "model_final.pkl")
    if kind == "caffe2":
        build_c2_pickle(module_to_flax(src)["params"], path)
    else:
        with open(path, "wb") as f:
            pickle.dump({"model": sd, "__author__": "Detectron2 Model Zoo"}, f)
    params = ZI.zoo_pickle_to_flax(path)
    same_tree(params, JZI.zoo_pickle_to_flax(path))
    template = detector(seed=6)
    want, jax_skipped = jax_merged(template, params, {}, caplog)
    module, skipped, _ = port_imported(template, params, {})
    assert skipped == [] and tuple(jax_skipped) == (0, [])
    assert_state_equal(module.state_dict(), want)
    # a Caffe2 file has its BN absorbed: FrozenBN's mean and var keep the module's 0 and 1
    frozen = (".mean", ".var") if kind == "caffe2" else ()
    got, want_src = module.state_dict(), src.state_dict()
    for k, v in got.items():
        if k.endswith(frozen or ("-",)):
            assert torch.equal(v, template.state_dict()[k]), k
            assert float(v.abs().sum()) == (0.0 if k.endswith(".mean") else v.numel())
        else:
            assert torch.equal(v, want_src[k]), k


# --- (v) export -------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["hrnet_tiny", "hrnet_tiny_cms"])
def test_export_matches_jax_and_round_trips(name):
    module = perturbed(hrnet(name, seed=9), 9)
    tree = module_to_flax(module)
    want = jax_export(tree["params"], tree["batch_stats"])
    got = TE.export_hrnet(module)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and np.array_equal(n(got[k]), v), k
    assert not any(k.startswith("final_layer") and "equal_to_image" in k for k in got)  # no CMS head
    # import (every layer) -> export is the identity on what the export covers
    back = hrnet(name, seed=10)
    TI.merge_pretrained(back, *TI.hrnet_torch_to_flax(with_batches_tracked(want), TI.ALL_LAYERS))
    again = TE.export_hrnet(back)
    assert set(again) == set(got)
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_export_weights_tool_writes_the_checkpoint_as_pth(tmp_path):
    src = perturbed(hrnet(seed=11), 11)
    source = hrnet_source(src)
    torch.save(source, tmp_path / "w.pth")
    import_weights.main(["--torch-checkpoint", str(tmp_path / "w.pth"), "--kind", "hrnet", "--model", "hrnet_tiny",
                         "--num-joints", str(J), "--all-layers", "--output", str(tmp_path / "ck")])
    sd = export_weights.main(["--checkpoint", str(tmp_path / "ck"), "--model", "hrnet_tiny", "--num-joints",
                              str(J), "--output", str(tmp_path / "out" / "w.pth")])
    loaded = torch.load(tmp_path / "out" / "w.pth", weights_only=True)
    assert set(loaded) == set(sd) == {k for k in source if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(loaded[k], source[k].float()) for k in loaded)
    with pytest.raises(FileNotFoundError):
        export_weights.main(["--checkpoint", str(tmp_path / "none"), "--num-joints", str(J),
                             "--output", str(tmp_path / "x.pth")])


# --- (vi) the command, and the trainers resuming from it ---------------------------------------------


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """64x64 PNG frames: 4 with a bright box (detector), 8 with 12 dot landmarks (landmarks)."""
    root = tmp_path_factory.mktemp("import_scenes")
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(4):
        img = rng.integers(0, 40, (64, 64, 3)).astype(np.uint8)
        x0, y0 = (int(v) for v in rng.integers(4, 30, 2))
        w, h = (int(v) for v in rng.integers(14, 30, 2))
        img[y0:y0 + h, x0:x0 + w] = 230
        assert cv2.imwrite(str(root / f"d{i}.png"), img)
        images.append({"id": i, "file_name": f"d{i}.png", "height": 64, "width": 64})
        anns.append({"id": i, "image_id": i, "category_id": 1, "bbox": [x0, y0, w, h], "area": w * h, "iscrowd": 0})
    (root / "det.json").write_text(json.dumps({"images": images, "annotations": anns,
                                               "categories": [{"id": 1, "name": "spacecraft"}]}))
    images, anns = [], []
    for i in range(8):
        uv = rng.uniform(12, 52, (J, 2))
        img = np.zeros((64, 64, 3), np.uint8)
        for x, y in uv:
            cv2.circle(img, (int(x), int(y)), 1, (255, 255, 255), -1)
        assert cv2.imwrite(str(root / f"l{i}.png"), img)
        lo, hi = uv.min(0) - 2, uv.max(0) + 2
        images.append(coco_io.image_record(f"l{i}.png", 64, 64, i))
        anns.append(coco_io.keypoint_annotation(np.concatenate([uv, np.full((J, 1), 2.0)], 1),
                                                [lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1]], i, i))
    coco_io.save_coco(coco_io.build_coco_dict(images, anns, J), str(root / "lm.json"))
    return root


@pytest.mark.parametrize("fmt", ["pth", "pkl"])
def test_train_detector_resumes_from_an_import(scenes, fmt, tmp_path, monkeypatch, caplog):
    src = detector(seed=7)  # a trainable start: the perturbed source's raw-pixel logits blow up under SGD
    sd = build_synthetic_sd(module_to_flax(src)["params"])
    monkeypatch.setattr(import_weights, "FASTER_RCNN_X101_SPACECRAFT", RCNN_TINY)  # the trainer's --tiny
    if fmt == "pth":
        path = tmp_path / "model.pth"
        torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    else:
        path = tmp_path / "model_final.pkl"
        build_c2_pickle(module_to_flax(src)["params"], str(path))
    report = import_weights.main(["--torch-checkpoint", str(path), "--kind", "detectron2",
                                  "--output", str(tmp_path / "run" / "checkpoints")])
    assert report["skipped"] == [] and report["ignored"] == 0
    assert report["mapped"] == report["sources"]
    if fmt == "pth":
        assert report["sources"] == len(sd)
    saved = torch.load(tmp_path / "run" / "checkpoints" / "0" / "state.pt", weights_only=True)
    assert saved["optimizer"]["param_groups"][0]["weight_decay"] == 0.0  # the placeholder's
    assert json.loads((tmp_path / "run" / "checkpoints" / "meta_0.json").read_text()) == {"imported_from": str(path)}
    argv = ["--preset", "config_1", "--tiny", "--input-size", "64", "--batch-size", "2", "--train-json",
            str(scenes / "det.json"), "--image-dir", str(scenes), "--output", str(tmp_path / "run"),
            "--device", "cpu"]
    with caplog.at_level(logging.INFO, logger="train_detector"):
        start = train_detector.train(train_detector.parse_args(argv + ["--max-iter", "0"]),
                                     train_detector.DetectionExamples(str(scenes / "det.json"), str(scenes)))
    assert "resumed at update 0" in caplog.text
    imported = import_weights.GeneralizedRCNN(RCNN_TINY, device="cpu")
    imported.load_state_dict(saved["model"])
    assert_state_equal(start.state.model.state_dict(), imported.state_dict())
    group = start.state.optimizer.inner.param_groups[0]
    assert (group["weight_decay"], group["momentum"]) == (1e-4, 0.9)  # the trainer's own, not the file's 0
    trained = train_detector.train(train_detector.parse_args(argv + ["--max-iter", "2"]),
                                   train_detector.DetectionExamples(str(scenes / "det.json"), str(scenes)))
    assert trained.state.step == 2
    assert all(bool(torch.isfinite(v).all()) for v in trained.state.model.state_dict().values())


def test_train_landmarks_resumes_from_an_import_at_epoch_1(scenes, tmp_path, caplog):
    torch.save(hrnet_source(perturbed(hrnet(seed=12), 12)), tmp_path / "hrnet_w32.pth")
    report = import_weights.main(["--torch-checkpoint", str(tmp_path / "hrnet_w32.pth"), "--kind", "hrnet",
                                  "--model", "hrnet_tiny", "--num-joints", str(J), "--output",
                                  str(tmp_path / "out" / "checkpoints")])
    assert report["skipped"] == [] and report["ignored"] > 0  # num_batches_tracked, final_layer
    with caplog.at_level(logging.INFO, logger="train_landmarks"):
        train_landmarks.main(["--preset", "events", "--train-json", str(scenes / "lm.json"), "--image-dir",
                              str(scenes), "--output", str(tmp_path / "out"), "--device", "cpu",
                              "MODEL.NAME", "hrnet_tiny", "MODEL.IMAGE_SIZE", "[64, 64]", "MODEL.HEATMAP_SIZE",
                              "[16, 16]", "TRAIN.BATCH_SIZE_PER_CHIP", "4", "TEST.BATCH_SIZE_PER_CHIP", "4",
                              "MODEL.COMPUTE_DTYPE", "float32", "TRAIN.AUTO_RESUME", "True", "TRAIN.END_EPOCH", "2"])
    # the JAX trainer's rule: meta.get("epoch", 0) + 1, and an import's meta has no epoch
    assert "resumed from step 0 (epoch 1)" in caplog.text
    rows = [json.loads(line) for line in (tmp_path / "out" / "metrics.json").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [2]  # one epoch, the second, of 8 frames in batches of 4
    ck = tmp_path / "out" / "checkpoints"
    assert json.loads((ck / "meta_2.json").read_text()) == {"epoch": 1, "final": True}
