"""Port parity of the GT-conversion tools: ``data/coco_io``'s converters and split, ``data/catalog``,
``tools/split_images`` and ``tools/convert_to_coco``.

Numpy-seeded poses, landmarks and frame folders go through the JAX package
and the port on the CPU. Everything is pure Python and numpy on both
sides, so the dicts, lists and files are held **equal**, with one
exception: ``convert_to_coco speedplus`` builds R from the quaternion in
float32 in both packages (JAX without x64; the port's
``ops/geometry.quat_to_dcm`` on a float32 tensor), and the two float32
DCMs may differ by an ulp, so its keypoints, boxes and areas are held
within 1e-3 px (the area within what such a box allows) and every other
field equal. The JAX
tools run in this process with a patched ``sys.argv``.
"""

import json
import os
import runpy
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import scipy.io

from spacecraft_pose_estimation_tpu.data import catalog as jcat
from spacecraft_pose_estimation_tpu.data import coco_io as jcoco
from spacecraft_pose_estimation_tpu_torch.data import catalog as tcat
from spacecraft_pose_estimation_tpu_torch.data import coco_io as tcoco
from spacecraft_pose_estimation_tpu_torch.tools import convert_to_coco, split_images

ROOT = Path(__file__).resolve().parents[1]
PX_TOL = 1e-3


@contextmanager
def argv(args):
    old = sys.argv
    sys.argv = list(args)
    try:
        yield
    finally:
        sys.argv = old


def run_jax_tool(name, args):
    """``tools/<name>.py`` of the JAX package, in this process."""
    with argv([name] + [str(a) for a in args]):
        runpy.run_path(str(ROOT / "tools" / f"{name}.py"), run_name="__main__")


def random_poses(rng, b):
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec(rng.normal(size=(b, 3)) * 0.7).as_matrix()
    t = np.column_stack([rng.normal(size=(b, 2)) * 0.4, rng.uniform(3.0, 6.0, b)])
    return R, t


@pytest.mark.parametrize("case", ["plain", "distorted_speedplus", "shuffled", "ids_from_names"])
def test_poses_to_coco_equals_jax(case):
    rng = np.random.default_rng(0)
    R, t = random_poses(rng, 7)
    lm = rng.normal(size=(12, 3)) * 1.5  # some points leave a 64x48 frame
    K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]])
    names = [f"{i * 3}.png" for i in range(7)]
    kw = {"plain": dict(image_ids=list(range(7))),
          "distorted_speedplus": dict(image_ids=list(range(7)), dist=np.array([-0.2, 0.1, 1e-3, -2e-3, 0.01]),
                                      visibility_width=60, force_visible=True),
          "shuffled": dict(image_ids=list(range(10, 17)), shuffle_seed=0),
          "ids_from_names": dict(shuffle_seed=3)}[case]
    want = jcoco.poses_to_coco(names, R, t, lm, K, 64, 48, **kw)
    got = tcoco.poses_to_coco(names, R, t, lm, K, 64, 48, **kw)
    assert got == want
    # the frame cuts some keypoints: both visibilities occur unless forced
    vis = {v for a in got["annotations"] for v in a["keypoints"][2::3]}
    assert vis == ({2.0} if case == "distorted_speedplus" else {1.0, 2.0})


def test_visible_keypoints_and_landmarks_bbox_equal_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-20, 120, size=(50, 2))
    pts[:4] = [[0, 5], [100, 5], [5, 0], [5, 80]]  # on the edges: not strictly inside
    np.testing.assert_array_equal(tcoco.visible_keypoints(pts, 100, 80), jcoco.visible_keypoints(pts, 100, 80))
    for i in range(0, 50, 10):
        assert tcoco.landmarks_bbox(pts[i:i + 10]) == jcoco.landmarks_bbox(pts[i:i + 10])


@pytest.mark.parametrize("n,fractions,seed", [(0, (0.7, 0.15, 0.15), 0), (1, (0.7, 0.15, 0.15), 0),
                                              (47, (0.7, 0.15, 0.15), 0), (47, (0.5, 0.3, 0.2), 9),
                                              (200, (0.7, 0.15, 0.15), None)])
def test_split_files_equals_jax(n, fractions, seed):
    files = [f"{i:05d}.bmp" for i in range(n)]
    if seed is None:  # unseeded: random order, the split sizes still JAX's
        got, want = tcoco.split_files(files, fractions), jcoco.split_files(files, fractions)
        assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
        assert sorted(sum(got.values(), [])) == files
    else:
        assert tcoco.split_files(files, fractions, seed) == jcoco.split_files(files, fractions, seed)


def test_load_opencv_poses_reads_what_both_write(tmp_path):
    rng = np.random.default_rng(2)
    R, t = random_poses(rng, 3)
    jcoco.save_opencv_poses(["a.png", "b.png", "c.png"], R, t, str(tmp_path / "p.json"))
    assert tcoco.load_opencv_poses(str(tmp_path / "p.json")) == jcoco.load_opencv_poses(str(tmp_path / "p.json"))


def test_catalog_matches_jax(tmp_path):
    coco = jcoco.poses_to_coco(["0.png"], *random_poses(np.random.default_rng(3), 1), np.eye(3), np.eye(3), 8, 8,
                               image_ids=[0])
    path = str(tmp_path / "d.json")
    jcoco.save_coco(coco, path)
    for cat in (jcat, tcat):
        cat.DatasetCatalog.clear()
        cat.MetadataCatalog.clear()
        cat.register_coco_instances("synthetic_train", path, str(tmp_path))
    assert tcat.DatasetCatalog.get("synthetic_train") == jcat.DatasetCatalog.get("synthetic_train") == coco
    assert tcat.DatasetCatalog.list() == jcat.DatasetCatalog.list() == ["synthetic_train"]
    assert vars(tcat.MetadataCatalog.get("synthetic_train")) == vars(jcat.MetadataCatalog.get("synthetic_train"))
    with pytest.raises(KeyError, match="already registered"):
        tcat.register_coco_instances("synthetic_train", path, str(tmp_path))
    with pytest.raises(KeyError, match="not registered"):
        tcat.DatasetCatalog.get("missing")
    tcat.DatasetCatalog.remove("synthetic_train")
    assert tcat.DatasetCatalog.list() == []
    assert tcat.MetadataCatalog.get("new").name == "new"
    for cat in (jcat, tcat):
        cat.DatasetCatalog.clear()
        cat.MetadataCatalog.clear()


def write_frames(folder: Path, stems):
    import cv2

    folder.mkdir(parents=True, exist_ok=True)
    for s in stems:
        cv2.imwrite(str(folder / f"{s}.bmp"), np.full((8, 8, 3), s % 256, np.uint8))


def listing(folder: Path):
    return {split: sorted(os.listdir(folder / split)) for split in ("train", "validation", "test")}


@pytest.mark.parametrize("move", [False, True], ids=["copy", "move"])
def test_split_images_puts_the_same_files_in_the_same_splits(tmp_path, move):
    stems = [17 * i + 3 for i in range(23)]
    for pkg in ("jax", "port"):
        write_frames(tmp_path / pkg / "in", stems)
        (tmp_path / pkg / "in" / "notes.txt").write_text("not a frame")
    extra = ["--move"] if move else []
    run_jax_tool("split_images", ["--input-dir", tmp_path / "jax" / "in", "--output-dir", tmp_path / "jax" / "out",
                                  "--seed", "0", *extra])
    got = split_images.main(["--input-dir", str(tmp_path / "port" / "in"), "--output-dir",
                             str(tmp_path / "port" / "out"), "--seed", "0", *extra])
    assert listing(tmp_path / "port" / "out") == listing(tmp_path / "jax" / "out")
    assert {k: sorted(v) for k, v in got.items()} == listing(tmp_path / "port" / "out")
    assert sum(len(v) for v in got.values()) == len(stems)
    left = sorted(os.listdir(tmp_path / "port" / "in"))
    assert left == (["notes.txt"] if move else sorted([f"{s}.bmp" for s in stems] + ["notes.txt"]))


def write_blender_scene(root: Path, stems, rng):
    """Split folders of event frames named by stem, GT by stem, landmarks csv."""
    import pandas as pd

    lm = rng.normal(size=(12, 3)) * 0.5
    pd.DataFrame(lm, columns=["x", "y", "z"]).to_csv(root / "landmarks.csv", index=False)
    gt = root / "gt"
    gt.mkdir()
    R, t = random_poses(rng, len(stems))
    K = np.array([[72.0, 0, 40.0], [0, 72.0, 30.0], [0, 0, 1.0]])
    for s, Ri, ti in zip(stems, R, t):
        np.savetxt(str(gt / f"camera_intrinsics_{s}.txt"), K)
        (gt / f"pose_{s}.json").write_text(json.dumps({"rotation": Ri.tolist(), "translation": ti.tolist()}))
    splits = {"train": stems[:6], "validation": stems[6:8], "test": stems[8:]}
    for split, ss in splits.items():
        write_frames(root / "frames" / split, ss)


def test_convert_blender_equals_the_jax_tool(tmp_path):
    stems = [0, 20, 40, 60, 80, 100, 120, 140, 160, 180]
    write_blender_scene(tmp_path, stems, np.random.default_rng(4))
    common = ["blender", "--frames-dir", tmp_path / "frames", "--gt-dir", tmp_path / "gt", "--landmarks-file",
              tmp_path / "landmarks.csv", "--image-width", "80", "--image-height", "60"]
    run_jax_tool("convert_to_coco", common + ["--output-dir", tmp_path / "jax"])
    written = convert_to_coco.main([str(a) for a in common] + ["--output-dir", str(tmp_path / "port")])
    assert sorted(written) == ["test", "train", "validation"]
    for split in ("train", "validation", "test"):
        name = f"synthetic_{split}.json"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    coco = json.loads((tmp_path / "port" / "synthetic_train.json").read_text())
    assert sorted(im["id"] for im in coco["images"]) == stems[:6]
    assert [im["id"] for im in coco["images"]] != stems[:6]  # shuffled with seed 0


def write_speedplus(root: Path, rng, n=9):
    ppx = 5.86e-6
    cam = {"Nu": 1920, "Nv": 1200, "ppx": ppx, "ppy": ppx, "fx": 0.0175, "fy": 0.0175,
           "cameraMatrix": [[2988.6, 0, 960], [0, 2988.3, 600], [0, 0, 1]],
           "distCoeffs": [-0.22, 0.51, -6.6e-4, -2.1e-4, -0.13]}
    (root / "camera.json").write_text(json.dumps(cam))
    scipy.io.savemat(str(root / "pts.mat"), {"pts": rng.normal(size=(11, 3)) * 0.4 / ppx})
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.column_stack([rng.normal(size=(n, 2)) * 0.5, rng.uniform(4.0, 9.0, n)])
    names = ["img000000.jpg", "img000001.jpg"] + [f"img{i * 37:06d}.jpg" for i in range(2, n)]
    (root / "synthetic").mkdir()
    (root / "synthetic" / "train.json").write_text(json.dumps([
        {"filename": f, "q_vbs2tango_true": qi.tolist(), "r_Vo2To_vbs_true": ti.tolist()}
        for f, qi, ti in zip(names, q, t)]))


def test_convert_speedplus_matches_the_jax_tool(tmp_path):
    write_speedplus(tmp_path, np.random.default_rng(5))
    common = ["speedplus", "--dataset-dir", tmp_path, "--landmarks-mat", tmp_path / "pts.mat", "--camera-json",
              tmp_path / "camera.json"]
    run_jax_tool("convert_to_coco", common + ["--output-dir", tmp_path / "jax"])
    convert_to_coco.main([str(a) for a in common] + ["--output-dir", str(tmp_path / "port")])
    got = json.loads((tmp_path / "port" / "synthetic_train.json").read_text())
    want = json.loads((tmp_path / "jax" / "synthetic_train.json").read_text())
    assert got["images"] == want["images"]
    assert [im["id"] for im in got["images"]] == [0, 1] + [i * 37 for i in range(2, 9)]
    assert {k: v for k, v in got.items() if k != "annotations"} == {k: v for k, v in want.items()
                                                                      if k != "annotations"}
    err, area_err = 0.0, 0.0
    for a, b in zip(got["annotations"], want["annotations"], strict=True):
        for key in ("keypoints", "bbox"):
            err = max(err, float(np.abs(np.asarray(a[key]) - np.asarray(b[key])).max()))
        # the area w * h follows the box: a box within PX_TOL moves it by at most PX_TOL (w + h) + PX_TOL^2
        w, h = b["bbox"][2:]
        area_err = max(area_err, abs(a["area"] - b["area"]) / (PX_TOL * (w + h) + PX_TOL ** 2))
        assert {k: v for k, v in a.items() if k not in ("keypoints", "bbox", "area")} == \
            {k: v for k, v in b.items() if k not in ("keypoints", "bbox", "area")}
        assert a["keypoints"][2::3] == [2.0] * 11  # every keypoint visible
    print(f"speedplus: keypoints and boxes at most {err:.3g} px apart; areas at {area_err:.3g} of their bound")
    assert err <= PX_TOL and area_err <= 1.0
