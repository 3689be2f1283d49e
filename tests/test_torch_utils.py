"""Port parity of ``utils/``: the JAX package's own cases run on both packages side by side.

The cases of ``tests/test_utils_misc.py`` (vis, analysis, zipreader,
file_io, serialize, collect_env), ``tests/test_catalog_env.py``
(``TestEnv``, ``TestLogger``) and ``tests/test_config.py``
(``TestRetryOom``, ``TestRegistry``), each a case parametrised by package
where the two run the same code, then the port held to the JAX package on
the same numpy-seeded inputs. Bars, all exact:

* vis: the files of both packages decode to the same pixels (the port
  given tensors, channels-last heatmaps as both packages' models return
  them), ``save_debug_images`` with all four switches on;
* ``seed_all_rng``: the same Python and numpy draws after the same seed;
* ``retry_if_oom``: the same call sequence, [8, 4, 2, 2, 2, 2], and result;
* zip reads: byte-equal;
* the parameter table of ``HRNET_TINY`` with weights carried across: the
  same string;
* ``flops_of``: XLA's ``flops`` on a matmul and on a VALID convolution; on
  a SAME one, the port's count less 2 FLOPs for every out-of-bounds tap
  (computed here) is XLA's; on ``HRNET_TINY`` at 32^2, whose small maps
  make the padding taps a large share, and whose elementwise work XLA
  counts and PyTorch's counter does not, the port/XLA ratio measured once
  (946,432 / 826,060 = 1.1457) is pinned within 1e-3.
"""

import dataclasses
import importlib
import os
import pickle
import random
import sys
import zipfile
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet

from torch_port_util import few_threads, random_variables, to_jax  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

PKGS = ("spacecraft_pose_estimation_tpu", "spacecraft_pose_estimation_tpu_torch")
PORT = PKGS[1]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HRNET_FLOPS_RATIO = 1.1457  # port / XLA on HRNET_TINY with 2 joints at 32^2: 946,432 / 826,060, measured


def utils(pkg, name):
    return importlib.import_module(f"{pkg}.utils.{name}")


def both(name):
    return pytest.mark.parametrize("mod", [utils(p, name) for p in PKGS], ids=["jax", "torch"])


def read(path):
    img = cv2.imread(str(path))
    assert img is not None, path
    return img


# vis ------------------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vis_inputs():
    imgs = np.random.default_rng(0).uniform(0, 255, (3, 32, 32, 3))
    joints = np.random.default_rng(1).uniform(0, 31, (3, 5, 2))
    hms = np.random.default_rng(1).uniform(0, 1, (3, 8, 8, 5)).astype(np.float32)
    target = np.random.default_rng(2).uniform(0, 1, (3, 8, 8, 5)).astype(np.float32)
    return imgs, joints, np.ones((3, 5)), hms, target


def test_joint_grid_equals_jax(tmp_path, vis_inputs):
    imgs, joints, vis_w, _, _ = vis_inputs
    utils(PKGS[0], "vis").save_batch_image_with_joints(imgs, joints, vis_w, str(tmp_path / "j.jpg"))
    utils(PORT, "vis").save_batch_image_with_joints(torch.from_numpy(imgs), torch.from_numpy(joints),
                                                   torch.from_numpy(vis_w), str(tmp_path / "t.jpg"))
    np.testing.assert_array_equal(read(tmp_path / "t.jpg"), read(tmp_path / "j.jpg"))


def test_heatmap_grid_equals_jax(tmp_path, vis_inputs):
    imgs, _, _, hms, _ = vis_inputs
    utils(PKGS[0], "vis").save_batch_heatmaps(imgs, hms, str(tmp_path / "j.jpg"))
    utils(PORT, "vis").save_batch_heatmaps(torch.from_numpy(imgs), torch.from_numpy(hms), str(tmp_path / "t.jpg"))
    assert read(tmp_path / "j.jpg").shape == (3 * 8, 6 * 8, 3)
    np.testing.assert_array_equal(read(tmp_path / "t.jpg"), read(tmp_path / "j.jpg"))


def test_debug_images_equal_jax(tmp_path, vis_inputs):
    imgs, joints, vis_w, hms, target = vis_inputs
    debug = SimpleNamespace(save_batch_images_gt=True, save_batch_images_pred=True, save_heatmaps_gt=True,
                            save_heatmaps_pred=True)
    utils(PKGS[0], "vis").save_debug_images(debug, imgs, target, hms, joints, vis_w, str(tmp_path / "j" / "b0"))
    utils(PORT, "vis").save_debug_images(debug, torch.from_numpy(imgs), torch.from_numpy(target),
                                         torch.from_numpy(hms), torch.from_numpy(joints), torch.from_numpy(vis_w),
                                         str(tmp_path / "t" / "b0"))
    for suffix in ("gt", "pred", "hm_gt", "hm_pred"):
        np.testing.assert_array_equal(read(tmp_path / "t" / f"b0_{suffix}.jpg"), read(tmp_path / "j" / f"b0_{suffix}.jpg"))


def test_draw_detections_equals_jax():
    img = np.zeros((64, 64, 3), np.uint8)
    boxes, scores = np.array([[5, 5, 30, 30], [20, 30, 60, 50]]), np.array([0.9, 0.35])
    want = utils(PKGS[0], "vis").draw_detections(img, boxes, scores)
    got = utils(PORT, "vis").draw_detections(img, torch.from_numpy(boxes), torch.from_numpy(scores))
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_video_visualizer_stable_track_colors_equal_jax():
    frames = [(np.array([[5.0, 5, 30, 30]]), np.array([0.9])), (np.array([[7.0, 6, 32, 31]]), np.array([0.9])),
              (np.array([[9.0, 7, 34, 32], [40.0, 40, 60, 60]]), np.array([0.9, 0.8]))]
    img = np.zeros((64, 64, 3), np.uint8)
    vj = utils(PKGS[0], "vis").VideoVisualizer(iou_threshold=0.3)
    vt = utils(PORT, "vis").VideoVisualizer(iou_threshold=0.3, device="cpu")
    for boxes, scores in frames:
        want, ids_j = vj.draw_frame(img, boxes, scores)
        got, ids_t = vt.draw_frame(img, torch.from_numpy(boxes), torch.from_numpy(scores))
        assert ids_t == ids_j
        np.testing.assert_array_equal(got, want)
    # the same object drifting keeps one track; the far new one gets another id and color
    assert ids_t[0] == 0 and ids_t[1] != ids_t[0] and vt.color_for(ids_t[1]) != vt.color_for(ids_t[0])
    assert got.sum() > 0


# analysis -------------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    jm = JHRNet(config=dataclasses.replace(J_TINY, num_joints=2))
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False), seed=0)
    model = HRNet(dataclasses.replace(HRNET_TINY, num_joints=2), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    return jm, to_jax(variables), model


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_parameter_table_equals_jax(tiny_pair, depth):
    jm, variables, model = tiny_pair
    ja, ta = utils(PKGS[0], "analysis"), utils(PORT, "analysis")
    n = ta.parameter_count(model)
    assert n == ja.parameter_count(variables["params"]) > 1000
    table = ta.parameter_count_table(model, depth)
    assert "TOTAL" in table and f"{n:,d}" in table
    assert table == ja.parameter_count_table(variables["params"], depth)


def test_flops_match_xla_on_a_matmul_and_a_valid_conv():
    ja, ta = utils(PKGS[0], "analysis"), utils(PORT, "analysis")
    a, b = np.zeros((32, 64), np.float32), np.zeros((64, 48), np.float32)
    want = ja.flops_of(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))["flops"]
    assert ta.flops_of(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b)) == {"flops": want} \
        == {"flops": 196608.0}
    x, k = np.zeros((2, 16, 16, 8), np.float32), np.zeros((3, 3, 8, 12), np.float32)
    want = ja.flops_of(lambda x, k: jax.lax.conv_general_dilated(x, k, (1, 1), "VALID",
                                                                dimension_numbers=("NHWC", "HWIO", "NHWC")),
                       jnp.asarray(x), jnp.asarray(k))["flops"]
    got = ta.flops_of(F.conv2d, torch.zeros(2, 8, 16, 16), torch.zeros(12, 8, 3, 3))["flops"]
    assert got == want == 2.0 * 2 * 14 * 14 * 12 * 9 * 8


def test_flops_of_a_padded_conv_count_the_padding_taps():
    """XLA counts a SAME convolution's in-bounds taps, PyTorch's counter every tap."""
    ja, ta = utils(PKGS[0], "analysis"), utils(PORT, "analysis")
    b, hw, cin, cout, k = 2, 16, 8, 12, 3
    want = ja.flops_of(lambda x, w: jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                                                dimension_numbers=("NHWC", "HWIO", "NHWC")),
                       jnp.zeros((b, hw, hw, cin)), jnp.zeros((k, k, cin, cout)))["flops"]
    got = ta.flops_of(lambda x, w: F.conv2d(x, w, padding=1), torch.zeros(b, cin, hw, hw),
                      torch.zeros(cout, cin, k, k))["flops"]
    pos = np.arange(hw)[:, None] + np.arange(k)[None] - k // 2  # input row of output row i, tap j
    inside = ((pos >= 0) & (pos < hw)).sum()  # in-bounds (output, tap) pairs along one axis
    out_of_bounds = b * ((hw * k) ** 2 - inside**2)
    assert (got, want) == (884736.0, 812544.0)
    assert got - 2 * out_of_bounds * cin * cout == want


def test_flops_of_hrnet_tiny_against_xla(tiny_pair):
    jm, variables, model = tiny_pair
    ja, ta = utils(PKGS[0], "analysis"), utils(PORT, "analysis")
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(np.float32)
    want = ja.flops_of(lambda v, x: jm.apply(v, x, train=False), variables, jnp.asarray(x))["flops"]
    with torch.no_grad():
        got = ta.flops_of(model, torch.from_numpy(x))["flops"]
    print(f"HRNET_TINY flops: port {got:.0f}, XLA {want:.0f}, ratio {got / want:.4f}")
    assert abs(got / want - HRNET_FLOPS_RATIO) <= 1e-3


def test_model_summary_format(tiny_pair):
    jm, variables, model = tiny_pair
    x = torch.zeros(1, 32, 32, 3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = utils(PORT, "analysis").model_summary(model, x, train=True)
    want = utils(PKGS[0], "analysis").model_summary(jm, variables, jnp.zeros((1, 32, 32, 3)))
    params, flops, shape = got.split("  ")
    assert params == want.split("  ")[0] and shape == "input: (1, 32, 32, 3)"
    with torch.no_grad():
        count = utils(PORT, "analysis").flops_of(model, x)["flops"]
    assert count > 0 and flops == f"forward flops: {count / 1e9:.2f} GFLOP"  # not the nan of a failed count
    assert not model.training and all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


# zipreader, file_io, serialize ----------------------------------------------------------------------------------


@pytest.fixture
def zipped(tmp_path):
    img = np.random.default_rng(0).integers(0, 255, (16, 16, 3)).astype(np.uint8)
    zpath = str(tmp_path / "a.zip")
    with zipfile.ZipFile(zpath, "w") as z:
        z.writestr("x/img.png", cv2.imencode(".png", img)[1].tobytes())
        z.writestr("inner/data.txt", "zipped")
    return zpath, img


def test_zip_reads_are_byte_equal_to_jax(zipped):
    zpath, img = zipped
    zj, zt = utils(PKGS[0], "zipreader"), utils(PORT, "zipreader")
    assert zt.is_zip_path(f"{zpath}@x/img.png") and not zt.is_zip_path(zpath)
    assert zt.read_bytes(zpath, "x/img.png") == zj.read_bytes(zpath, "x/img.png")
    out = zt.imread(f"{zpath}@x/img.png")
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(out, zj.imread(f"{zpath}@x/img.png"))
    zt.close_all()
    zj.close_all()


@both("file_io")
def test_file_io_local_roundtrip(mod, tmp_path):
    p = str(tmp_path / "sub" / "x.txt")
    with mod.PathManager.open(p, "w") as f:  # mkdirs on write
        f.write("hello")
    assert mod.PathManager.exists(p) and mod.PathManager.isfile(p)
    with mod.PathManager.open(p) as f:
        assert f.read() == "hello"
    assert mod.PathManager.ls(str(tmp_path / "sub")) == ["x.txt"]
    mod.PathManager.copy(p, str(tmp_path / "c" / "y.txt"))
    assert (tmp_path / "c" / "y.txt").read_text() == "hello"


@both("file_io")
def test_file_io_zip_scheme(mod, zipped):
    zpath, _ = zipped
    uri = f"zip://{zpath}!inner/data.txt"
    assert mod.PathManager.exists(uri)
    with mod.PathManager.open(uri) as f:
        assert f.read() == "zipped"
    with mod.PathManager.open(uri, "rb") as f:
        assert f.read() == b"zipped"
    assert not mod.PathManager.exists(f"zip://{zpath}!missing")
    with pytest.raises(ValueError, match="read-only"):
        mod.PathManager.open(uri, "w")
    utils(mod.__name__.rsplit(".", 2)[0], "zipreader").close_all()


@both("file_io")
def test_file_io_spe_scheme_resolves_in_its_own_package(mod):
    pkg = mod.__name__.split(".")[0]
    assert mod.PathManager.exists("spe://utils/file_io.py")
    assert mod.PathManager.get_local_path("spe://utils/file_io.py") == os.path.join(ROOT, pkg, "utils", "file_io.py")


@both("serialize")
def test_picklable_wrapper_lambda(mod):
    w = mod.PicklableWrapper(lambda x: x * 3)
    w2 = pickle.loads(pickle.dumps(w))
    assert w2(7) == 21


@both("serialize")
def test_robust_dumps_closure(mod):
    k = 5
    fn = mod.robust_loads(mod.robust_dumps(lambda x: x + k))
    assert fn(1) == 6
    assert mod.robust_loads(mod.robust_dumps({"a": [1, 2]})) == {"a": [1, 2]}


def test_serialize_without_cloudpickle_raises_clearly(monkeypatch):
    ser = utils(PORT, "serialize")
    monkeypatch.setitem(sys.modules, "cloudpickle", None)  # import cloudpickle now raises ImportError
    assert ser.robust_loads(ser.robust_dumps([1, 2])) == [1, 2]  # plain pickle needs none
    with pytest.raises(RuntimeError, match="cloudpickle"):
        ser.robust_dumps(lambda x: x)
    with pytest.raises(RuntimeError, match="cloudpickle"):
        pickle.dumps(ser.PicklableWrapper(lambda x: x))


# env, collect_env, logger ---------------------------------------------------------------------------------------


def test_seed_all_rng_draws_equal_jax():
    ej, et = utils(PKGS[0], "env"), utils(PORT, "env")
    draws = []
    for env in (ej, et):
        assert env.seed_all_rng(123) == 123
        draws.append((np.random.rand(3), random.random(), os.environ["PYTHONHASHSEED"]))
    np.testing.assert_array_equal(draws[1][0], draws[0][0])
    assert draws[1][1:] == draws[0][1:]
    et.seed_all_rng(7)
    a = torch.rand(3)
    torch.manual_seed(7)
    assert torch.equal(a, torch.rand(3))


@both("env")
def test_random_seed_returned(mod):
    s = mod.seed_all_rng(None)
    assert 0 <= s < 2**31


@pytest.mark.parametrize("pkg,keys", [(PKGS[0], ("jax:", "backend:")), (PORT, ("torch:", "backend:", "cuda:"))],
                         ids=["jax", "torch"])
def test_env_collect_env(pkg, keys):
    info = utils(pkg, "env").collect_env_info()
    assert all(k in info for k in keys), info


@pytest.mark.parametrize("pkg,keys", [(PKGS[0], ("jax", "numpy", "Python", "devices")),
                                      (PORT, ("torch", "numpy", "Python", "devices", "torch.version.cuda"))],
                         ids=["jax", "torch"])
def test_collect_env_report_has_core_rows(pkg, keys):
    info = utils(pkg, "collect_env").collect_env_info()
    for key in keys:
        assert key in info, info
    if pkg == PORT:
        assert "jax" not in info and "SPE_PLATFORM" not in info


@both("logger")
def test_file_logging(mod, tmp_path):
    lg = mod.setup_logger(str(tmp_path), name=f"spe_test_{mod.__name__.split('.')[0]}")
    lg.info("hello world")
    for h in lg.handlers:
        h.flush()
    assert "hello world" in (tmp_path / "log.txt").read_text()


@both("logger")
def test_output_tree(mod, tmp_path):
    final, tb = mod.create_output_tree(str(tmp_path), "events", "pose_hrnet", "cfg1")
    assert os.path.isdir(final) and os.path.isdir(tb)
    assert final.endswith(os.path.join("events", "pose_hrnet", "cfg1"))
    assert os.path.dirname(tb) == str(tmp_path / "log" / "events" / "pose_hrnet")


# memory, registry -----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("error", [RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
                                   torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 96.00 GiB")],
                         ids=["xla_text", "torch_oom"])
def test_retry_if_oom_same_calls_and_result_as_jax(error):
    results, calls = [], {}
    for pkg, ones in ((PKGS[0], jnp.ones((8, 3)) * jnp.arange(8.0)[:, None]),
                      (PORT, torch.ones(8, 3) * torch.arange(8.0)[:, None])):
        seen = calls.setdefault(pkg, [])

        def fn(x):
            seen.append(x.shape[0])
            if x.shape[0] > 2:
                raise error if pkg == PORT else RuntimeError("RESOURCE_EXHAUSTED: out of memory")
            return x * 2

        results.append(np.asarray(utils(pkg, "memory").retry_if_oom(fn)(ones)))
    assert calls[PORT] == calls[PKGS[0]] == [8, 4, 2, 2, 2, 2]
    np.testing.assert_array_equal(results[1], results[0])


def test_retry_if_oom_reraises_other_errors_and_gives_up():
    mem = utils(PORT, "memory")
    calls = []

    def broken(x):
        calls.append(x.shape[0])
        raise ValueError("not memory")

    with pytest.raises(ValueError):
        mem.retry_if_oom(broken)(torch.ones(8))
    assert calls == [8]

    def always(x):
        raise torch.OutOfMemoryError("out of memory")

    with pytest.raises(MemoryError, match="8-way"):
        mem.retry_if_oom(always)(torch.ones(8))
    with pytest.raises(torch.OutOfMemoryError):  # a lead too short to split: the OOM itself
        mem.retry_if_oom(always)(torch.ones(1))


@both("registry")
def test_registry_register_and_get(mod):
    reg = mod.Registry("models")

    @reg.register
    def thing():
        return 42

    reg.register(name="other")(lambda: 7)
    assert reg.get("thing")() == 42 and reg.get("other")() == 7
    assert "thing" in reg and dict(reg).keys() == {"thing", "other"}
    with pytest.raises(KeyError, match="not found in registry models"):
        reg.get("missing")
    with pytest.raises(KeyError, match="already registered in models"):
        reg.register(thing)
