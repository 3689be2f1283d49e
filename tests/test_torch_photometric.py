"""Port parity of the photometric stacks: ``data/augment.py``'s event and SPEED+ stacks and their helpers,
and ``tools/train_detector --photometric-augs``.

Each test feeds numpy-seeded images (3 of 96x128x3 float32 in [0, 255])
and JAX's own random draws, rebuilt here from its keys with the splits
``augment.py`` makes (``jax_draws``), to the JAX function and to its port
on the CPU. The JAX functions run eagerly, as the JAX package's tests run
them; the trainer's batch goes through the JAX trainer's jitted ``aug_fn``.

* exact (every value equal): ``event_noise``, ``fill_black``,
  ``event_lines`` (a scatter-max of white dots), ``radial_fade``, ``blend``
  and the event stack, also through the trainer;
* within 1e-3 grey: the blurs (float32 sums in another order), the warps
  on smooth images, and every SPEED+ function and its stack.
  ``random_stars``, ``random_haze`` and ``random_streaks`` threshold a
  blurred field; a pixel within an ulp of its threshold may fall on the
  other side in the other package. The tests count those flips (each
  package's own pre-threshold field against the threshold) against a bar
  of 1e-3 of the pixels, and hold the output to 1e-3 grey away from the
  flipped pixels' footprint (the later blurs' and warps' reach).
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.data import augment as jaug
from spacecraft_pose_estimation_tpu_torch.data import augment as taug

from torch_port_util import few_threads, n, smooth_frames, t

pytestmark = pytest.mark.usefixtures("few_threads")
B, H, W = 3, 96, 128
GREY_TOL = 1e-3
FLIP_BAR = 1e-3  # flipped threshold pixels, a share of the (B, H, W) field
jr = jax.random


# --- JAX's draws, by the splits of augment.py -----------------------------

def _noise(ks, h, w):
    return {"std": jr.uniform(ks[0], (), minval=0.03, maxval=0.05),
            "mean": jr.uniform(ks[1], (), minval=0.05, maxval=0.15), "noise": jr.normal(ks[2], (h, w, 1))}


def _event_noise(key, h, w):
    k1, k2, k3 = jr.split(key, 3)
    return {"t": jr.uniform(k1, (), minval=0.001, maxval=0.05), "u": jr.uniform(k2, (h, w)), "apply": jr.uniform(k3)}


def _event_lines(key, h, w, max_points=2048):
    k0, *lks = jr.split(key, 4)
    lines = []
    for lk in lks:
        ks = jr.split(lk, 6)
        x_shift = jr.uniform(ks[1], (), minval=-200.0, maxval=200.0)
        lines.append({"skip": jr.uniform(ks[0]), "x_shift": x_shift,
                      "x1": jr.uniform(ks[2], (), minval=x_shift, maxval=w - x_shift),
                      "density": jr.randint(ks[3], (), 100, 10000),
                      "jx": jr.uniform(ks[4], (max_points,), minval=-5.0, maxval=5.0),
                      "jy": jr.uniform(ks[5], (max_points,), minval=-100 + x_shift / 2, maxval=100 - x_shift / 2)})
    return {k: jnp.stack([ln[k] for ln in lines]) for k in lines[0]} | {"skip_all": jr.uniform(k0)}


def _stars(key, h, w):
    ks = jr.split(key, 4)
    return _noise(ks, h, w) | {"sigma2": jr.uniform(ks[3], (), minval=1.5, maxval=2.0),
                               "apply": jr.randint(jr.fold_in(key, 7), (), 0, 2)}


def _haze(key, h, w):
    ks = jr.split(key, 5)
    return _noise(ks, h, w) | {"thresh": jr.randint(ks[3], (), 125, 140),
                               "sigma": jr.uniform(ks[4], (), minval=25.0, maxval=40.0),
                               "weight": jr.uniform(jr.fold_in(key, 9), (), minval=0.1, maxval=0.8)}


def _flares(key, h, w, max_flares=9):
    ks = jr.split(key, 2)
    per = []
    for i in range(max_flares):
        k = jr.fold_in(ks[1], i)
        kk = jr.split(k, 6)
        per.append({"cx": jr.randint(kk[0], (), w // 2 - 500, w // 2 + 500),
                    "cy": jr.randint(kk[1], (), h // 2 - 400, h // 2 + 400),
                    "radius": jr.randint(kk[2], (), 5, 100), "angle": jr.randint(kk[3], (), 0, 180),
                    "shear": jr.uniform(kk[4], (), minval=0.0, maxval=0.75),
                    "sigma": jr.uniform(kk[5], (), minval=1.0, maxval=5.0),
                    "gain": jr.uniform(jr.fold_in(k, 11), (), minval=0.4, maxval=1.2)})
    return {k: jnp.stack([p[k] for p in per]) for k in per[0]} | {
        "n": jr.randint(ks[0], (), 1, max_flares + 1),
        "weight": jr.uniform(jr.fold_in(key, 13), (), minval=0.0, maxval=1.0)}


def _streaks(key, h, w):
    ks = jr.split(key, 8)
    kdir, kscale, krot, kw = jr.split(ks[7], 4)
    return _noise(ks, h, w) | {
        "thresh": jr.randint(ks[3], (), 150, 200), "amount": jr.uniform(ks[4], (), minval=0.01, maxval=0.04),
        "cx": jr.randint(ks[5], (), 0, w), "cy": jr.randint(ks[6], (), 0, h), "horizontal": jr.randint(kdir, (), 0, 2),
        "stretch": jr.uniform(kscale, (), minval=2.0, maxval=4.0),
        "angle": jr.uniform(krot, (), minval=0.0, maxval=jnp.pi), "weight": jr.uniform(kw, (), minval=0.0, maxval=1.0)}


def _bloom(key, h, w):
    return {"offset": jr.randint(jr.fold_in(key, 0), (), 10, 100)}


def _erasing(key, h, w):
    ks = jr.split(key, 4)
    eh = (jr.uniform(ks[0], (), minval=0.05, maxval=0.3) * h).astype(jnp.int32)
    ew = (jr.uniform(ks[1], (), minval=0.05, maxval=0.3) * w).astype(jnp.int32)
    return {"rects": jnp.stack([eh, ew, jr.randint(ks[2], (), 0, h), jr.randint(ks[3], (), 0, w)])}


JAX_DRAWS = {"event_noise": _event_noise, "event_lines": _event_lines, "fill_black": lambda key, h, w: {},
             "random_stars": _stars, "random_haze": _haze, "random_flares": _flares, "random_streaks": _streaks,
             "random_bloom": _bloom, "random_erasing": _erasing}


def jax_draws(name, keys, h=H, w=W) -> dict:
    """The draws JAX's ``name`` makes from each image's key, stacked over the batch, as CPU tensors."""
    per = [JAX_DRAWS[name](k, h, w) for k in keys]
    return {k: t(np.stack([np.asarray(p[k]) for p in per])) for k in per[0]}


def stack_draws(names, keys, h=H, w=W) -> list[dict]:
    """``apply_stack``'s draws: stage i from fold_in(key, i) of each image's key."""
    return [jax_draws(name, [jr.fold_in(k, i) for k in keys], h, w) for i, name in enumerate(names)]


def run_jax(fn, keys, images):
    return np.stack([np.asarray(fn(k, jnp.asarray(im))) for k, im in zip(keys, images)])


def images(seed=0, b=B, h=H, w=W) -> np.ndarray:
    return smooth_frames(seed, b, h, w).astype(np.float32)


def keys(seed, b=B):
    return list(jr.split(jr.key(seed), b))


# --- comparisons -----------------------------------------------------------

def flipped(field_t, field_j, thresh) -> np.ndarray:
    """(B, H, W) pixels on other sides of the threshold in the two packages."""
    thresh = np.asarray(thresh, np.float32).reshape(-1, 1, 1)
    return (n(field_t)[..., 0] < thresh) != (np.asarray(field_j)[..., 0] < thresh)


def footprint(mask: np.ndarray, reach: int) -> np.ndarray:
    """Pixels within ``reach`` (Chebyshev) of a set pixel of (B, H, W) ``mask``."""
    out = mask.copy()
    for b in range(mask.shape[0]):
        for y, x in zip(*np.nonzero(mask[b])):
            out[b, max(y - reach, 0):y + reach + 1, max(x - reach, 0):x + reach + 1] = True
    return out


def assert_close_away_from(got, want, flips: np.ndarray, reach: int, tol=GREY_TOL):
    """``got`` within ``tol`` of ``want`` wherever no flip lies within ``reach``."""
    share = flips.mean()
    assert share <= FLIP_BAR, f"threshold flips {flips.sum()} ({share:.2e}) over the bar {FLIP_BAR}"
    keep = ~footprint(flips, reach)
    err = np.abs(n(got) - np.asarray(want))[keep]
    print(f"flips {int(flips.sum())}, max |err| away from them {err.max():.3g}")
    assert err.max() <= tol, err.max()


# --- the helpers -----------------------------------------------------------

@pytest.mark.parametrize("case", ["fixed", "per_image_sigma", "truncated"])
def test_gaussian_blur_matches_jax(case):
    x = images(1)
    sig = np.array([0.8, 2.5, 10.0], np.float32)
    trunc = np.array([19, 40, 109], np.int32)
    kw_t = {"fixed": (3.5, 21, None), "per_image_sigma": (t(sig), 31, None), "truncated": (10.0, 109, t(trunc))}[case]
    got = taug.gaussian_blur(t(x), *kw_t)
    for i in range(B):
        s = 3.5 if case == "fixed" else (10.0 if case == "truncated" else sig[i])
        ks = kw_t[1]
        want = jaug.gaussian_blur(jnp.asarray(x[i]), s, ks, trunc_ksize=trunc[i] if case == "truncated" else None)
        np.testing.assert_allclose(n(got[i]), np.asarray(want), atol=GREY_TOL, rtol=0)


@pytest.mark.parametrize("trunc", [None, (15, 60, 105)], ids=["full", "truncated"])
def test_box_blur_matches_jax(trunc):
    x = images(2)
    got = taug.box_blur(t(x), 105, None if trunc is None else torch.tensor(trunc))
    for i in range(B):
        want = jaug.box_blur(jnp.asarray(x[i]), 105, None if trunc is None else trunc[i])
        np.testing.assert_allclose(n(got[i]), np.asarray(want), atol=GREY_TOL, rtol=0)


def test_warps_match_jax():
    """Scale, shear and rotation about the centre, bilinear with a zero
    border, on smooth images: within 1e-3 grey (the port inverts the 2x2
    in closed form, JAX by LU)."""
    x = images(3)
    sx, sy = np.array([1.5, 2.7, 0.8], np.float32), np.array([1.8, 1.0, 3.1], np.float32)
    shear = np.array([0.0, 0.3, 0.74], np.float32)
    ang = np.array([0.0, 37.0, 3.1], np.float32)
    got = [taug.scale_warp(t(x), t(sx), t(sy)), taug.shear_warp(t(x), t(shear)),
           taug.rotate_about_center(t(x), t(ang))]
    for i in range(B):
        xi = jnp.asarray(x[i])
        want = [jaug.scale_warp(xi, sx[i], sy[i]), jaug.shear_warp(xi, shear[i]),
                jaug.rotate_about_center(xi, ang[i])]
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(n(g[i]), np.asarray(wnt), atol=GREY_TOL, rtol=0)


def test_exact_functions_match_jax():
    """``fill_black``, ``radial_fade`` and ``blend`` equal JAX's."""
    x = images(4)
    x[0, :20] = 50.0  # a black band for fill_black
    src = images(5)
    wgt = np.array([0.1, 0.55, 1.0], np.float32)
    got_fill, got_fade = taug.fill_black(t(x)), taug.radial_fade(t(x))
    got_blend = taug.blend(t(x), t(src), t(wgt))
    for i in range(B):
        xi = jnp.asarray(x[i])
        np.testing.assert_array_equal(n(got_fill[i]), np.asarray(jaug.fill_black(xi)))
        np.testing.assert_array_equal(n(got_fade[i]), np.asarray(jaug.radial_fade(xi)))
        np.testing.assert_array_equal(n(got_blend[i]), np.asarray(jaug.blend(xi, jnp.asarray(src[i]), wgt[i])))


def test_radial_blur_matches_jax():
    x = images(6)
    amount, cx, cy = np.array([0.01, 0.025, 0.04], np.float32), np.array([0, 64, 127]), np.array([95, 48, 3])
    got = taug.radial_blur(t(x), t(amount), t(cx), t(cy))
    for i in range(B):
        want = jaug.radial_blur(jnp.asarray(x[i]), amount[i], jnp.float32(cx[i]), jnp.float32(cy[i]))
        np.testing.assert_allclose(n(got[i]), np.asarray(want), atol=GREY_TOL, rtol=0)


# --- the stack functions ---------------------------------------------------

@pytest.mark.parametrize("name", ["event_noise", "event_lines"])
def test_event_functions_equal_jax(name):
    x = images(7)
    ks = keys(10)
    draws = jax_draws(name, ks)
    got = {"event_noise": taug.event_noise, "event_lines": taug.event_lines}[name](t(x), draws)
    want = run_jax(getattr(jaug, name), ks, x)
    np.testing.assert_array_equal(n(got), want)
    # the lines drew something: some images, not all, get white dots
    if name == "event_lines":
        assert (n(got) != x).any()


@pytest.mark.parametrize("seed", [11, 12])
def test_random_stars_match_jax(seed):
    x = images(seed)
    ks = keys(seed)
    d = jax_draws("random_stars", ks)
    got = taug.random_stars(t(x), d)
    want = run_jax(jaug.random_stars, ks, x)
    field_j = [jaug.gaussian_blur(jnp.broadcast_to(
        jnp.clip((255.0 * float(d["std"][i])) * (255.0 * jnp.asarray(n(d["noise"][i]))) + 255.0 * float(d["mean"][i]),
                 0.0, 255.0), (H, W, 3)), 3.5, 21)[..., :1] for i in range(B)]
    flips = flipped(taug.star_field(t(x), d), np.stack(field_j), 160.0)
    assert_close_away_from(got, want, flips, reach=6)


def test_random_haze_matches_jax():
    x = images(13)
    ks = keys(13)
    d = jax_draws("random_haze", ks)
    got = taug.random_haze(t(x), d)
    want = run_jax(jaug.random_haze, ks, x)
    field_j = np.stack([np.asarray(jaug.gaussian_blur(jnp.broadcast_to(jnp.clip(
        (255.0 * float(d["std"][i])) * (255.0 * jnp.asarray(n(d["noise"][i]))) + 255.0 * float(d["mean"][i]),
        0.0, 255.0), (H, W, 3)), 5.0, 31))[..., :1] for i in range(B)])
    flips = flipped(taug.haze_field(t(x), d), field_j, n(d["thresh"]).astype(np.float32))
    # the 1.5 x 1.8 stretch and the 121-tap blur spread a flip over the frame
    assert_close_away_from(got, want, flips, reach=max(H, W))


def test_random_streaks_match_jax():
    x = images(14)
    ks = keys(14)
    d = jax_draws("random_streaks", ks)
    got = taug.random_streaks(t(x), d)
    want = run_jax(jaug.random_streaks, ks, x)
    field_j = np.stack([np.asarray(jaug.gaussian_blur(jnp.broadcast_to(jnp.clip(
        (255.0 * float(d["std"][i])) * (255.0 * jnp.asarray(n(d["noise"][i]))) + 255.0 * float(d["mean"][i]),
        0.0, 255.0), (H, W, 3)), 1.0, 7))[..., :1] for i in range(B)])
    flips = flipped(taug.streak_field(t(x), d), field_j, n(d["thresh"]).astype(np.float32))
    # the radial blur, a stretch of up to 4 and a rotation move a flip far
    assert_close_away_from(got, want, flips, reach=max(H, W))


@pytest.mark.parametrize("name", ["random_flares", "random_bloom"])
def test_flares_and_bloom_match_jax(name):
    x = images(15)
    ks = keys(15)
    d = jax_draws(name, ks)
    got = getattr(taug, name)(t(x), d)
    want = run_jax(getattr(jaug, name), ks, x)
    np.testing.assert_allclose(n(got), want, atol=GREY_TOL, rtol=0)


def test_flares_reach_off_a_small_frame():
    """The flare centres are drawn from w//2 +- 500 and h//2 +- 400, far off
    a 96x128 frame: the stack draws them so, and the draws JAX makes hold
    such centres too (the flares then lie outside and the canvas stays 0)."""
    d = taug.sample_random_flares(torch.Generator().manual_seed(0), 64, H, W)
    cx = d["cx"]
    assert (cx < 0).any() and (cx >= W).any()
    dj = jax_draws("random_flares", keys(16, 16))
    assert ((dj["cx"] < 0) | (dj["cx"] >= W)).any()


def test_random_erasing_in_the_registry_matches_jax():
    x = images(17)
    ks = keys(17)
    got = taug.apply_stack(t(x), ("random_erasing",), [jax_draws("random_erasing", ks)])
    np.testing.assert_array_equal(n(got), run_jax(jaug.random_erasing, ks, x))


# --- the stacks ------------------------------------------------------------

@pytest.mark.parametrize("stack", ["event", "speedplus"])
def test_apply_stack_matches_jax(stack):
    names = taug.EVENT_STACK if stack == "event" else taug.SPEEDPLUS_STACK
    assert names == (jaug.EVENT_STACK if stack == "event" else jaug.SPEEDPLUS_STACK)
    x = images(20)
    ks = keys(20)
    got = taug.apply_stack(t(x), names, stack_draws(names, ks))
    want = run_jax(lambda k, im: jaug.apply_stack(k, im, names), ks, x)
    if stack == "event":
        np.testing.assert_array_equal(n(got), want)
    else:
        err = np.abs(n(got) - want)
        print(f"SPEED+ stack: max |err| {err.max():.3g}")
        assert err.max() <= GREY_TOL


def test_sampled_stacks_run_and_stay_in_range():
    """The port's own draws (a generator on the images' device, one seed
    the same draws) give finite images in [0, 255]."""
    x = t(images(21))
    for names in (taug.EVENT_STACK, taug.SPEEDPLUS_STACK):
        a, b = (taug.apply_stack(x, names, taug.sample_stack(taug.stack_generator(42, 3, "cpu"), B, H, W, names))
                for _ in range(2))
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
        assert float(a.min()) >= 0.0 and float(a.max()) <= 255.0 and not torch.equal(a, x)


# --- the detector trainer: --photometric-augs -----------------------------

from test_torch_train_detector_entry import args as det_args, scene  # noqa: E402,F401  (the tiny scene fixture)


@pytest.mark.parametrize("stack", ["event", "speedplus"])
def test_trainer_batch_equals_jax_aug_fn(scene, stack):  # noqa: F811
    """The batch a ``--photometric-augs`` step trains on: the port's
    letterboxed float32 BGR batch through ``photometric_augment`` with the
    draws the JAX trainer's keys make (fold_in(key(42), step), then 1, then
    one key an image), against the JAX trainer's jitted ``aug_fn``."""
    from spacecraft_pose_estimation_tpu_torch.data.detection_dataset import DetectionExamples, detection_batches
    from spacecraft_pose_estimation_tpu_torch.tools import train_detector as td

    names = td.PHOTOMETRIC_STACKS[stack]
    ex = DetectionExamples(str(scene / "train.json"), str(scene))
    batch = next(detection_batches(ex, 4, (96, 96), train=True, device="cpu", num_workers=0))
    step = 3
    keys_ = list(jr.split(jr.fold_in(jr.fold_in(jr.key(td.SAMPLING_SEED), step), 1), 4))
    aug_fn = jax.jit(jax.vmap(lambda k, im: jaug.apply_stack(k, im, names)))
    want = np.asarray(aug_fn(jnp.stack(keys_), jnp.asarray(n(batch["image"]))))
    got = td.photometric_augment(batch["image"], names, step, draws=stack_draws(names, keys_, 96, 96))
    assert not np.array_equal(want, n(batch["image"]))
    if stack == "event":
        np.testing.assert_array_equal(n(got), want)
    else:
        err = np.abs(n(got) - want)
        print(f"trainer SPEED+ batch: max |err| {err.max():.3g}")
        assert err.max() <= GREY_TOL


def test_photometric_event_step_runs(scene, tmp_path):  # noqa: F811
    """``tools.train_detector --photometric-augs event`` trains (it raised
    before the stacks were ported): 2 tiny updates with finite losses, whose
    parameters differ from the same run's without the stack."""
    from spacecraft_pose_estimation_tpu_torch.data.detection_dataset import DetectionExamples
    from spacecraft_pose_estimation_tpu_torch.tools import train_detector as td

    out = {}
    for augs in ("event", "none"):
        a = td.parse_args(det_args(scene, tmp_path / augs, 2, val=False, extra=("--photometric-augs", augs)))
        trainer = td.train(a, DetectionExamples(str(scene / "train.json"), str(scene)), device="cpu")
        out[augs] = trainer.state.model.state_dict()
        lines = [json.loads(x) for x in (tmp_path / augs / "metrics.json").read_text().splitlines() if x.strip()]
        assert lines and all(math.isfinite(v) for ln in lines for k, v in ln.items() if k.startswith("loss"))
    assert any(not torch.equal(v, out["none"][k]) for k, v in out["event"].items())
