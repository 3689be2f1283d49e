"""Port parity of the domain-adaptation trainer's data: ``data/augment.py``'s photometric ops
and ``tools/train_landmarks_da``'s ``photo_aug`` and ``multi_scale_targets``.

Each test feeds numpy-seeded inputs, and JAX's own random draws (computed
from its keys with the splits ``augment.py`` and the JAX trainer make), to
the JAX function and its port on the CPU:

* ``color_jitter``, ``random_noise_01``, ``random_erasing``, and the
  trainer's ``photo_aug`` stack: within 1e-4 grey (float32 products and
  means in another order); the erasing equal;
* ``multi_scale_targets`` (composed as the JAX trainer's closure does,
  ``tools/train_landmarks_da.py:163-195``): the four target pairs within
  1e-6 and the weights equal; the augmented source images within 1e-2
  grey, the rotated crop's 1e-3 grey (boxes well inside the frames, so no
  tap straddles an edge) carried through jitter factors of up to 2 for
  brightness, contrast and saturation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.data import augment as jaug
from spacecraft_pose_estimation_tpu.data import landmark_dataset as jld
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo, heatmap as jhm, warp as jwarp
from spacecraft_pose_estimation_tpu.pipeline import IMAGENET_STD, normalize_crops as j_normalize
from spacecraft_pose_estimation_tpu_torch.data import augment as taug
from spacecraft_pose_estimation_tpu_torch.tools import train_landmarks_da as tda

from torch_port_util import few_threads, n, smooth_frames, t

pytestmark = pytest.mark.usefixtures("few_threads")
J = 11
GREY = np.asarray(IMAGENET_STD, np.float32) * 255.0


# --- JAX's draws, by the splits of augment.py and the JAX trainer's photo_aug

def jax_jitter(key, f=(0.4, 0.4, 0.4)):
    ks = jax.random.split(key, 3)
    return [float(jax.random.uniform(k, (), minval=1 - v, maxval=1 + v)) for k, v in zip(ks, f)]


def jax_noise(key, h, w, std_range, mean_range):
    k1, k2, k3 = jax.random.split(key, 3)
    return (float(jax.random.uniform(k1, (), minval=std_range[0], maxval=std_range[1])),
            float(jax.random.uniform(k2, (), minval=mean_range[0], maxval=mean_range[1])),
            np.asarray(jax.random.normal(k3, (h, w, 1))))


def jax_erase(key, h, w, min_frac=0.05, max_frac=0.3):
    ks = jax.random.split(key, 4)
    eh = int((jax.random.uniform(ks[0], (), minval=min_frac, maxval=max_frac) * h).astype(jnp.int32))
    ew = int((jax.random.uniform(ks[1], (), minval=min_frac, maxval=max_frac) * w).astype(jnp.int32))
    return [eh, ew, int(jax.random.randint(ks[2], (), 0, h)), int(jax.random.randint(ks[3], (), 0, w))]


def jax_photo_draws(keys, h, w, ranges):
    """The draws of the JAX trainer's ``photo_aug`` for each key, as :func:`tda.sample_photo_draws` gives them."""
    rows = []
    for k in keys:
        k1, k2, k3, k4 = jax.random.split(k, 4)
        rows.append((jax_jitter(k1, (1.0, 1.0, 1.0)), jax_noise(k2, h, w, ranges["noise_std"], ranges["noise_mean"]),
                     float(jax.random.uniform(k3)), jax_erase(k4, h, w)))
    return {"jitter": torch.tensor([r[0] for r in rows]), "noise_std": torch.tensor([r[1][0] for r in rows]),
            "noise_mean": torch.tensor([r[1][1] for r in rows]), "noise": t(np.stack([r[1][2] for r in rows])),
            "erase_u": torch.tensor([r[2] for r in rows]), "erase": torch.tensor([r[3] for r in rows])}


def jax_photo_aug(key, im, ranges):
    """``tools/train_landmarks_da.py:148-161``'s photo_aug."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    im = jaug.color_jitter(k1, im, 1.0, 1.0, 1.0)
    im = jaug.random_noise_01(k2, im / 255.0, ranges["noise_std"], ranges["noise_mean"]) * 255.0
    return jnp.where(jax.random.uniform(k3) < ranges["erase_p"], jaug.random_erasing(k4, im), im)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 255, (4, 24, 32, 3)).astype(np.float32)


def test_color_jitter_matches_jax(images):
    keys = jax.random.split(jax.random.key(1), len(images))
    want = np.asarray(jax.vmap(lambda k, im: jaug.color_jitter(k, im))(keys, jnp.asarray(images)))
    factors = torch.tensor([jax_jitter(k) for k in keys])
    got = n(taug.color_jitter(t(images), factors))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (want == 255.0).any()  # the clip acts


def test_random_noise_01_matches_jax(images):
    keys = jax.random.split(jax.random.key(2), len(images))
    im01 = images / 255.0
    want = np.asarray(jax.vmap(lambda k, im: jaug.random_noise_01(k, im, (0.01, 0.1), (0.03, 0.25)))(keys, im01))
    draws = [jax_noise(k, 24, 32, (0.01, 0.1), (0.03, 0.25)) for k in keys]
    got = n(taug.random_noise_01(t(im01), torch.tensor([d[0] for d in draws]), torch.tensor([d[1] for d in draws]),
                                 t(np.stack([d[2] for d in draws]))))
    np.testing.assert_allclose(got * 255.0, want * 255.0, atol=1e-4)
    assert (want == 1.0).any()  # the clip acts


def test_random_erasing_matches_jax(images):
    keys = jax.random.split(jax.random.key(3), len(images))
    want = np.asarray(jax.vmap(lambda k, im: jaug.random_erasing(k, im))(keys, jnp.asarray(images)))
    rects = torch.tensor([jax_erase(k, 24, 32) for k in keys])
    got = n(taug.random_erasing(t(images), rects))
    np.testing.assert_array_equal(got, want)
    assert ((want == 0).all(-1).sum(axis=(1, 2)) > 0).all()


def test_photo_aug_matches_jax_and_draws_every_field(images):
    ranges = tda.photo_ranges("lightbox_cms")
    keys = jax.random.split(jax.random.key(4), len(images))
    want = np.asarray(jax.vmap(lambda k, im: jax_photo_aug(k, im, ranges))(keys, jnp.asarray(images)))
    draws = jax_photo_draws(keys, 24, 32, ranges)
    got = n(tda.photo_aug(t(images), draws, ranges["erase_p"]))
    np.testing.assert_allclose(got, want, atol=1e-4)
    own = tda.sample_photo_draws(torch.Generator().manual_seed(0), 4, 24, 32, ranges["noise_std"],
                                 ranges["noise_mean"])
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: tuple(v.shape) for k, v in draws.items()}
    assert tda.photo_ranges("sunlamp_cms")["erase_p"] == 0.3


def test_multi_scale_targets_match_jax():
    b, size, hm = 3, (64, 64), (64, 64)
    sigmas = (12.0, 10.0, 8.0, 6.0)
    ranges = tda.photo_ranges("lightbox_cms")
    frames = smooth_frames(7, b, 200, 240)
    rng = np.random.default_rng(8)
    bboxes = np.concatenate([rng.uniform(90, 110, (b, 2)), rng.uniform(20, 30, (b, 2))], 1).astype(np.float32)
    joints = (bboxes[:, None, :2] + rng.uniform(0, 1, (b, J, 2)) * bboxes[:, None, 2:]).astype(np.float32)
    vis = (rng.uniform(size=(b, J)) > 0.1).astype(np.float32)
    key = jax.random.key(9)
    # the JAX trainer's closure, step by step
    kg, kp = jax.random.split(key)
    centers, scales = jax.vmap(jgeo.bbox_to_center_scale)(jnp.asarray(bboxes))
    s_mult, rots = jld.sample_augmentation(kg, b, 0.25, 30.0)
    scales = scales * s_mult[:, None]
    crops = jwarp.batched_crop_and_resize(jnp.asarray(frames, jnp.float32), centers, scales, rots, size)
    pkeys = jax.random.split(kp, b)
    crops = jax.vmap(lambda k, im: jax_photo_aug(k, im, ranges))(pkeys, crops)
    jts = jax.vmap(lambda a, c, s, r: jgeo.apply_affine(a, jgeo.crop_affine_matrix(c, s, r, size)))(
        jnp.asarray(joints), centers, scales, rots)
    want = {"source_image": np.asarray(j_normalize(crops))}
    for idx, div in enumerate((1, 2, 4, 8)):
        tg, tw = jax.vmap(lambda a, v: jhm.generate_target(a, v, size, (hm[0] // div, hm[1] // div), sigmas[idx]))(
            jts, jnp.asarray(vis))
        suffix = "" if idx == 0 else str(idx + 1)
        want[f"target{suffix}"], want[f"target_weight{suffix}"] = np.asarray(tg), np.asarray(tw)
    draws = {"s_mult": t(s_mult), "rots": t(rots)} | jax_photo_draws(pkeys, *size[::-1], ranges)
    got = tda.multi_scale_targets(t(frames), t(bboxes), t(joints), t(vis), draws, size, hm, sigmas,
                                  ranges["erase_p"])
    assert set(got) == set(want)
    for k in want:
        if k.startswith("target_weight"):
            np.testing.assert_array_equal(n(got[k]), want[k])
        elif k.startswith("target"):
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(n(got[k]), want[k], atol=1e-6)
    assert [got[f"target{s}"].shape[1] for s in ("", "2", "3", "4")] == [64, 32, 16, 8]
    np.testing.assert_allclose(n(got["source_image"]) * GREY, want["source_image"] * GREY, atol=1e-2)
