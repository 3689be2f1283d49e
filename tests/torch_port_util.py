"""Helpers shared by the ``test_torch_*`` parity tests (not a test module).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package and its PyTorch port, which runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads for PyTorch while a module's tests run: the test
    workers share the host's cores, and a worker whose PyTorch spreads over
    all of them slows every other (the heavy DA files ran 5-50x slower
    under six workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def smooth_frames(seed, b, h, w):
    """Seeded uint8 frames, noise blurred over ~3 px (a camera image is smooth)."""
    import cv2

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        im = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3)).astype(np.float32), (0, 0), 3.0)
        out.append(np.clip(np.rint((im - im.mean()) / im.std() * 50 + 128), 0, 255).astype(np.uint8))
    return np.stack(out)


def random_variables(init_fn, seed: int, overrides: dict | None = None) -> dict:
    """A Flax variable tree of ``init_fn``'s shapes, filled from ``seed``.

    Kernels are N(0, 1/fan_in); biases N(0, 0.1); BN/FrozenBN scale and
    var U(0.5, 1.5), mean N(0, 0.1). ``overrides`` maps a path substring
    to a kernel std (e.g. {"bbox_pred": 0.01}). Returns nested dicts of
    numpy float32 arrays, as ``jax.tree_util.tree_map(np.asarray, v)`` would.
    """
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    values = []
    for path, sds in leaves:
        name = "/".join(str(k.key) for k in path)
        leaf = name.rsplit("/", 1)[-1]
        shape = sds.shape
        if leaf == "kernel":
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
            for key, s in (overrides or {}).items():
                if key in name:
                    std = s
            v = rng.normal(0.0, std, shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = rng.normal(0.0, 0.1, shape)
        values.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, values)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def jax_gumbel(key, b: int, h: int, num: int) -> np.ndarray:
    """The noise ``jax.random.choice(replace=False, p=p)`` draws inside the
    JAX ``pnp_ransac`` for frame i, hypothesis j of a batch run with
    ``key`` (per-frame keys ``split(key, b)``, per-hypothesis keys
    ``split(k_i, h)``, then ``gumbel(k_ij, (num,))``): (b, h, num) float32,
    the port's ``gumbel``."""
    per_hyp = lambda kb: jax.vmap(lambda kh: jax.random.gumbel(kh, (num,)))(jax.random.split(kb, h))
    return np.asarray(jax.vmap(per_hyp)(jax.random.split(key, b)))


def jax_hypotheses(world, px, conf, K, dist, key, num_hypotheses: int, sample_size: int = 6,
                   threshold: float = 15.0, min_count: int = 15) -> dict:
    """The hypotheses of the JAX ``pnp_ransac`` by its own steps
    (ops/pnp.py:400-420): every point's reprojection error under each,
    ``err`` (b, H, N); its inliers ``inl`` (b, H, N); the inlier counts
    ``scores`` (b, H); the chosen hypothesis ``best`` (b,) and its inliers,
    ``best_inl`` (b, N), the refinement's weights. ``world`` is (N, 3) or
    (b, N, 3)."""
    from spacecraft_pose_estimation_tpu.ops import pnp as jpnp

    Kj, dj = jnp.asarray(K), jnp.asarray(dist)

    def frame(w, p, c, k):
        n_pts = p.shape[0]
        valid = jpnp.adaptive_confidence_mask(c, min_count=min_count)
        vf = valid.astype(jnp.float32)
        prob = jnp.where(jnp.sum(vf) >= sample_size, vf / jnp.maximum(jnp.sum(vf), 1.0),
                         jnp.full((n_pts,), 1.0 / n_pts))

        def hypothesis(kh):
            idx = jax.random.choice(kh, n_pts, shape=(sample_size,), replace=False, p=prob)
            R, tt = jpnp.epnp(w[idx], jpnp._norm_pts(p[idx], Kj, dj), jnp.ones(sample_size))
            err = jpnp._reproj_err(w, p, Kj, dj, R, tt)
            return err, (err < threshold) & valid

        err, inl = jax.vmap(hypothesis)(jax.random.split(k, num_hypotheses))
        scores = jnp.sum(inl, axis=-1)
        best = jnp.argmax(scores)
        return dict(err=err, inl=inl, scores=scores, best=best, best_inl=inl[best])

    b = px.shape[0]
    world = np.broadcast_to(world, (b, *np.shape(world)[-2:]))
    out = jax.jit(jax.vmap(frame))(jnp.asarray(world), jnp.asarray(px), jnp.asarray(conf), jax.random.split(key, b))
    return {k: np.asarray(v) for k, v in out.items()}


def port_hypotheses(world, px, conf, K, dist, gumbel, sample_size: int = 6, threshold: float = 15.0,
                    min_count: int = 15) -> dict:
    """The same quantities as ``jax_hypotheses`` from the port's
    ``pnp_ransac`` steps on the noise ``gumbel`` (b, H, N), on the CPU."""
    from spacecraft_pose_estimation_tpu_torch.ops import pnp as tpnp

    px_t = t(px)
    world_t = t(world).expand(*px_t.shape[:-1], 3)
    valid = tpnp.adaptive_confidence_mask(t(conf), min_count=min_count)
    _, _, err = tpnp.ransac_hypotheses(world_t, px_t, t(K), t(dist), valid, t(gumbel), sample_size)
    inl = (err < threshold) & valid[..., None, :]
    scores = inl.sum(-1)
    best = torch.argmax(scores, dim=-1)
    out = dict(err=err, inl=inl, scores=scores, best=best, best_inl=inl[torch.arange(len(best)), best])
    return {k: v.numpy() for k, v in out.items()}


def jax_detection_draws(jmodel, variables, key, b: int, num_anchors: int, num_candidates: int) -> dict:
    """The uniform priorities the JAX ``GeneralizedRCNN`` draws in a train
    step run with ``rngs={"sampling": key}`` (its ``make_rng("sampling")``,
    then ``fold_in`` 0 for the proposals' and 1 for the anchors' sampling,
    split per image; ``sample_proposals`` splits each image's key into the
    subsample's and the gather's, ``subsample_labels`` its key into the
    positives' and the negatives'), as the port's ``sample_draws`` lays
    them out: numpy (b, n) arrays."""
    rng = jmodel.apply(variables, rngs={"sampling": key}, method=lambda m: m.make_rng("sampling"))
    sample_keys = jax.random.split(jax.random.fold_in(rng, 0), b)
    rpn_keys = jax.random.split(jax.random.fold_in(rng, 1), b)
    out = {k: [] for k in ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg", "roi_gather")}
    for i in range(b):
        kp, kn = jax.random.split(rpn_keys[i])
        out["rpn_pos"].append(jax.random.uniform(kp, (num_anchors,)))
        out["rpn_neg"].append(jax.random.uniform(kn, (num_anchors,)))
        k1, k2 = jax.random.split(sample_keys[i])
        kp, kn = jax.random.split(k1)
        out["roi_pos"].append(jax.random.uniform(kp, (num_candidates,)))
        out["roi_neg"].append(jax.random.uniform(kn, (num_candidates,)))
        out["roi_gather"].append(jax.random.uniform(k2, (num_candidates,)))
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def load_adam(opt, model, opt_state):
    """optax's Adam moments and count -> the ``torch.optim.Adam`` state of ``model``'s parameters."""
    import optax

    from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict

    adam = next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState))
    opt.inner.state.clear()
    if int(adam.count) == 0:
        return
    mu, nu = (flax_to_state_dict({"params": np_tree(m)}) for m in (adam.mu, adam.nu))
    for name, p in model.named_parameters():
        opt.inner.state[p] = {"step": torch.tensor(float(adam.count)), "exp_avg": mu[name], "exp_avg_sq": nu[name]}


def load_jax_state(ts, js):
    """A JAX ``DAState`` (both models' parameters and BN statistics, both
    Adam states, the step) -> the port's ``DAState`` ``ts``."""
    from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict

    ts.generator.load_state_dict(flax_to_state_dict({"params": np_tree(js.gen_params),
                                                     "batch_stats": np_tree(js.gen_stats)}))
    ts.discriminator.load_state_dict(flax_to_state_dict({"params": np_tree(js.disc_params),
                                                         "batch_stats": np_tree(js.disc_stats)}))
    load_adam(ts.gen_optimizer, ts.generator, js.gen_opt)
    load_adam(ts.disc_optimizer, ts.discriminator, js.disc_opt)
    ts.step = int(js.step)
