"""Helpers shared by the ``test_torch_*`` parity tests (not a test module).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package and its PyTorch port, which runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
