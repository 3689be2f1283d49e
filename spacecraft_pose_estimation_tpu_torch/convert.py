"""Weight bridges from the JAX package: variable trees and quantized trees.

The port's module names mirror the Flax trees of ``HRNet`` and
``GeneralizedRCNN`` (``stem1.conv``, ``stage2_m0.fuse.up0_1``,
``backbone.res2_b0.shortcut``, ``roi_heads.box_head.fc1`` ...), so the map
is by name: conv kernels go from HWIO to OIHW, dense kernels are
transposed, and everything else (biases, BN scale/bias, and the
``batch_stats`` or frozen ``mean``/``var``) is copied as it is.

:func:`quantized_to_torch` carries an int8 quantized tree
(``quantize_hrnet`` or ``quantize_backbone`` output) over key for key: the
port's quantizers return the same keys and layouts.

The input is nested dicts of numpy arrays, e.g. what
``jax.tree_util.tree_map(np.asarray, variables)`` gives; this module
imports no JAX.
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Map {"params": ..., "batch_stats": ...} onto ``state_dict`` names.

    Works for both ``models.hrnet.HRNet`` and ``models.rcnn.GeneralizedRCNN``;
    load the result with ``load_state_dict(..., strict=True)`` so that a
    name the two sides disagree on raises.
    """
    out = {}
    for collection in variables.values():
        for path, arr in _leaves(collection):
            *modules, leaf = path
            if leaf == "kernel":
                leaf = "weight"
                if arr.ndim == 4:  # (kh, kw, in, out) -> (out, in, kh, kw)
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:  # (in, out) -> (out, in)
                    arr = arr.T
            out[".".join([*modules, leaf])] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32)
            )
    return out


def quantized_to_torch(q: Mapping):
    """A JAX quantized tree -> the same tree of CPU tensors.

    Arrays keep their dtype (int8 weights, f32 requant vectors, bf16 stem
    weights, 0-d ``in_scale``) and layout (HWIO); Python numbers (the
    backbone's ``feature_scales``) stay numbers.
    """
    if isinstance(q, Mapping):
        return {str(k): quantized_to_torch(v) for k, v in q.items()}
    if isinstance(q, (float, int)):
        return q
    arr = np.asarray(q)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16 of its own; the cast is exact
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))
