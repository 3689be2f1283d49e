"""Weight bridges to and from the JAX package: variable trees and quantized trees.

The port's module names mirror the Flax trees of ``HRNet``,
``GeneralizedRCNN`` (with its mask and keypoint heads), ``RetinaNet``,
``FCOS``, ``CascadeROIHeads``, ``RegNet``, ``DeformConv``, ``ASPP``,
``ConvSeq`` and the ``projects/`` heads and trunks (``stem1.conv``,
``stage2_m0.fuse.up0_1``, ``backbone.res2_b0.shortcut``,
``roi_heads.box_head.fc1``, ``head.cls_conv0``, ``p6``,
``mask_head.mask_fcn1``, ``box_head0.fc1``, ``s3_b1.se.fc1``, ``atrous2``,
``seq0.bn``, ``coarse_head.reduce_s``, ``point_head.fc1``, ``res5_b2.conv2``,
``decoder.fuse_res2_0``, ``center_head1``, ``densepose_head.gn1``,
``block2.conv2``, ``block0.attn.qkv``, ``stage1_block0.attn.pool_q``,
``norm0`` ...), so the map is by name: conv kernels go from HWIO to OIHW
(depthwise ones, MViTv2's (3, 3, 1, C) pools, too), transposed-conv kernels
(the modules named ``deconv``, ``deconv0`` ...: the CMS heads', PoseResNet's
and the mask head's; the keypoint head's ``score_lowres``; DensePose's
``ann_index_lowres``, ``index_uv_lowres``, ``u_lowres`` and ``v_lowres``;
ViTDet's ``up_res3``, ``up_res2a`` and ``up_res2b``) are flipped in space and
laid out (in, out, kh, kw), a raw 4-d ``kernel`` parameter (``DeformConv``'s,
``TridentConv``'s) goes from HWIO to OIHW as ``weight`` like a conv's, dense
kernels are transposed, and everything else (biases, BN, LayerNorm and
GroupNorm scale/bias, the ``batch_stats`` or frozen ``mean``/``var``, the
Rethinking-BN layer's per-domain (domains, C) ``batch_stats``, ViTDet's
``pos_embed``, the ``rel_pos_h`` / ``rel_pos_w`` tables, and the ``buffers``
collection: the implicit PointRend head's
``positional_encoding_gaussian_matrix``) is copied as it is.

:func:`quantized_to_torch` carries an int8 quantized tree
(``quantize_hrnet`` or ``quantize_backbone`` output) over key for key: the
port's quantizers return the same keys and layouts.

The input is nested dicts of numpy arrays, e.g. what
``jax.tree_util.tree_map(np.asarray, variables)`` gives; this module
imports no JAX. :func:`module_to_flax` is the way back: what the port
trains becomes the same tree, which its ``.npz`` checkpoints hold and the
JAX models load.
"""

from __future__ import annotations

import re
from collections.abc import Collection, Iterator, Mapping

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


_DECONV = re.compile(r"deconv\d*|score_lowres|(ann_index|index_uv|u|v)_lowres|up_res(3|2a|2b)")


def _is_deconv(modules: list[str]) -> bool:
    """A Flax ``nn.ConvTranspose`` by its module name (see ``layers.ConvTranspose``)."""
    return bool(modules) and _DECONV.fullmatch(modules[-1]) is not None


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Map {"params": ..., "batch_stats": ...} onto ``state_dict`` names.

    Works for ``models.hrnet.HRNet``, ``models.pose_resnet.PoseResNet``,
    ``models.discriminator.MultiScaleDiscriminator``,
    ``models.rcnn.GeneralizedRCNN``, ``models.retinanet.RetinaNet``,
    ``models.fcos.FCOS``, ``models.cascade.CascadeROIHeads``,
    ``models.regnet.RegNet``, ``ops.deform_conv.DeformConv``,
    ``models.extra_layers.ASPP``, ``models.layers.ConvSeq`` and the
    ``projects/`` modules (``point_rend``'s heads, ``deeplab``'s trunk and
    heads, ``panoptic_deeplab``'s heads, ``densepose``'s heads and decoder,
    ``tridentnet``'s stage, ``vitdet``'s and ``mvitv2``'s backbones,
    ``rethinking_bn``'s tower);
    load the result with ``load_state_dict(..., strict=True)`` so that a
    name the two sides disagree on raises.
    """
    out = {}
    for collection in variables.values():
        for path, arr in _leaves(collection):
            *modules, leaf = path
            if leaf == "kernel":
                leaf = "weight"
                if arr.ndim == 4 and _is_deconv(modules):  # flipped, (kh, kw, in, out) -> (in, out, kh, kw)
                    arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
                elif arr.ndim == 4:  # (kh, kw, in, out) -> (out, in, kh, kw)
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:  # (in, out) -> (out, in)
                    arr = arr.T
            out[".".join([*modules, leaf])] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32)
            )
    return out


def module_to_flax(model: torch.nn.Module) -> dict:
    """:func:`state_dict_to_flax` of ``model``: the buffers a module names in
    its ``FLAX_BUFFERS`` go to ``buffers`` (Flax's collection of that name),
    its other buffers (BatchNorm statistics) to ``batch_stats``, its
    parameters to ``params`` (the detector's FrozenBN ``mean`` and ``var``
    among them, as in the JAX ``params`` tree)."""
    flax_buffers = {f"{prefix}.{name}" if prefix else name for prefix, mod in model.named_modules()
                    for name in getattr(mod, "FLAX_BUFFERS", ())}
    stats = {name for name, _ in model.named_buffers()} - flax_buffers
    return state_dict_to_flax(model.state_dict(), stats, flax_buffers)


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor], stats: Collection[str],
                       buffers: Collection[str] = ()) -> dict:
    """The inverse of :func:`flax_to_state_dict`: {"params": ...,
    "batch_stats": ...} of nested dicts of float32 numpy arrays, conv
    kernels back to HWIO and dense kernels to (in, out). ``stats`` names the
    entries that go to ``batch_stats``, ``buffers`` those that go to a
    ``buffers`` collection (present only when one does); the rest go to
    ``params``. The arrays are copies, so later updates of the model leave
    them as they were."""
    out: dict = {"params": {}, "batch_stats": {}} | ({"buffers": {}} if buffers else {})
    for name, value in state_dict.items():
        *modules, leaf = name.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        collection = "batch_stats" if name in stats else "buffers" if name in buffers else "params"
        if leaf == "weight":
            leaf = "kernel"
            if arr.ndim == 4 and _is_deconv(modules):  # (in, out, kh, kw) -> (kh, kw, in, out), unflipped
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif arr.ndim == 4:  # (out, in, kh, kw) -> (kh, kw, in, out)
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
        node = out[collection]
        for mod in modules:
            node = node.setdefault(mod, {})
        node[leaf] = np.array(arr, order="C")  # a copy: never a view of the live tensors
    return out


def flatten_variables(tree: Mapping, sep: str = "/") -> dict[str, np.ndarray]:
    """Nested variables -> {"params/stem1/conv/kernel": array, ...}, the
    keys of the port's ``.npz`` checkpoints (``flax.traverse_util.flatten_dict``
    with ``sep="/"``)."""
    return {sep.join(path): arr for path, arr in _leaves(tree)}


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
