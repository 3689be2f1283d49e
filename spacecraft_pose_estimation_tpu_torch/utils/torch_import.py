"""Reference torch checkpoints onto the port's modules (port of ``utils/torch_import.py``).

The reference initialises its trunks from torch checkpoints: the ImageNet
``hrnet_w32`` for the landmark nets (``pose_hrnet.py:462-492``, filtered by
PRETRAINED_LAYERS) and detectron2 GeneralizedRCNN state dicts for the
detector. The name grammar is the JAX package's, copied: each reference
key becomes a leaf of a partial Flax-named tree (conv kernels OIHW ->
HWIO, BN into ``scale``/``bias`` and ``mean``/``var``). The port's module
names mirror those trees (``convert.py``), so :func:`merge_pretrained`
merges the partial tree over the module's own (``convert.module_to_flax``)
and loads the result with ``strict=True`` (``convert.flax_to_state_dict``).

Torch name grammar of HRNet (``lib/models/pose_hrnet.py``):
  conv1/bn1/conv2/bn2                       -> stem1/stem2
  layer1.{i}.conv{k}|bn{k}|downsample.{0,1} -> layer1/block{i}/conv{k}|down
  transition{s}.{i}(.{j}).{0,1}             -> transition{s}/adapt{i}|new{i}_{j}
  stage{s}.{m}.branches.{b}.{i}.*           -> stage{s}_m{m}/branch{b}/block{i}
  stage{s}.{m}.fuse_layers.{i}.{j}(.{k}).*  -> stage{s}_m{m}/fuse/up{i}_{j}|down{i}_{j}_{k}
  final_layer                               -> final_layer
  final_layer{N}_equal_to_image|_4x.{0,1}   -> head{N-1}/deconv|conv (the CMS heads)

Keys the grammar does not know (``num_batches_tracked`` among them) are
ignored; leaves whose name or shape the module lacks are skipped and
reported, not raised. This module imports no JAX.
"""

from __future__ import annotations

import logging
import re
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from ..convert import flax_to_state_dict, module_to_flax

logger = logging.getLogger(__name__)

# the reference's PRETRAINED_LAYERS: the trunk, not final_layer
PRETRAINED_LAYERS = (
    "conv1", "bn1", "conv2", "bn2", "layer1", "transition1", "stage2",
    "transition2", "stage3", "transition3", "stage4",
)
ALL_LAYERS = ("*",)


def _set(tree: dict, path: list[str], leaf: str, value: np.ndarray) -> None:
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = value


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _convbn_leaves(torch_key_tail: str, value: np.ndarray):
    """Map one torch leaf inside a conv+bn unit to (flax subpath, leaf, value)."""
    v = value
    if torch_key_tail == "weight" and v.ndim == 4:
        return ["conv"], "kernel", v.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if torch_key_tail == "weight":
        return ["bn"], "scale", v
    if torch_key_tail == "bias":
        return ["bn"], "bias", v
    if torch_key_tail == "running_mean":
        return ["bn"], "mean", v
    if torch_key_tail == "running_var":
        return ["bn"], "var", v
    return None


def hrnet_torch_to_flax(state_dict: Mapping[str, Any],
                        pretrained_layers: tuple[str, ...] = PRETRAINED_LAYERS) -> tuple[dict, dict]:
    """A reference HRNet state dict -> (params, batch_stats) partial trees
    to merge over a module (:func:`merge_pretrained`). Keys whose root is
    not in ``pretrained_layers`` are left out, unless it is ``("*",)``."""
    params: dict = {}
    stats: dict = {}

    def put(path, leaf, value):
        # BN statistics go to batch_stats; conv kernels and the BN affine to params
        _set(stats if leaf in ("mean", "var") else params, path, leaf, value)

    def convbn(path_prefix, tail, v):
        m = _convbn_leaves(tail, np.asarray(v))
        if m is None:
            return
        sub, leaf, vv = m
        put(path_prefix + sub, leaf, vv)

    for key, value in state_dict.items():
        value = _to_numpy(value)
        root = key.split(".")[0]
        if pretrained_layers and root not in pretrained_layers and pretrained_layers[0] != "*":
            continue

        # stem: conv1/bn1 -> stem1, conv2/bn2 -> stem2
        m = re.match(r"(conv|bn)([12])\.(.+)", key)
        if m:
            convbn([f"stem{m.group(2)}"], m.group(3), value)
            continue

        # layer1.{i}.(conv{k}|bn{k}|downsample.{0|1}).tail
        m = re.match(r"layer1\.(\d+)\.(.+)", key)
        if m:
            _block_leaf(["layer1", f"block{int(m.group(1))}"], m.group(2), value, put)
            continue

        # transition{s}.{i}[.{j}].{0|1}.tail
        m = re.match(r"transition(\d)\.(\d+)\.(.+)", key)
        if m:
            s, i, rest = m.group(1), int(m.group(2)), m.group(3)
            # chains for new branches are Sequential(Sequential(conv, bn, relu))
            m2 = re.match(r"(\d+)\.(\d+)\.(.+)", rest)
            if m2:
                convbn([f"transition{s}", f"new{i}_{int(m2.group(1))}"], m2.group(3), value)
                continue
            m2 = re.match(r"(\d+)\.(.+)", rest)
            if m2:
                convbn([f"transition{s}", f"adapt{i}"], m2.group(2), value)
            continue

        # stage{s}.{m}.branches.{b}.{i}.tail
        m = re.match(r"stage(\d)\.(\d+)\.branches\.(\d+)\.(\d+)\.(.+)", key)
        if m:
            s, mod, b, i, rest = m.groups()
            _block_leaf([f"stage{s}_m{mod}", f"branch{b}", f"block{i}"], rest, value, put)
            continue

        # stage{s}.{m}.fuse_layers.{i}.{j}.( {k}.{unit} | {unit} ).tail
        m = re.match(r"stage(\d)\.(\d+)\.fuse_layers\.(\d+)\.(\d+)\.(.+)", key)
        if m:
            s, mod, i, j, rest = m.groups()
            i, j = int(i), int(j)
            base = [f"stage{s}_m{mod}", "fuse"]
            if j > i:
                # Sequential(conv, bn, upsample): rest = {0|1}.tail
                m2 = re.match(r"([01])\.(.+)", rest)
                convbn(base + [f"up{i}_{j}"], m2.group(2), value)
            else:
                # chain of k: rest = {k}.{0|1}.tail
                m2 = re.match(r"(\d+)\.([01])\.(.+)", rest)
                convbn(base + [f"down{i}_{j}_{int(m2.group(1))}"], m2.group(3), value)
            continue

        # final_layer.{weight|bias}
        m = re.match(r"final_layer\.(.+)", key)
        if m:
            tail = m.group(1)
            if tail == "weight":
                _set(params, ["final_layer"], "kernel", np.asarray(value).transpose(2, 3, 1, 0))
            elif tail == "bias":
                _set(params, ["final_layer"], "bias", np.asarray(value))
            continue

        # CMS heads (hrnet_cms.py:353-420: final_layer{N}_equal_to_image;
        # hrnet_cms_384.py:353-412: final_layer{N}_4x):
        #   .0 = ConvTranspose2d -> head{i}/deconv
        #   .1 = Conv2d          -> head{i}/conv
        m = re.match(r"final_layer(\d?)_(?:equal_to_image|4x)\.([01])\.(weight|bias)", key)
        if m:
            idx = int(m.group(1)) - 1 if m.group(1) else 0
            unit = "deconv" if m.group(2) == "0" else "conv"
            v = np.asarray(value)
            if m.group(3) == "bias":
                _set(params, [f"head{idx}", unit], "bias", v)
            elif unit == "deconv":
                # torch's ConvTranspose2d weight (in, out, kh, kw) in the
                # flipped orientation of XLA's conv_transpose: flip, then
                # (kh, kw, in, out)
                _set(params, [f"head{idx}", unit], "kernel", v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
            else:
                _set(params, [f"head{idx}", unit], "kernel", v.transpose(2, 3, 1, 0))
            continue

    return params, stats


def _block_leaf(base, rest, value, put):
    """BasicBlock/Bottleneck member: conv{k}|bn{k}|downsample.{0|1}."""
    bn_leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
    m = re.match(r"conv(\d)\.(.+)", rest)
    if m:
        put(base + [f"conv{m.group(1)}", "conv"], "kernel", np.asarray(value).transpose(2, 3, 1, 0))
        return
    m = re.match(r"bn(\d)\.(.+)", rest)
    if m:
        leaf = bn_leaf.get(m.group(2))
        if leaf:
            put(base + [f"conv{m.group(1)}", "bn"], leaf, np.asarray(value))
        return
    m = re.match(r"downsample\.0\.(.+)", rest)
    if m and m.group(1) == "weight":
        put(base + ["down", "conv"], "kernel", np.asarray(value).transpose(2, 3, 1, 0))
        return
    m = re.match(r"downsample\.1\.(.+)", rest)
    if m:
        leaf = bn_leaf.get(m.group(1))
        if leaf:
            put(base + ["down", "bn"], leaf, np.asarray(value))


# ---------------------------------------------------------------------------
# Detectron2 GeneralizedRCNN state dict -> the detector's tree
# ---------------------------------------------------------------------------


def detectron2_torch_to_flax(state_dict: Mapping[str, Any], pooler_resolution: int = 7) -> dict:
    """A detectron2 GeneralizedRCNN ``model.state_dict()`` (FrozenBN as
    ``.norm.{weight,bias,running_mean,running_var}``) -> a partial params
    tree of ``models.rcnn.GeneralizedRCNN`` (FrozenBN statistics are
    params there) for :func:`merge_pretrained`.

    Name grammar:
      backbone.bottom_up.stem.conv1.*            -> backbone/stem
      backbone.bottom_up.res{s}.{i}.conv{k}.*    -> backbone/res{s}_b{i}/conv{k}
      backbone.bottom_up.res{s}.{i}.shortcut.*   -> backbone/res{s}_b{i}/shortcut
      backbone.fpn_lateral{l}.*                  -> fpn/lateral_res{l}
      backbone.fpn_output{l}.*                   -> fpn/output_p{l}
      proposal_generator.rpn_head.{conv|objectness_logits|anchor_deltas}
                                                 -> rpn_head/{conv|objectness|deltas}
      roi_heads.box_head.fc{k}.*                 -> roi_heads/box_head/fc{k}
      roi_heads.box_predictor.{cls_score|bbox_pred}
                                                 -> roi_heads/predictor/...
    """
    params: dict = {}

    def put(path, leaf, v):
        _set(params, path, leaf, v)

    def conv_unit(path_prefix, tail, v):
        v = np.asarray(v)
        if tail == "weight" and v.ndim == 4:
            put(path_prefix + ["conv"], "kernel", v.transpose(2, 3, 1, 0))
        elif tail == "norm.weight":
            put(path_prefix + ["norm"], "scale", v)
        elif tail == "norm.bias":
            put(path_prefix + ["norm"], "bias", v)
        elif tail == "norm.running_mean":
            put(path_prefix + ["norm"], "mean", v)
        elif tail == "norm.running_var":
            put(path_prefix + ["norm"], "var", v)

    def plain_conv(path, tail, v):
        v = np.asarray(v)
        if tail == "weight":
            put(path, "kernel", v.transpose(2, 3, 1, 0))
        elif tail == "bias":
            put(path, "bias", v)

    def dense(path, tail, v, flattens_pooled=False):
        v = np.asarray(v)
        if tail == "weight":
            if flattens_pooled:
                # d2's FastRCNNConvFCHead flattens the pooled features NCHW
                # (C*P*P); the port's BoxHead flattens NHWC (P*P*C), so the
                # first fc's input axis is permuted, not only transposed
                out_dim, in_dim = v.shape
                p = pooler_resolution
                c = in_dim // (p * p)
                if c * p * p == in_dim:
                    put(path, "kernel", v.reshape(out_dim, c, p, p).transpose(2, 3, 1, 0).reshape(p * p * c, out_dim))
                    return
            put(path, "kernel", v.T)
        elif tail == "bias":
            put(path, "bias", v)

    for key, value in state_dict.items():
        value = _to_numpy(value)
        m = re.match(r"backbone\.bottom_up\.stem\.conv1\.(.+)", key)
        if m:
            conv_unit(["backbone", "stem"], m.group(1), value)
            continue
        m = re.match(r"backbone\.bottom_up\.res(\d)\.(\d+)\.(conv\d|shortcut)\.(.+)", key)
        if m:
            s, i, unit, tail = m.groups()
            conv_unit(["backbone", f"res{s}_b{i}", unit], tail, value)
            continue
        m = re.match(r"backbone\.fpn_lateral(\d)\.(.+)", key)
        if m:
            plain_conv(["fpn", f"lateral_res{m.group(1)}"], m.group(2), value)
            continue
        m = re.match(r"backbone\.fpn_output(\d)\.(.+)", key)
        if m:
            plain_conv(["fpn", f"output_p{m.group(1)}"], m.group(2), value)
            continue
        m = re.match(r"proposal_generator\.rpn_head\.(conv|objectness_logits|anchor_deltas)\.(.+)", key)
        if m:
            unit = {"conv": "conv", "objectness_logits": "objectness", "anchor_deltas": "deltas"}[m.group(1)]
            plain_conv(["rpn_head", unit], m.group(2), value)
            continue
        m = re.match(r"roi_heads\.box_head\.fc(\d)\.(.+)", key)
        if m:
            dense(["roi_heads", "box_head", f"fc{m.group(1)}"], m.group(2), value,
                  flattens_pooled=(m.group(1) == "1"))
            continue
        m = re.match(r"roi_heads\.box_predictor\.(cls_score|bbox_pred)\.(.+)", key)
        if m:
            dense(["roi_heads", "predictor", m.group(1)], m.group(2), value)
            continue

    return params


def count_leaves(tree: Mapping) -> int:
    """The arrays in a nested tree."""
    return sum(count_leaves(v) if isinstance(v, Mapping) else 1 for v in tree.values())


def merge_pretrained(module: torch.nn.Module, params: Mapping,
                     stats: Mapping | None = None) -> tuple[list[str], int]:
    """Merge imported partial trees over ``module``'s own variables and load
    them with ``strict=True`` -> (the skipped leaves as ``/``-joined paths,
    the number of leaves loaded). A leaf is skipped where the module has no
    such name or another shape, and a subtree the module lacks is one entry,
    in the JAX ``merge_pretrained``'s order; the loaded leaves are cast to
    the module's dtype. Leaves the trees do not hold keep the module's
    values."""
    variables = module_to_flax(module)
    skipped: list[str] = []
    loaded = [0]

    def merge_into(dst, src, path=""):
        for k, v in src.items():
            p = f"{path}/{k}"
            if isinstance(v, Mapping):
                if k not in dst:
                    skipped.append(p)
                    continue
                merge_into(dst[k], v, p)
            else:
                if k not in dst or tuple(dst[k].shape) != tuple(np.shape(v)):
                    skipped.append(p)
                    continue
                dst[k] = np.asarray(v).astype(dst[k].dtype)
                loaded[0] += 1

    merge_into(variables["params"], params)
    merge_into(variables["batch_stats"], stats or {})
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    if skipped:
        logger.info("weight import skipped %d leaves (first: %s)", len(skipped), skipped[:5])
    return skipped, loaded[0]
