"""Caffe2 / detectron2 zoo ``.pkl`` checkpoints (port of ``utils/zoo_import.py``).

The reference boots its spacecraft detector from detectron2 model-zoo
pickles whose weights carry Caffe2-era blob names (the reference's
``detectron2/checkpoint/detection_checkpoint.py:15`` loads ``.pkl`` with
pickle and latin1; ``c2_model_loading.py`` defines the Caffe2 ->
detectron2 name grammar and the background-class weight surgery).

A zoo ``.pkl`` is a plain ``pickle`` of ``{"model": {name: np.ndarray}, ...}``
and needs no torch. This module:

1. reads the pickle (:func:`load_detectron_pickle`),
2. renames Caffe2 blobs to detectron2 ``model.state_dict()`` names with the
   same background-class conventions (``bbox_pred`` drops the 4 background
   deltas; ``cls_score`` moves the background from index 0 to last),
3. prefixes the bare zoo names (``res2.0.conv1.weight``) to full
   GeneralizedRCNN names (``backbone.bottom_up.res2.0.conv1.weight``), the
   deterministic special case of d2's suffix-matching
   ``align_and_update_state_dicts``,
4. hands the result to :func:`torch_import.detectron2_torch_to_flax`, whose
   partial tree ``torch_import.merge_pretrained`` loads into a
   ``GeneralizedRCNN``.

Caffe2 detector pickles have BatchNorm absorbed into the affine scale and
bias (no running statistics), so FrozenBN ``mean``/``var`` keep the
module's 0/1, as d2's ``FrozenBatchNorm2d._load_from_state_dict`` does.
"""

from __future__ import annotations

import pickle
import re
from typing import Any

import numpy as np

from .torch_import import detectron2_torch_to_flax

# Two ordered rewrite tables, applied to the ``_``->``.`` converted blob
# name. Together they reproduce the detectron2 naming of the same weight
# (grammar documented in c2_model_loading.py; re-derived here, table-driven).

# Phase 1: parameter-kind / norm suffixes (".b" before "bn.*" so bn.b ->
# bn.bias first), plus stem canonicalisation.
_SUFFIX_REWRITES: tuple[tuple[str, str], ...] = (
    (r"\.b$", ".bias"),
    (r"\.w$", ".weight"),
    (r"bn\.s$", "norm.weight"),
    (r"bn\.bias$", "norm.bias"),
    (r"bn\.rm$", "norm.running_mean"),
    (r"bn\.running\.mean$", "norm.running_mean"),
    (r"bn\.riv$", "norm.running_var"),
    (r"bn\.running\.var$", "norm.running_var"),
    (r"bn\.gamma$", "norm.weight"),
    (r"bn\.beta$", "norm.bias"),
    (r"gn\.s$", "norm.weight"),
    (r"gn\.bias$", "norm.bias"),
    # "res_conv1_bn_*" and bare "conv1_*" both mean the stem conv
    (r"^res\.conv1\.norm\.", "conv1.norm."),
    (r"^conv1\.", "stem.conv1."),
    # bottleneck branches
    (r"\.branch1\.", ".shortcut."),
    (r"\.branch2a\.", ".conv1."),
    (r"\.branch2b\.", ".conv2."),
    (r"\.branch2c\.", ".conv3."),
)

# Phase 2: structural renames (after suffix normalisation).
_STRUCT_REWRITES: tuple[tuple[str, str], ...] = (
    # RPN (the C2 FPN models define the shared RPN head on level "fpn2")
    (r"conv\.rpn\.fpn2", "proposal_generator.rpn_head.conv"),
    (r"conv\.rpn", "proposal_generator.rpn_head.conv"),
    (r"rpn\.bbox\.pred\.fpn2", "proposal_generator.rpn_head.anchor_deltas"),
    (r"rpn\.cls\.logits\.fpn2", "proposal_generator.rpn_head.objectness_logits"),
    (r"rpn\.bbox\.pred", "proposal_generator.rpn_head.anchor_deltas"),
    (r"rpn\.cls\.logits", "proposal_generator.rpn_head.objectness_logits"),
    # Fast R-CNN box head
    (r"^bbox\.pred", "bbox_pred"),
    (r"^cls\.score", "cls_score"),
    (r"^fc6\.", "box_head.fc1."),
    (r"^fc7\.", "box_head.fc2."),
    (r"^head\.conv", "box_head.conv"),
    # Mask head
    (r"\.\[mask\]\.fcn", "mask_head.mask_fcn"),
    (r"^\.mask\.fcn", "mask_head.mask_fcn"),
    (r"mask\.fcn\.logits", "mask_head.predictor"),
    (r"conv5\.mask", "mask_head.deconv"),
    # Keypoint head
    (r"conv\.fcn", "roi_heads.keypoint_head.conv_fcn"),
    (r"kps\.score\.lowres", "roi_heads.keypoint_head.score_lowres"),
    (r"kps\.score\.", "roi_heads.keypoint_head.score."),
)

_HARDCODED = {"pred_b": "linear.bias", "pred_w": "linear.weight"}


def c2_blob_to_d2_name(blob: str) -> str:
    """Rename one Caffe2 blob to its detectron2 state_dict name."""
    if blob in _HARDCODED:
        return _HARDCODED[blob]
    key = blob.replace("_", ".")
    for pat, rep in _SUFFIX_REWRITES:
        key = re.sub(pat, rep, key)
    # FPN lateral/output convs keep underscores in d2 names; map on the
    # suffix-normalised form: fpn.inner.res{s}.*.lateral.<leaf> ->
    # fpn_lateral{s}[.norm].<leaf>, fpn.res{s}.* -> fpn_output{s}[.norm].<leaf>.
    parts = key.split(".")
    if key.startswith("fpn."):
        norm = ".norm" if "norm" in parts else ""
        if parts[1] == "inner" and parts[2].startswith("res"):
            return f"fpn_lateral{parts[2][3:]}{norm}.{parts[-1]}"
        if parts[1].startswith("res"):
            return f"fpn_output{parts[1][3:]}{norm}.{parts[-1]}"
    for pat, rep in _STRUCT_REWRITES:
        key = re.sub(pat, rep, key)
    return key


def convert_c2_weights(weights: dict[str, Any]) -> dict[str, np.ndarray]:
    """Rename a Caffe2 blob dict to detectron2 names and apply the
    background-class weight surgery (c2_model_loading.py:183-204
    semantics)."""
    out: dict[str, np.ndarray] = {}
    for blob, value in sorted(weights.items()):
        v = np.asarray(value)
        name = c2_blob_to_d2_name(blob)
        if name.startswith("bbox_pred."):
            v = v[4:]  # drop the background class's 4 deltas
        elif name.startswith("mask_head.predictor."):
            v = v[1:]
        elif name.startswith("cls_score."):
            v = np.concatenate([v[1:], v[:1]])  # background: first -> last
        out[name] = v
    return out


# Deterministic version of d2's suffix matching for GeneralizedRCNN-FPN:
# bare zoo names -> fully-qualified model.state_dict() names.
_PREFIX_RULES: tuple[tuple[str, str], ...] = (
    (r"^(stem|res[2-5])\.", "backbone.bottom_up."),
    (r"^(fpn_lateral|fpn_output)", "backbone."),
    (r"^box_head\.", "roi_heads."),
    (r"^(cls_score|bbox_pred)\.", "roi_heads.box_predictor."),
    (r"^mask_head\.", "roi_heads."),
)


def qualify_rcnn_names(weights: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    out = {}
    for name, v in weights.items():
        for pat, prefix in _PREFIX_RULES:
            if re.match(pat, name):
                name = prefix + name
                break
        out[name] = v
    return out


def load_detectron_pickle(path: str) -> dict[str, Any]:
    """Read a detectron2/Caffe2 ``.pkl`` checkpoint. Returns
    ``{"model": {...}, "__author__": ..., "matching_heuristics": ...}``."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "model" not in data:  # raw blob dict
        data = {"model": data, "__author__": "Caffe2", "matching_heuristics": True}
    return data


def zoo_model_to_flax(data: dict[str, Any], pooler_resolution: int = 7) -> dict:
    """A loaded zoo checkpoint (:func:`load_detectron_pickle`) -> the
    partial params tree for ``torch_import.merge_pretrained``. Takes both
    Caffe2-named and d2-native pickles (d2-native: already state dict
    names, ``__author__`` not Caffe2 and no ``matching_heuristics``)."""
    weights = {k: np.asarray(v) for k, v in data["model"].items()}
    author = data.get("__author__", "")
    if author == "Caffe2" or data.get("matching_heuristics", False):
        weights = qualify_rcnn_names(convert_c2_weights(weights))
    return detectron2_torch_to_flax(weights, pooler_resolution=pooler_resolution)


def zoo_pickle_to_flax(path: str, pooler_resolution: int = 7) -> dict:
    """:func:`zoo_model_to_flax` of the ``.pkl`` at ``path``."""
    return zoo_model_to_flax(load_detectron_pickle(path), pooler_resolution)
