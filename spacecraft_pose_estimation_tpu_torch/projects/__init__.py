"""The detectron2 ``projects/`` family (port of the JAX package's ``projects/``).

PointRend, PointSup, DeepLab, Panoptic-DeepLab, DensePose (chart-based),
TridentNet, ViTDet, MViTv2, TensorMask's SwapAlign2Nat and Rethinking-BN,
on the port's trunks, ASPP, norms, resizes and kernels (DensePose pools
through K2's gather read, TridentNet's branch merge runs K4). Module names
mirror the Flax trees, so ``convert.flax_to_state_dict`` maps the JAX
variables by name. Inputs and outputs keep the JAX modules' channels-last
layout.

Submodules (import directly, e.g. ``from ..projects import point_rend``):
``point_rend``, ``pointsup``, ``deeplab``, ``panoptic_deeplab``,
``densepose``, ``tridentnet``, ``vitdet``, ``mvitv2``, ``tensormask``,
``rethinking_bn``. They are intentionally NOT imported here: each pulls in its model stack, and
callers should pay only for what they use.
"""
