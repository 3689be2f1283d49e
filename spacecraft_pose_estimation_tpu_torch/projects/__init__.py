"""The detectron2 ``projects/`` family (port of the JAX package's ``projects/``).

PointRend, PointSup, DeepLab and Panoptic-DeepLab, on the port's trunks,
ASPP and resizes. Module names mirror the Flax trees, so
``convert.flax_to_state_dict`` maps the JAX variables by name. Inputs and
outputs keep the JAX modules' channels-last layout.

Submodules (import directly, e.g. ``from ..projects import point_rend``):
``point_rend``, ``pointsup``, ``deeplab``, ``panoptic_deeplab``. They are
intentionally NOT imported here: each pulls in its model stack, and
callers should pay only for what they use.
"""
