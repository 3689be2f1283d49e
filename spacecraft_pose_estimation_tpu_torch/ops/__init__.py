"""Tensor ops of the port: geometry, boxes, NMS (K4), ROI pooling (K2), crop (K1), decode, PnP,
the int8 conv site (K5a) and the fused int8 block chains (K5, K6, K7)."""
