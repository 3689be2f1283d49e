"""Tensor ops of the port: geometry, boxes, NMS (K4), ROI pooling (K2), crop (K1), decode, PnP."""
