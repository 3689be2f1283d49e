"""Models of the port: HRNet and the Faster R-CNN detector (eval mode), and their int8 forms."""
