"""Host-side data edges of the port: camera models and the COCO / pred.mat / poses file contract."""
