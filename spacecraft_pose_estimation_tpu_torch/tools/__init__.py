"""The staged evaluation's three stages, each a command and a function that takes frames already in memory.

``python -m spacecraft_pose_estimation_tpu_torch.tools.<stage>``: ``export_boxes`` (detector ->
real_test.json), ``test_landmarks`` (landmark model -> pred.mat) and ``export_poses`` (PnP ->
opencv_poses.json).
"""
