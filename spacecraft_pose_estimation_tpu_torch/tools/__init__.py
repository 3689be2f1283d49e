"""The port's commands, each also a function that takes data already in memory.

``python -m spacecraft_pose_estimation_tpu_torch.tools.<name>``: the staged
evaluation's three stages, ``export_boxes`` (detector -> real_test.json),
``test_landmarks`` (landmark model -> pred.mat) and ``export_poses`` (PnP ->
opencv_poses.json); ``train_landmarks``, the landmark trainer;
``train_landmarks_da``, the adversarial domain-adaptation trainer of the
CMS models; and ``train_detector``, the Faster R-CNN trainer.
"""
