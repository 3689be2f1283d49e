"""The port's commands, each also a function that takes data already in memory.

``python -m spacecraft_pose_estimation_tpu_torch.tools.<name>``: the staged
evaluation's three stages, ``export_boxes`` (detector -> real_test.json),
``test_landmarks`` (landmark model -> pred.mat) and ``export_poses`` (PnP ->
opencv_poses.json); ``train_landmarks``, the landmark trainer;
``train_landmarks_da``, the adversarial domain-adaptation trainer of the
CMS models; ``train_detector``, the Faster R-CNN trainer; and the event
camera's commands: ``v2e`` (frames -> SuperSloMo -> DVS events and event
frames), ``e2v`` (events CSV -> frames), ``convert_aedats`` (recordings ->
undistorted frames per scene), ``evaluate_event_pipeline`` (those frames
through the evaluation entry) and ``aedat_to_csv`` (AEDAT-4 -> CSV, a
format conversion on the host without ``--device``); and the DVS training
pipeline: ``make_synthetic_scene`` (a labelled rendered scene and its GT),
``split_images`` (the train/validation/test split), ``convert_to_coco``
(GT poses -> COCO keypoints; these three host tools take no device) and
``train_pipeline_dvs`` (v2e -> split -> COCO -> both trainers, in process);
and the weight files: ``import_weights`` (a reference HRNet or detectron2
``.pth``, or a Caffe2 / detectron2 zoo ``.pkl`` -> a port checkpoint the
trainers resume from) and ``export_weights`` (a landmark checkpoint -> a
reference ``pose_hrnet`` ``.pth``), host conversions without ``--device``
that write CPU tensors, and ``export_model`` (the pose pipeline as a
``torch.export`` program, on CUDA unless given ``--device cpu``).
"""
