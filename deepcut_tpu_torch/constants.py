"""Framework-wide constants.

The port's own copy of `deepcut_tpu.constants` (jax-free; held against the original
by tests/test_torch_data.py).

MEAN_BGR is the DeeperCut training mean (reference:
models/deepercut/ResNet-152.prototxt pose_data_param / estimate_pose.py:25;
applied in pose_data_layer.cpp:627-667). It is deliberately INTEGER-valued:
the uint8 input pipeline (data/pipeline.PoseDataSource(uint8_images=True))
ships mean-filled uint8 canvases and the model subtracts this constant on
device (models/resnet.prepare_input) — bit-identical to host-side float
subtraction only because every component of the mean is exactly
representable in uint8. Keep a single definition; the uint8 contract breaks
silently if copies drift.
"""

MEAN_BGR = (104.0, 117.0, 123.0)
