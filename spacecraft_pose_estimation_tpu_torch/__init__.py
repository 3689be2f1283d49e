"""PyTorch + CUDA port of the spacecraft pose-estimation serving path.

The JAX package ``spacecraft_pose_estimation_tpu`` is the reference; this
package runs the same detect -> crop -> heatmap -> decode -> PnP path on an
NVIDIA H100, with hand-written CUDA kernels (``csrc/``) where the JAX
package had Pallas TPU kernels. Public functions keep the JAX package's
NHWC layout so the two can be compared tensor for tensor.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
