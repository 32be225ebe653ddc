"""PyTorch/CUDA port of robot_aware_control_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module layout (ops/, models/, planning/, ...);
the two Pallas kernels are hand-written CUDA kernels under csrc/.
"""

from robot_aware_control_tpu_torch.config import Config

__all__ = ["Config"]
