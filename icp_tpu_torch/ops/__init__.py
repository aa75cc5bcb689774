"""Correspondence search, selection and rigid fitting on tensors.

``fused_nn`` and ``pallas_nn`` wrap the 1-NN CUDA kernel (``csrc/nn.cu``);
``nn`` is its plain PyTorch version; ``select`` and ``rigid_fit`` are plain
PyTorch.
"""

from . import fused_nn, nn, pallas_nn, rigid_fit, select

__all__ = ["fused_nn", "nn", "pallas_nn", "rigid_fit", "select"]
