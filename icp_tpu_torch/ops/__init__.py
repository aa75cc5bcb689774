"""Correspondence search, selection, fitting and maps on tensors.

``fused_nn`` and ``pallas_nn`` wrap the 1-NN CUDA kernel (``csrc/nn.cu``);
``nn`` is its plain PyTorch version; ``select``, ``rigid_fit``,
``grid_nn``, ``ndt`` (voxel-Gaussian maps) and ``covariance`` (information
matrices) are plain PyTorch.
"""

from . import covariance, fused_nn, grid_nn, ndt, nn, pallas_nn, rigid_fit, select

__all__ = ["covariance", "fused_nn", "grid_nn", "ndt", "nn", "pallas_nn", "rigid_fit", "select"]
