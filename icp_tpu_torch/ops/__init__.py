"""Correspondence search, selection, fitting, maps and initializers on tensors.

``fused_nn`` and ``pallas_nn`` wrap the 1-NN CUDA kernel (``csrc/nn.cu``);
``nn`` is its plain PyTorch version; ``select``, ``rigid_fit``,
``grid_nn``, ``ndt`` (voxel-Gaussian maps), ``covariance`` (information
matrices), ``coarse`` (global initial guesses; its 3D scoring is the
kernel's K2 wrapper) and ``filters`` (outlier removal) are plain PyTorch.
"""

from . import coarse, covariance, filters, fused_nn, grid_nn, ndt, nn, pallas_nn, rigid_fit, select

__all__ = ["coarse", "covariance", "filters", "fused_nn", "grid_nn", "ndt", "nn", "pallas_nn",
           "rigid_fit", "select"]
