"""Correspondence search, selection, fitting, maps and initializers on tensors.

``fused_nn`` and ``pallas_nn`` wrap the 1-NN CUDA kernel (``csrc/nn.cu``);
``nn`` is its plain PyTorch version; ``select``, ``rigid_fit``,
``grid_nn``, ``ndt`` (voxel-Gaussian maps), ``covariance`` (information
matrices), ``coarse`` (global initial guesses; its 3D scoring is the
kernel's K2 wrapper), ``filters`` (outlier removal) and ``descriptor``
(Scan Context place recognition) are plain PyTorch.
"""

from . import (coarse, covariance, descriptor, filters, fused_nn, grid_nn, ndt, nn, pallas_nn,
               rigid_fit, select)

__all__ = ["coarse", "covariance", "descriptor", "filters", "fused_nn", "grid_nn", "ndt", "nn",
           "pallas_nn", "rigid_fit", "select"]
