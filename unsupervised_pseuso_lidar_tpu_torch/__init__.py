"""unsupervised_pseuso_lidar_tpu_torch — the PyTorch/CUDA port of
`unsupervised_pseuso_lidar_tpu`, for NVIDIA Hopper (H100) cards.

The JAX package beside it is the reference: every module here mirrors one
there at the same relative path (``losses/reprojection.py`` here is the
counterpart of ``unsupervised_pseuso_lidar_tpu/losses/reprojection.py``)
and the ``tests/test_torch_*.py`` suites hold the two against each other.

Conventions:
  * Activations and images are NCHW; sampling grids are [B, H, W, 2]
    (the ``torch.nn.functional.grid_sample`` layout); depth maps [B, H, W].
  * Entry points take an explicit ``device`` that defaults to ``"cuda"``
    and raise when no CUDA device is present (utils/device.py); tests pass
    ``device="cpu"``.
  * Every TPU (Pallas) kernel on a ported path has a hand-written CUDA
    kernel in ``ops/cuda/`` plus a plain PyTorch version beside it; a
    wrapper launches the kernel for CUDA tensors and runs the plain version
    only for CPU tensors.

This package imports neither ``jax`` nor the JAX package.
"""

__version__ = "0.1.0"
