"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

  warp_bilinear.cu  kernel A, bilinear warp (replaces ops/pallas/warp.py)
  ssim.cu           kernel B, SSIM distance forward (replaces
                    ops/pallas/photometric.py's forward kernel)
  build.py          nvcc build into build/torch_ext/ + ctypes loading
  kernels.py        the wrappers and their launch counts
"""
