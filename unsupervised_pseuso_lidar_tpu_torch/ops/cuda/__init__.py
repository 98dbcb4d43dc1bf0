"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

  warp_bilinear.cu  kernel A, bilinear warp, and its grid gradient (A′)
                    (replace ops/pallas/warp.py)
  ssim.cu           kernel B, SSIM distance forward (replaces
                    ops/pallas/photometric.py's forward kernel)
  ssim_bwd.cu       kernel C, its gradient (replaces
                    ops/pallas/photometric.py's backward kernel)
  build.py          nvcc build into build/torch_ext/ + ctypes loading
  kernels.py        the wrappers, their launch counts and the autograd
                    Functions
"""
