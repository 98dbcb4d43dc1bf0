"""Build and load the port's CUDA kernels.

Each ``*.cu`` file in this directory is one kernel with a plain C entry
point. ``load_libraries()`` compiles every source with its own ``nvcc``
process — all started together — into ``build/torch_ext/`` at the repo
root (listed in .gitignore), then loads the shared libraries with ctypes.
A library's file name carries the hash of its source, of every ``*.cuh``
header in this directory and of the compile flags, so an edited source or
header is rebuilt and an unchanged one is reused.

Binding through a plain C interface keeps PyTorch's headers out of the
build: a file that includes them takes minutes to compile, these take
seconds. A failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

SOURCE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(SOURCE_DIR)))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_ext")
SOURCES = {
    "warp_bilinear": "warp_bilinear.cu",
    "ssim": "ssim.cu",
    "ssim_bwd": "ssim_bwd.cu",
    "div3": "div3.cu",
}
# sm_90a: Hopper. --fmad=false keeps a*b+c as two roundings, like the
# plain PyTorch versions the kernels are held against bit for bit.
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-Xptxas=-v",
    f"-I{SOURCE_DIR}",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin/nvcc, else /usr/local/cuda, else
    the one on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(SOURCE_DIR) if f.endswith(".cuh"))
    for file in (SOURCES[name], *headers):
        with open(os.path.join(SOURCE_DIR, file), "rb") as f:
            digest.update(file.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every kernel whose library is missing, in parallel.

    Returns {name: path of the shared library}. Compiler output (with
    ptxas' register and shared-memory report) goes to <library>.log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: _library_path(name) for name in SOURCES}
    jobs = []
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        log = open(f"{path}.log", "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(SOURCE_DIR, SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, path, tmp, log, proc))
    failures = []
    for name, path, tmp, log, proc in jobs:
        code = proc.wait()
        log.close()
        if code == 0:
            os.replace(tmp, path)  # atomic: a reader never sees half a file
            continue
        with open(f"{path}.log") as f:
            failures.append(f"{SOURCES[name]} (exit {code}):\n{f.read()}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load_libraries() -> Dict[str, ctypes.CDLL]:
    """Build (when needed) and load every kernel library, once per
    process; returns {name: ctypes.CDLL} with argument types declared."""
    with _lock:
        if not _libraries:
            for name, path in build_all().items():
                _libraries[name] = _declare(name, ctypes.CDLL(path))
        return _libraries


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_float)
    if name == "warp_bilinear":
        lib.warp_bilinear_fwd.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, i32, i32,
                                          ptr]
        lib.warp_bilinear_fwd.restype = i32
        lib.warp_bilinear_bwd_grid.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32,
                                               i32, i32, ptr]
        lib.warp_bilinear_bwd_grid.restype = i32
    elif name == "ssim":
        lib.ssim_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                 f32, f32, f32, f32, i32, i32, ptr]
        lib.ssim_fwd.restype = i32
    elif name == "ssim_bwd":
        lib.ssim_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                 f32, f32, f32, f32, i32, i32, ptr]
        lib.ssim_bwd.restype = i32
    elif name == "div3":
        lib.div3_f32.argtypes = [ptr, ptr, i64, i32, ptr]
        lib.div3_f32.restype = i32
    return lib
