"""Time variants of kernels B and C with other tiling constants on the card.

    python -m unsupervised_pseuso_lidar_tpu_torch.ops.cuda.tune

A variant rewrites the tiling constants of ssim.cu or ssim_bwd.cu — kCols
(adjacent columns a lane), kSegment (rows a warp walks) and kMinBlocks
(the launch bound's blocks per SM, which caps the registers) — in a copy
under build/tune/, built with the flags of build.py. Each variant is held
against its plain version (kernel B at the main path's two shapes, blend
0.85; kernel C at the warped stack, dx only) and timed like chip_smoke.py
(CUDA events around 20 back-to-back calls, the median of 5 runs), all
variants in turn, then again in reverse order. Prints one JSON line per
variant — ptxas' registers, max abs err, device ms — and, last, the card's
name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess

import torch

from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import build
from unsupervised_pseuso_lidar_tpu_torch.ops.ssim import (
    C1,
    C2,
    photometric_map,
    photometric_map_bwd,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.device import card, device_time_ms

TUNE_DIR = os.path.join(build.REPO_ROOT, "build", "tune")
# (kernel, kCols, kSegment, kMinBlocks); the first of each kernel is the
# design the sources hold
VARIANTS = [
    ("ssim", 2, 48, 8), ("ssim", 1, 48, 8), ("ssim", 4, 48, 1),
    ("ssim", 2, 32, 8), ("ssim", 2, 96, 8), ("ssim", 2, 48, 1),
    ("ssim_bwd", 1, 32, 8), ("ssim_bwd", 2, 32, 1), ("ssim_bwd", 1, 24, 8),
    ("ssim_bwd", 1, 48, 8), ("ssim_bwd", 1, 64, 8), ("ssim_bwd", 1, 32, 1),
]
WEIGHT = 0.85


def _source(kernel: str, cols: int, segment: int, min_blocks: int) -> str:
    with open(os.path.join(build.SOURCE_DIR, build.SOURCES[kernel])) as f:
        text = f.read()
    for name, value in (("kCols", cols), ("kSegment", segment),
                        ("kMinBlocks", min_blocks)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{kernel}: no single constant {name}")
    return text


def build_variants():
    """Compile every variant (one nvcc each, in parallel); returns
    {variant: (ctypes library, ptxas register lines)}."""
    os.makedirs(TUNE_DIR, exist_ok=True)
    jobs = {}
    for variant in VARIANTS:
        stem = "{}_c{}_s{}_b{}".format(*variant)
        src = os.path.join(TUNE_DIR, stem + ".cu")
        with open(src, "w") as f:
            f.write(_source(*variant))
        lib = os.path.join(TUNE_DIR, f"lib{stem}.so")
        jobs[variant] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libraries = {}
    for variant, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        registers = [line.split(":", 1)[1].strip() for line in log.splitlines()
                     if "Used" in line]
        libraries[variant] = (build._declare(variant[0], ctypes.CDLL(lib)), registers)
    return libraries


def _call(kernel, lib, x, y, g):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    planes, (height, width) = x.shape[0] * x.shape[1], x.shape[2:]
    out = torch.empty_like(x)
    if kernel == "ssim":
        code = lib.ssim_fwd(x.data_ptr(), y.data_ptr(), out.data_ptr(), planes,
                            height, width, C1, C2, WEIGHT, 1.0 - WEIGHT, 1,
                            x.device.index, stream)
    else:
        code = lib.ssim_bwd(x.data_ptr(), y.data_ptr(), g.data_ptr(), out.data_ptr(),
                            None, planes, height, width, C1, C2, WEIGHT,
                            1.0 - WEIGHT, 1, x.device.index, stream)
    if code != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError {code}")
    return out


def main(seed=0):
    device = torch.device("cuda", 0)
    libraries = build_variants()
    gen = torch.Generator(device=device).manual_seed(seed)
    inputs = {}
    for jobs in (24, 36):  # the identity pair and the warped stack
        shape = (jobs, 3, 192, 640)
        x = torch.rand(shape, generator=gen, device=device)
        # y near x, equal to it in places: flat windows and ties occur
        y = torch.where(torch.rand(shape, generator=gen, device=device) < 0.3, x,
                        (x + 0.05 * torch.randn(shape, generator=gen, device=device))
                        .clamp(0.0, 1.0))
        inputs[jobs] = (x, y, torch.randn(shape, generator=gen, device=device))
    cases = {"ssim": (24, 36), "ssim_bwd": (36,)}
    records = {}
    for variant, (lib, registers) in libraries.items():
        kernel = variant[0]
        err = 0.0
        for jobs in cases[kernel]:
            x, y, g = inputs[jobs]
            ref = (photometric_map(x, y, WEIGHT) if kernel == "ssim"
                   else photometric_map_bwd(x, y, g, WEIGHT, True, False)[0])
            err = max(err, float((_call(kernel, lib, x, y, g) - ref).abs().max()))
        records[variant] = {"kernel": kernel, "cols": variant[1], "segment": variant[2],
                            "min_blocks": variant[3], "registers": registers,
                            "max_abs_err": err, "ms": []}
    for variant in [*libraries, *reversed(libraries)]:
        kernel, lib = variant[0], libraries[variant][0]
        records[variant]["ms"].append(sum(
            device_time_ms(lambda: _call(kernel, lib, *inputs[jobs])) for jobs in cases[kernel]))
    for record in records.values():
        print(json.dumps(record), flush=True)
    print(card(), flush=True)


if __name__ == "__main__":
    main()
