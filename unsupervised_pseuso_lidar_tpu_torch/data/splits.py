"""Split-file generation from a KITTI tree (host-side).

Counterpart of unsupervised_pseuso_lidar_tpu/data/splits.py
(kitti_depth_annotated_prepare :24, raw_drive_split :67), copied because
the port imports nothing of the JAX package; the files it writes are the
same bytes. One `ref_offset` serves both the neighbours' existence check
and the paths written.
"""

from __future__ import annotations

import glob
import os
from typing import List


def _frame_path(image_dir: str, index: int) -> str:
    return os.path.join(image_dir, f"{index:010d}.png")


def _write_lines(output_path: str, lines: List[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def kitti_depth_annotated_prepare(
    kitti_root: str,
    depth_annotated_root: str,
    output_path: str,
    split: str = "train",
    ref_offset: int = 1,
    camera: str = "image_02",
) -> List[str]:
    """Write a split file pairing raw KITTI frames with annotated depth:
    one line "<tgt> <ref-k> <ref+k> <gt_depth>" for every annotated frame
    of <depth_annotated_root>/<split>/<drive>/proj_depth/groundtruth/
    <camera>/ whose two neighbours exist under <kitti_root>/<date>/<drive>/
    <camera>/data. Returns the lines."""
    lines: List[str] = []
    gt_glob = os.path.join(
        depth_annotated_root, split, "*", "proj_depth", "groundtruth", camera, "*.png"
    )
    for gt_path in sorted(glob.glob(gt_glob)):
        drive = os.path.basename(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(gt_path))))
        )
        date = drive[:10]
        frame = int(os.path.splitext(os.path.basename(gt_path))[0])
        image_dir = os.path.join(kitti_root, date, drive, camera, "data")
        tgt = _frame_path(image_dir, frame)
        ref0 = _frame_path(image_dir, frame - ref_offset)
        ref1 = _frame_path(image_dir, frame + ref_offset)
        if all(os.path.exists(p) for p in (tgt, ref0, ref1)):
            lines.append(f"{tgt} {ref0} {ref1} {gt_path}")
    _write_lines(output_path, lines)
    return lines


def raw_drive_split(
    drive_dir: str,
    output_path: str,
    ref_offset: int = 1,
    camera: str = "image_02",
) -> List[str]:
    """Write a split without ground truth ("<tgt> <ref-k> <ref+k>" a line)
    over one raw drive directory; evaluate it with velodyne ground truth
    (`datasets.velo_gt`, `cli.evaluate --velo-gt`). Returns the lines."""
    image_dir = os.path.join(drive_dir, camera, "data")
    frames = sorted(
        int(os.path.splitext(os.path.basename(p))[0])
        for p in glob.glob(os.path.join(image_dir, "*.png"))
    )
    have = set(frames)
    lines: List[str] = []
    for frame in frames:
        if frame - ref_offset in have and frame + ref_offset in have:
            lines.append(
                f"{_frame_path(image_dir, frame)} "
                f"{_frame_path(image_dir, frame - ref_offset)} "
                f"{_frame_path(image_dir, frame + ref_offset)}"
            )
    _write_lines(output_path, lines)
    return lines
