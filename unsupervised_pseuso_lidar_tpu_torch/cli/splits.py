"""Split-file preparation entry point.

Counterpart of unsupervised_pseuso_lidar_tpu/cli/splits.py: the
annotated-depth split (raw frames paired with data_depth_annotated ground
truth) and the split without ground truth over one raw drive (evaluate it
with `cli.evaluate --velo-gt`). The files are the same bytes as the JAX
package writes.

  python -m unsupervised_pseuso_lidar_tpu_torch.cli.splits annotated \\
      --kitti /data/kitti_raw --depth /data/data_depth_annotated \\
      --out splits/kitti_ext.txt [--split train] [--ref-offset 1]
  python -m unsupervised_pseuso_lidar_tpu_torch.cli.splits drive \\
      --drive /data/kitti_raw/2011_09_26/2011_09_26_drive_0001_sync \\
      --out splits/drive0001.txt
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="KITTI split-file preparation")
    sub = parser.add_subparsers(dest="mode", required=True)

    ann = sub.add_parser("annotated",
                         help="pair raw frames with data_depth_annotated GT")
    ann.add_argument("--kitti", required=True,
                     help="KITTI raw root (date dirs with drive_sync subdirs)")
    ann.add_argument("--depth", required=True, help="data_depth_annotated root")
    ann.add_argument("--out", required=True, help="output split file")
    ann.add_argument("--split", default="train", choices=("train", "val"))
    ann.add_argument("--ref-offset", type=int, default=1,
                     help="temporal distance of the reference frames")
    ann.add_argument("--camera", default="image_02")

    drv = sub.add_parser("drive",
                         help="split without GT over one raw drive (--velo-gt eval)")
    drv.add_argument("--drive", required=True, help="raw drive directory")
    drv.add_argument("--out", required=True, help="output split file")
    drv.add_argument("--ref-offset", type=int, default=1)
    drv.add_argument("--camera", default="image_02")

    args = parser.parse_args(argv)

    from unsupervised_pseuso_lidar_tpu_torch.data.splits import (
        kitti_depth_annotated_prepare,
        raw_drive_split,
    )

    if args.mode == "annotated":
        lines = kitti_depth_annotated_prepare(
            args.kitti, args.depth, args.out,
            split=args.split, ref_offset=args.ref_offset, camera=args.camera,
        )
    else:
        lines = raw_drive_split(args.drive, args.out, ref_offset=args.ref_offset,
                                camera=args.camera)
    print(f"wrote {len(lines)} lines to {args.out}")
    return lines


if __name__ == "__main__":
    main()
