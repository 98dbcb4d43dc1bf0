"""Single-image depth inference entry point.

Counterpart of unsupervised_pseuso_lidar_tpu/cli/inference.py (main
:20-99): the config's depth model with its serving weights
(train/checkpoint.load_serving_weights) on one frame -> depth in meters,
optionally saved, and optionally a pseudo-LiDAR cloud. As in JAX, the
depth is the model's first output through disp_to_depth for every model,
BtsModel too (whose first output is its 8x8 LPG depth / 80, not a
disparity; cli.pipeline and cli.export serve its metric depth).

  python -m unsupervised_pseuso_lidar_tpu_torch.cli.inference \\
      --config configs/basic_config.yaml --image frame.png \\
      [--torch-checkpoint x.pth | --checkpoint DIR] [--output depth.npy|.png] \\
      [--calib KITTI/2011_09_26 --cloud out.bin|.npy] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Single-image depth inference")
    parser.add_argument("--config", default="configs/basic_config.yaml")
    parser.add_argument("--image", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint directory (default: the config's)")
    parser.add_argument("--torch-checkpoint", default=None,
                        help="reference .pth (or .npz) weights to serve")
    parser.add_argument("--output", default=None, help="save depth .npy/.png")
    parser.add_argument("--calib", default=None,
                        help="KITTI calib dir: also emit a pseudo-LiDAR cloud")
    parser.add_argument("--cloud", default=None, help="cloud output .npy or .bin")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; raises without one)")
    args = parser.parse_args(argv)

    import torch

    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import make_depth_fn
    from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import load_serving_weights
    from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import create_train_state
    from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device
    from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import load_image

    device = resolve_device(args.device)
    config = load_config(args.config)
    state = create_train_state(
        config, torch.Generator().manual_seed(config.action.random_seed), device=device
    )
    load_serving_weights(config, state, torch_checkpoint=args.torch_checkpoint,
                         checkpoint=args.checkpoint)

    img, _, _ = load_image(args.image, config.image_shape)
    depth_fn = make_depth_fn(state.depth_model, precision=config.action.precision)
    with torch.no_grad():
        depth = depth_fn(torch.as_tensor(img[None], device=device))[0].cpu().numpy()
    print(
        f"depth: shape={depth.shape} min={depth.min():.2f} "
        f"max={depth.max():.2f} median={np.median(depth):.2f} m"
    )
    if args.output:
        if args.output.endswith(".npy"):
            np.save(args.output, depth)
        else:
            from PIL import Image

            vis = (255 * (1.0 / depth) / (1.0 / depth).max()).astype(np.uint8)
            Image.fromarray(vis).save(args.output)
        print(f"wrote {args.output}")

    if args.calib:
        from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import (
            PseudoLiDAR,
            save_cloud,
        )

        cloud = PseudoLiDAR(args.calib, device=device).project_PL(depth)
        print(f"pseudo-LiDAR cloud: {cloud.shape[0]} points")
        if args.cloud:
            save_cloud(args.cloud, cloud)
            print(f"wrote {args.cloud}")
    return depth


if __name__ == "__main__":
    main()
