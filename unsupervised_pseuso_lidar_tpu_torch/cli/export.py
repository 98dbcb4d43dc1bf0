"""Export a trained depth model, optionally fused with the pseudo-LiDAR
projector, as a `torch.export` serving program.

Counterpart of unsupervised_pseuso_lidar_tpu/cli/export.py (main
:30-204). The default artifact is a `.pt2` (pseudolidar/export.py: the
graph and the weights in one archive, a `.json` sidecar beside it); JAX's
is a StableHLO `jax.export`. `--format torch` (or an `--out` ending in
.pth) instead writes a reference-schema training checkpoint ({epoch,
dpth_mdl_state_dict, pose_mdl_state_dict, optimizer_state_dict, loss,
valid_acc}) from the serving weights, and `--format bts-serving` (a
BtsModel config) the `{"model": module.*}` blob the reference's ROS node
loads. A BtsModel's program serves its final metric depth.

  python -m unsupervised_pseuso_lidar_tpu_torch.cli.export \\
      --config configs/basic_config.yaml --out artifacts/depth.pt2 \\
      [--checkpoint DIR | --torch-checkpoint x.pth] [--batch 4 | --batch-poly] \\
      [--calib KITTI/2011_09_26] [--verify] [--device cpu]

`--device` (default cuda) is where the program is traced and where it
runs: a `.pt2` is bound to its device.
"""

from __future__ import annotations

import argparse
import os

# --verify: the reloaded artifact against the live model (JAX's bound)
VERIFY_TOL = 2e-5


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export depth (+ pseudo-LiDAR) serving artifact"
    )
    parser.add_argument("--config", default="configs/basic_config.yaml")
    parser.add_argument("--out", required=True, help="artifact output path")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint directory (default: the config's)")
    parser.add_argument("--torch-checkpoint", default=None,
                        help="reference .pth (or .npz) weights to export")
    parser.add_argument("--batch", type=int, default=1,
                        help="concrete batch size (with --batch-poly: the "
                        "example batch of the trace, at least 2)")
    parser.add_argument("--batch-poly", action="store_true",
                        help="batch-polymorphic program (symbolic leading dim)")
    parser.add_argument("--height", type=int, default=0,
                        help="override config image height")
    parser.add_argument("--width", type=int, default=0,
                        help="override config image width")
    parser.add_argument("--calib", default=None,
                        help="KITTI calib dir: fuse depth -> point cloud "
                        "into one program")
    parser.add_argument("--sparsity", type=int, default=0)
    parser.add_argument("--verify", action="store_true",
                        help="reload the artifact and check it matches the "
                        "live model on a random input")
    parser.add_argument("--format", default=None,
                        choices=["pt2", "torch", "bts-serving"],
                        help="artifact format (default: pt2, or torch when "
                        "--out ends in .pth)")
    parser.add_argument("--epoch", type=int, default=0,
                        help="epoch tag recorded in a torch-format checkpoint")
    parser.add_argument("--device", default="cuda",
                        help="where the program is traced and runs (default "
                        "cuda; raises without one)")
    args = parser.parse_args(argv)
    fmt = args.format or ("torch" if args.out.endswith(".pth") else "pt2")

    import numpy as np
    import torch

    from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import (
        export_bts_serving_checkpoint,
        export_reference_checkpoint,
        load_serving_weights,
        load_torch_checkpoint,
    )
    from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import create_train_state
    from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    config = load_config(args.config)
    depth_name = config.model.depth.name
    if fmt == "bts-serving" and depth_name != "BtsModel":
        parser.error("--format bts-serving requires model.depth.name: "
                     f"BtsModel (config has {depth_name})")
    state = create_train_state(
        config, torch.Generator().manual_seed(config.action.random_seed), device=device
    )
    weight_source = load_serving_weights(config, state, torch_checkpoint=args.torch_checkpoint,
                                         checkpoint=args.checkpoint)

    if fmt == "torch":
        if args.torch_checkpoint:
            # .npz blobs (ImageNet encoder inits) never carry pose weights
            pose_trained = (not args.torch_checkpoint.endswith(".npz")
                            and "pose_mdl_state_dict"
                            in load_torch_checkpoint(args.torch_checkpoint))
        else:
            pose_trained = weight_source != "init (untrained)"
        if not pose_trained:
            # a reference-side resume of this .pth would pick up random pose
            # weights under trusted provenance
            print("WARNING: pose_mdl_state_dict in the exported checkpoint is "
                  "RANDOM INIT (weight source carries no pose weights); do not "
                  "resume reference-side training from it without retraining "
                  "the pose net")
        export_reference_checkpoint(state.depth_model, state.pose_model, args.out,
                                    epoch=args.epoch, lr=config.action.optimizer.depth_lr)
        print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes, "
              f"reference .pth schema, weights={weight_source})")
        return None
    if fmt == "bts-serving":
        export_bts_serving_checkpoint(state.depth_model, args.out)
        print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes, "
              f"BTS serving blob, weights={weight_source})")
        return None

    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import (
        export_program,
        make_depth_cloud_fn,
        make_depth_fn,
        run_exported,
    )

    height, width = config.image_shape
    height, width = args.height or height, args.width or width
    fn = make_depth_fn(state.depth_model, metric_output=depth_name == "BtsModel",
                       precision=config.action.precision)
    if args.calib:
        from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR

        fn = make_depth_cloud_fn(fn, PseudoLiDAR(args.calib, sparsity=args.sparsity,
                                                 device=device))
    batch = max(args.batch, 2 if args.batch_poly else 1)
    example = torch.zeros(batch, height, width, 3, device=device)
    program = export_program(
        fn, [example], args.out, batch_poly=args.batch_poly,
        metadata={
            "model": depth_name,
            "image_height": height,
            "image_width": width,
            "fused_pointcloud": bool(args.calib),
            "precision": config.action.precision,
            "weights": weight_source,
        },
    )
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes, device={device}, "
          f"batch={'b' if args.batch_poly else batch})")

    if args.verify:
        rng = np.random.default_rng(0)
        img = torch.as_tensor(
            rng.uniform(-1, 1, (max(args.batch, 1), height, width, 3)).astype(np.float32),
            device=device)
        got = run_exported(args.out, img, device=device)
        with torch.no_grad():
            want = fn(img)
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        for a, b in zip(got, want, strict=True):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            if a.dtype == bool:  # the fused program's valid mask
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=VERIFY_TOL, atol=VERIFY_TOL)
        print("verify OK: artifact matches the live model")
    return program


if __name__ == "__main__":
    main()
