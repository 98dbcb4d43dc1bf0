"""Port parity for the serving export (pseudolidar/export.py, cli/export.py):
torch.export programs of the depth model, alone and fused with the
projector, written, reloaded and run on the CPU, and held to the live
modules and to the JAX package's make_depth_cloud_fn on the same weights
(test_torch_slice's models, 64x96).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import HEIGHT, WIDTH, _write_calib, models  # noqa: F401
from unsupervised_pseuso_lidar_tpu.pseudolidar import export as jax_export
from unsupervised_pseuso_lidar_tpu.pseudolidar.projector import PseudoLiDAR as JaxPseudoLiDAR
from unsupervised_pseuso_lidar_tpu_torch.cli import export as export_cli
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar import export
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import DepthToPointCloudPipeline
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR

torch.set_num_threads(1)
RNG = np.random.default_rng(71)
# an exported program against its live module (cli.export --verify's bound,
# JAX's); the fused program against JAX's as test_torch_slice holds the
# serve pipeline: depth rel 1e-4, valid masks apart on < 0.1 % of pixels,
# points atol 1e-3 m
TOL = 2e-5
DEPTH_RTOL, MASK_SHARE, POINTS_ATOL = 1e-4, 1e-3, 1e-3


def _img(batch):
    return torch.from_numpy(RNG.uniform(-1, 1, (batch, HEIGHT, WIDTH, 3)).astype(np.float32))


def _live(fn, img):
    with torch.no_grad():
        return fn(img)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_concrete_and_batch_poly_round_trips(models, tmp_path, precision):  # noqa: F811
    # one program traced at batch 2 with a symbolic batch that runs at 1
    # and 3, and (fp32) a concrete batch-2 one; bf16 runs the model under
    # autocast, the weights stay fp32
    _, _, _, depth, _ = models
    fn = export.make_depth_fn(depth, precision=precision)
    concrete, poly = str(tmp_path / "c.pt2"), str(tmp_path / "p.pt2")
    export.export_program(fn, [_img(2)], poly, batch_poly=True)
    assert all(p.dtype == torch.float32 for p in export.load_exported(poly).state_dict.values()
               if p.is_floating_point())
    if precision == "fp32":
        export.export_program(fn, [_img(2)], concrete)
        img = _img(2)
        got = export.run_exported(concrete, img, device="cpu")
        assert got.shape == (2, HEIGHT, WIDTH)
        np.testing.assert_allclose(got.numpy(), _live(fn, img).numpy(), rtol=TOL, atol=TOL)
        with pytest.raises(RuntimeError, match="to be equal to 2"):
            export.run_exported(concrete, _img(3), device="cpu")  # the batch is fixed
    for batch in (1, 3):
        img = _img(batch)
        got = export.run_exported(poly, img.numpy(), device="cpu")
        assert got.shape == (batch, HEIGHT, WIDTH)
        np.testing.assert_allclose(got.numpy(), _live(fn, img).numpy(), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="example batch"):
        export.export_program(fn, [_img(1)], poly, batch_poly=True)


def test_fused_program_matches_jax(models, tmp_path):  # noqa: F811
    # the batch-polymorphic fused program (depth -> cloud) at batch 3
    # against JAX's make_depth_cloud_fn on the same weights and calib, the
    # depth through the monodepth2 range mapping (min_depth given)
    jax_depth, _, state, depth, _ = models
    calib = _write_calib(tmp_path / "calib")
    path = str(tmp_path / "fused.pt2")
    fused = export.make_depth_cloud_fn(export.make_depth_fn(depth, min_depth=0.5, max_depth=80.0),
                                       PseudoLiDAR(calib, device="cpu"))
    export.export_program(fused, [_img(2)], path, batch_poly=True)
    img = _img(3)
    got = export.run_exported(path, img, device="cpu")
    variables = {"params": state.params["depth"], "batch_stats": state.batch_stats["depth"]}
    ref_fn = jax_export.make_depth_cloud_fn(
        jax_export.make_depth_fn(jax_depth, variables, min_depth=0.5, max_depth=80.0),
        JaxPseudoLiDAR(calib))
    ref = [np.asarray(a) for a in jax.jit(ref_fn)(jnp.asarray(img.numpy()))]
    (depth_, points, valid) = (a.numpy() for a in got)
    assert depth_.shape == (3, HEIGHT, WIDTH) and points.shape == (3, HEIGHT * WIDTH, 4)
    assert valid.shape == (3, HEIGHT * WIDTH) and valid.dtype == np.bool_ and valid.any()
    np.testing.assert_allclose(depth_, ref[0], rtol=DEPTH_RTOL)
    assert 0.5 <= depth_.min() and depth_.max() <= 80.0
    assert np.mean(valid != ref[2]) < MASK_SHARE
    both = valid & ref[2]
    np.testing.assert_allclose(points[both], ref[1][both], atol=POINTS_ATOL)
    # and the live fused module gives the same bits as the program
    for a, b in zip(got, _live(fused, img)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_sidecar_describes_the_artifact(models, tmp_path):  # noqa: F811
    # the reserved fields describe the artifact and win over metadata
    _, _, _, depth, _ = models
    path = str(tmp_path / "art" / "d.pt2")
    metadata = {"model": "DispResNet", "format": "x", "device": "tpu", "inputs": [],
                "outputs": None, "size_bytes": 1, "torch_version": "0"}
    export.export_program(export.make_depth_fn(depth), [_img(2)], path, batch_poly=True,
                          metadata=metadata)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    assert sidecar["model"] == "DispResNet"
    assert sidecar["format"] == "torch.export.ExportedProgram"
    assert sidecar["device"] == "cpu" and sidecar["torch_version"] == torch.__version__
    assert sidecar["inputs"] == [{"shape": ["b", str(HEIGHT), str(WIDTH), "3"],
                                  "dtype": "float32"}]
    assert sidecar["outputs"] == [{"shape": ["b", str(HEIGHT), str(WIDTH)],
                                   "dtype": "float32"}]
    # the weights are in the archive (DispResNet-18's ~14M fp32
    # parameters), the trace's example input is not
    assert sidecar["size_bytes"] == os.path.getsize(path) > 4 * 10_000_000
    assert export.load_exported(path).example_inputs is None


def test_run_exported_refuses_another_device(models, tmp_path):  # noqa: F811
    # a program runs where it was traced: another device, or an input on
    # another device, raises instead of moving anything ("meta" stands in
    # for a second device on a host without a card)
    _, _, _, depth, _ = models
    path = str(tmp_path / "d.pt2")
    export.export_program(export.make_depth_fn(depth), [_img(1)], path)
    with pytest.raises(ValueError, match="traced on cpu"):
        export.run_exported(path, _img(1), device="meta")
    with pytest.raises(ValueError, match="an input is on meta"):
        export.run_exported(path, _img(1).to("meta"), device="cpu")


def test_an_exported_program_serves_the_pipeline(models, tmp_path):  # noqa: F811
    # a loaded batch-polymorphic program as the pipeline's depth function,
    # on a 3-camera step: the live model's results
    _, _, _, depth, _ = models
    path = str(tmp_path / "d.pt2")
    fn = export.make_depth_fn(depth)
    export.export_program(fn, [_img(2)], path, batch_poly=True)
    calib = _write_calib(tmp_path / "calib")
    pipes = [DepthToPointCloudPipeline(f, PseudoLiDAR(calib, device="cpu"), device="cpu")
             for f in (export.load_exported(path).module(), fn)]
    frames = _img(3).numpy()
    for got, want in zip(*(p.process_batch(frames) for p in pipes)):
        np.testing.assert_allclose(got.depth, want.depth, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.points, want.points, rtol=TOL, atol=TOL)


def test_cli_export_verify_and_torch_format(tmp_path, capsys):
    # the fused batch-polymorphic program with --verify on the CPU; --format
    # torch writes the reference-schema .pth and warns that the pose net is
    # its init
    out = str(tmp_path / "d.pt2")
    calib = _write_calib(tmp_path / "calib")
    program = export_cli.main(["--config", "configs/test_config.yaml", "--out", out,
                               "--height", str(HEIGHT), "--width", str(WIDTH),
                               "--calib", calib, "--batch-poly", "--verify", "--device", "cpu"])
    assert "verify OK" in capsys.readouterr().out
    assert isinstance(program, torch.export.ExportedProgram)
    with open(out + ".json") as f:
        sidecar = json.load(f)
    assert sidecar["fused_pointcloud"] and sidecar["weights"] == "init (untrained)"
    assert [o["shape"][0] for o in sidecar["outputs"]] == ["b"] * 3
    pth = str(tmp_path / "sfm.pth")
    assert export_cli.main(["--config", "configs/test_config.yaml", "--out", pth,
                            "--epoch", "3", "--device", "cpu"]) is None
    assert "RANDOM INIT" in capsys.readouterr().out
    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == 3
    assert "encoder.encoder.conv1.weight" in ckpt["dpth_mdl_state_dict"]
    assert "conv1.0.weight" in ckpt["pose_mdl_state_dict"]


def test_cli_export_refuses(tmp_path, capsys):
    # an explicit checkpoint that restores nothing, and the BTS serving
    # blob of a config whose depth model is not BtsModel (JAX's
    # parser.error)
    base = ["--out", str(tmp_path / "x.pt2"), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="no restorable state"):
        export_cli.main(["--config", "configs/test_config.yaml", *base,
                         "--checkpoint", str(tmp_path / "no_such_ckpt")])
    with pytest.raises(SystemExit):
        export_cli.main(["--config", "configs/test_config.yaml", *base,
                         "--format", "bts-serving"])
    assert "requires model.depth.name: BtsModel" in capsys.readouterr().err


def test_cli_export_serves_the_other_depth_models(tmp_path, capsys):
    # StnDispNet's and DispNetS' programs with --verify (the finest scale
    # through disp_to_depth), and BtsModel's metric depth (its last
    # output, 80·sigmoid), each against its live module
    for name in ("StnDispNet", "DispNetS", "BtsModel"):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(f"model:\n  depth:\n    name: {name}\n")
        out = str(tmp_path / f"{name}.pt2")
        export_cli.main(["--config", str(cfg), "--out", out, "--height", str(HEIGHT),
                         "--width", str(WIDTH), "--verify", "--device", "cpu"])
        assert "verify OK" in capsys.readouterr().out
        with open(out + ".json") as f:
            assert json.load(f)["model"] == name
        depth = export.run_exported(out, _img(1), device="cpu")
        assert depth.shape == (1, HEIGHT, WIDTH)
        if name == "BtsModel":
            assert 0.0 < float(depth.min()) and float(depth.max()) < 80.0