"""The port stands alone and runs on the card by default.

  * No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (the module name is matched whole, so the port's own
    ``unsupervised_pseuso_lidar_tpu_torch`` does not count).
  * Importing every module of the port loads no jax module, and importing
    each of its packages on its own loads none and builds no kernel.
  * Entry points called with their default device raise when CUDA is not
    available, instead of running on the CPU.
  * An installed port carries its kernels' sources: pyproject.toml ships
    every ``*.cu`` and ``*.cuh`` of ops/cuda as package data.
"""

import ast
import os
import re
import fnmatch
import subprocess
import sys
import tomllib

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "unsupervised_pseuso_lidar_tpu_torch")
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|unsupervised_pseuso_lidar_tpu)(\.|$)")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = _port_files()
    assert len(files) > 20 and os.path.exists(files[0])
    assert os.path.join(PORT, "parallel", "spatial.py") in files
    bad = {
        os.path.relpath(path, REPO): name
        for path in files
        for name in _imported_modules(path)
        if FORBIDDEN.match(name)
    }
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        os.path.relpath(path, REPO)[:-3].replace(os.sep, ".").replace(".__init__", "")
        for path in _port_files()[1:]
    )
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'unsupervised_pseuso_lidar_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_each_package_imports_alone_without_jax_or_a_kernel_build():
    packages = sorted(
        os.path.relpath(root, REPO).replace(os.sep, ".")
        for root, _, names in os.walk(PORT) if "__init__.py" in names
    )
    assert len(packages) >= 12
    code = (
        "import importlib, sys\n"
        f"for name in {packages!r}:\n"
        "    before = set(sys.modules)\n"
        "    importlib.import_module(name)\n"
        "    bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'unsupervised_pseuso_lidar_tpu'))\n"
        "    assert not bad, (name, bad)\n"
        "from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import build\n"
        "assert not build._libraries, build._libraries\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_default_device_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    import numpy as np

    from unsupervised_pseuso_lidar_tpu_torch.cli import evaluate as eval_cli
    from unsupervised_pseuso_lidar_tpu_torch.cli import export as export_cli
    from unsupervised_pseuso_lidar_tpu_torch.cli import inference as inference_cli
    from unsupervised_pseuso_lidar_tpu_torch.cli import odometry as odometry_cli
    from unsupervised_pseuso_lidar_tpu_torch.cli import pipeline as pipeline_cli
    from unsupervised_pseuso_lidar_tpu_torch.cli import train as train_cli
    from unsupervised_pseuso_lidar_tpu_torch.data.pipeline import prefetch_to_device
    from unsupervised_pseuso_lidar_tpu_torch.examples import dino_turntable, toy_problem
    from unsupervised_pseuso_lidar_tpu_torch.eval.pose import make_pose_eval_step
    from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import run_exported
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import (
        DepthToPointCloudPipeline,
    )
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR
    from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import CheckpointManager
    from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
        Trainer,
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    depth = build_model("DispResNet", device="cpu")
    pose = build_model("PoseNet", device="cpu")
    projector = PseudoLiDAR.__new__(PseudoLiDAR)  # no calib files needed
    config = Config()
    config.action.checkpoint_dir = str(tmp_path / "checkpoints")
    state = create_train_state(config, torch.Generator().manual_seed(0), device="cpu")
    # a checkpoint to resume from: Trainer(from_scratch=False) must still
    # raise before it reads one
    CheckpointManager(str(tmp_path / "checkpoints" / config.model.name)).save(state, 0)
    resume = Config()
    resume.action.checkpoint_dir = config.action.checkpoint_dir
    resume.action.from_scratch = False
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("datasets:\n  augmentation:\n    image_width: 64\n"
                   "    image_height: 32\naction:\n  batch_size: 1\n")
    bts_cfg = tmp_path / "bts.yaml"
    bts_cfg.write_text("model:\n  depth:\n    name: BtsModel\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: build_model("PoseNet"),
        lambda: build_model("PoseFc"),
        *(lambda name=name: build_model(name) for name in
          ("BtsModel", "DispNetS", "StnDispNet", "PoseDecoder")),
        lambda: build_model("DispResNet", num_layers=50, all_scales=True),
        lambda: make_eval_step(depth, pose),
        lambda: PseudoLiDAR(str(tmp_path)),
        lambda: DepthToPointCloudPipeline(lambda img: img, projector),
        lambda: create_train_state(config, torch.Generator().manual_seed(0)),
        lambda: make_train_step(state),
        lambda: Trainer(config),
        lambda: Trainer(resume),
        lambda: next(prefetch_to_device(iter([{"x": np.zeros(2)}]))),
        lambda: train_cli.main(["--config", str(cfg), "--synthetic", "--epochs", "1",
                                "--synthetic-batches", "1"]),
        lambda: train_cli.main(["--config", str(cfg), "--epochs", "1"]),  # KITTI
        lambda: eval_cli.main(["--config", str(cfg)]),
        lambda: odometry_cli.main(["--config", str(cfg), "--out", str(tmp_path / "p.txt")]),
        lambda: make_pose_eval_step(pose),
        lambda: pipeline_cli.main(["--images", str(tmp_path), "--calib", str(tmp_path)]),
        lambda: inference_cli.main(["--config", str(cfg), "--image", str(tmp_path / "x.png")]),
        lambda: export_cli.main(["--config", str(cfg), "--out", str(tmp_path / "x.pt2")]),
        lambda: export_cli.main(["--config", str(bts_cfg), "--out", str(tmp_path / "b.pth"),
                                 "--format", "bts-serving"]),
        lambda: pipeline_cli.main(["--images", str(tmp_path), "--calib", str(tmp_path),
                                   "--model", "BtsModel"]),
        lambda: run_exported(str(tmp_path / "x.pt2"), np.zeros((1, 32, 64, 3), np.float32)),
        lambda: toy_problem.run(steps=1),
        lambda: toy_problem.main(["--steps", "1"]),
        lambda: dino_turntable.run(steps=1),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_the_kernel_sources_ship_as_package_data():
    from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import build

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        setuptools = tomllib.load(f)["tool"]["setuptools"]
    assert any(fnmatch.fnmatch("unsupervised_pseuso_lidar_tpu_torch", pattern)
               for pattern in setuptools["packages"]["find"]["include"])
    patterns = setuptools["package-data"]["unsupervised_pseuso_lidar_tpu_torch.ops.cuda"]
    sources = [n for n in os.listdir(build.SOURCE_DIR) if n.endswith((".cu", ".cuh"))]
    assert set(build.SOURCES.values()) <= set(sources) and any(n.endswith(".cuh") for n in sources)
    shipped = {n for n in sources if any(fnmatch.fnmatch(n, p) for p in patterns)}
    assert shipped == set(sources)
