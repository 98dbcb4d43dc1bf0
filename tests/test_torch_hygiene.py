"""The port stands alone and runs on the card by default.

  * No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (the module name is matched whole, so the port's own
    ``unsupervised_pseuso_lidar_tpu_torch`` does not count).
  * Importing every module of the port loads no jax module.
  * Entry points called with their default device raise when CUDA is not
    available, instead of running on the CPU.
"""

import ast
import os
import re
import subprocess
import sys

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


def test_default_device_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import (
        DepthToPointCloudPipeline,
    )
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR
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
    state = create_train_state(config, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: build_model("PoseNet"),
        lambda: make_eval_step(depth, pose),
        lambda: PseudoLiDAR(str(tmp_path)),
        lambda: DepthToPointCloudPipeline(lambda img: img, projector),
        lambda: create_train_state(config, torch.Generator().manual_seed(0)),
        lambda: make_train_step(state),
        lambda: Trainer(config),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
