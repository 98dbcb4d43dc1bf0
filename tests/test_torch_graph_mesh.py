"""The step as CUDA graphs under a mesh (train/graph.py, parallel/mesh.py):
what the CPU can check.

A graph holds a mesh's collectives only where they run on the card: an
NCCL mesh is captured by default, a gloo mesh (whose collectives run on
the host) never, and graph=True there raises. The host knows a spatial
mesh's image height from the batch it sharded (ShardedBatch.height), so
the body reads no device value to learn it, and the height keys the
graphs. On 2 spawned gloo ranks — a data mesh of 2, then 1 x 2 spatial at
64x96 — the mesh step's body run as a graph replays it (StepGraphs with
capture=False: the first call eager, the later ones on static buffers)
equals the eager mesh step bit for bit: TrainStep, make_multi_step and
EvalStep. The card's NCCL captures: tests/test_torch_cuda.py and
chip_smoke's `mesh_graph` phase.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests import torch_graph_mesh_worker as graph_worker
from tests import torch_parallel_worker as worker
from unsupervised_pseuso_lidar_tpu_torch.data.pipeline import prefetch_to_device
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import synthetic_triplet_batch
from unsupervised_pseuso_lidar_tpu_torch.parallel import distributed
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import Mesh, shard_batch
from unsupervised_pseuso_lidar_tpu_torch.train.graph import graph_enabled

torch.set_num_threads(1)
CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")


@pytest.fixture
def one_rank_gloo():
    """A 1-rank gloo process group in this process (destroyed after)."""
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_a_gloo_mesh_stays_eager_and_refuses_graph_true(one_rank_gloo):
    # a mesh computing on the card whose group is gloo: None is eager,
    # True raises with gloo as the reason, False is eager
    mesh = Mesh(one_rank_gloo, 0, 1, CUDA)
    assert mesh.distributed and not mesh.capturable
    assert graph_enabled(None, CUDA, mesh) is False
    assert graph_enabled(False, CUDA, mesh) is False
    with pytest.raises(ValueError, match="under a gloo mesh"):
        graph_enabled(True, CUDA, mesh)


def test_an_nccl_mesh_on_the_card_is_captured(one_rank_gloo, monkeypatch):
    # the backend as an NCCL group reports it: captured by default and on
    # request; eager with False; the CPU never captures
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    mesh = Mesh(one_rank_gloo, 0, 1, CUDA)
    assert mesh.capturable
    assert graph_enabled(None, CUDA, mesh) is True
    assert graph_enabled(True, CUDA, mesh) is True
    assert graph_enabled(False, CUDA, mesh) is False
    assert not Mesh(one_rank_gloo, 0, 1, CPU).capturable
    assert graph_enabled(None, CPU, Mesh(one_rank_gloo, 0, 1, CPU)) is False


def test_a_mesh_without_a_group_is_the_no_mesh_case():
    mesh = Mesh(None, 0, 1, CUDA)
    assert not mesh.distributed and not mesh.capturable
    assert graph_enabled(None, CUDA, mesh) is True
    assert graph_enabled(True, CUDA, mesh) is True
    assert graph_enabled(None, CPU, mesh) is False


@pytest.mark.parametrize("batch_axis", [0, 1])
def test_shard_batch_records_the_global_height(batch_axis):
    # rank 1 of a 1 x 2 spatial mesh holds the lower band of 64 rows; the
    # batch remembers 64, through a device copy too (prefetch_to_device)
    batch = synthetic_triplet_batch(2, 64, 96, seed=1)
    if batch_axis:
        batch = {k: np.stack([v, v]) for k, v in batch.items()}
    mesh = Mesh(None, 1, 2, CPU, spatial=2)
    sharded = shard_batch(mesh, batch, batch_axis=batch_axis)
    assert sharded["tgt"].shape[batch_axis + 1] == 32 and sharded.height == 64
    assert shard_batch(mesh, sharded, batch_axis=batch_axis) is sharded
    copied = next(prefetch_to_device(iter([sharded]), device="cpu"))
    assert copied.height == 64
    assert shard_batch(Mesh(None, 0, 1, CPU), batch, batch_axis=batch_axis).height == 64


@pytest.mark.parametrize("world,spatial", [(2, 1), (2, 2)], ids=["data2", "spatial1x2"])
def test_mesh_body_on_static_buffers_equals_the_eager_mesh_step(tmp_path, world, spatial):
    # every rank: 2 train steps of two objectives, make_multi_step(2)
    # twice, EvalStep over 2 batches; the static runs make one graph
    # signature each, and graph=None made no graphs under gloo
    for rank, result in enumerate(worker.run_ranks(graph_worker.static_vs_eager, world,
                                                   tmp_path, spatial=spatial)):
        assert not result["differ"], (rank, result["differ"][:8])
        assert not result["default_graphs"], rank
        assert result["signatures"] == {"min": 1, "ssim_supervised": 1, "eval": 1}, rank
