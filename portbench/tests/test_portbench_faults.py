"""`correct` comes out false when the timed path is broken underneath.

Each test drives a whole run of a cell's driver on the CPU at a small
size (the look for a card skipped: the drivers take the device), with one
fault planted in the program, and sees `correct` false; the same run
unbroken sees it true. The faults a cell can have:

- a step that returns its state unchanged (training: Adam never steps;
  serving: the previous unit's answer served again);
- half of the batch left out, the mean taken over the rest (training: the
  loss over the first half of the batch; the rig: the first camera's
  answer served for both);
- an answer altered where it is produced (a served point moved, a served
  depth scaled; training: one leaf's gradient dropped before Adam).

One chip, so there is no exchange between chips to leave out.
"""

from __future__ import annotations

import copy
import time

import pytest
import torch

from portbench.core import spec

SEED = 3000000019


def small(name: str) -> spec.Cell:
    """The cell at a size a CPU test holds: training 64x128, batch 2, 4
    batches; serving 64x96, 4 frames, every other unit checked."""
    cell = spec.load_cell(name)
    config = copy.deepcopy(cell.config)
    if "trainer" in config:
        aug = config["trainer"]["datasets"]["augmentation"]
        aug["image_height"], aug["image_width"] = 64, 128
        config["trainer"]["action"]["batch_size"] = 2
        cell.traffic = dict(cell.traffic, batches=4)
    else:
        sy, sx = 64 / config["input"]["height"], 96 / config["input"]["width"]
        config["input"]["height"], config["input"]["width"] = 64, 96
        # the camera scaled to the small frame, as the cell's is to its own
        for key in ("K_02", "P_rect_02"):
            m = config["calib"][key]
            cols = len(m) // 3
            for col in range(cols):
                m[col] *= sx
                m[cols + col] *= sy
        cell.traffic = dict(cell.traffic, frames=4, check_stride=2, checked_frames=2)
    cell.config = config
    return cell


def run(name: str, seconds: float = 0.5):
    torch.manual_seed(0)
    torch.set_num_threads(4)
    cell = small(name)
    return spec.driver(cell).run(cell, SEED, seconds, False, torch.device("cpu"),
                                 time.perf_counter())


@pytest.fixture
def trainer_step():
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import TrainStep

    return TrainStep


def test_a_sound_training_run_is_correct():
    outcome = run("train.r18_1280")
    assert outcome.correct, outcome.checks
    assert outcome.attempted > 0


def test_training_state_left_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    outcome = run("train.r18_1280")
    assert not outcome.correct
    assert outcome.checks["change_gap"][0] > outcome.checks["change_gap"][1]


def test_half_of_the_training_batch_left_out_is_caught(monkeypatch, trainer_step):
    whole = trainer_step.loss_fn

    def first_half(self, batch):
        n = batch["tgt"].shape[0] // 2
        return whole(self, {k: v[:n] if torch.is_tensor(v) and v.ndim and v.shape[0] == 2 * n
                            else v for k, v in batch.items()})

    monkeypatch.setattr(trainer_step, "loss_fn", first_half)
    outcome = run("train.r18_1280")
    assert not outcome.correct
    assert outcome.checks["grad_gap"][0] > outcome.checks["grad_gap"][1]


def test_a_dropped_gradient_leaf_is_caught(monkeypatch):
    step = torch.optim.Adam.step

    def drop_one(self, closure=None):
        leaf = self.param_groups[0]["params"][0]
        if leaf.grad is not None:
            leaf.grad.zero_()
        return step(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", drop_one)
    outcome = run("train.r18_1280")
    assert not outcome.correct


@pytest.fixture
def pipeline_class():
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import (
        DepthToPointCloudPipeline,
    )

    return DepthToPointCloudPipeline


@pytest.mark.parametrize("name", ["serve.bts1216", "serve.bts1216_rig2"])
def test_a_sound_serving_run_is_correct(name):
    outcome = run(name, seconds=1.0)
    assert outcome.correct, outcome.checks


def test_a_moved_point_is_caught(monkeypatch, pipeline_class):
    process = pipeline_class.process

    def moved(self, img, frame_index=0):
        result = process(self, img, frame_index)
        result.points[len(result.points) // 2, 0] += 0.05
        return result

    monkeypatch.setattr(pipeline_class, "process", moved)
    outcome = run("serve.bts1216", seconds=1.0)
    assert not outcome.correct
    assert outcome.checks["cloud_gap_m"][0] > outcome.checks["cloud_gap_m"][1]


def test_a_scaled_depth_is_caught(monkeypatch, pipeline_class):
    process = pipeline_class.process

    def scaled(self, img, frame_index=0):
        result = process(self, img, frame_index)
        result.depth = result.depth * 1.05
        return result

    monkeypatch.setattr(pipeline_class, "process", scaled)
    outcome = run("serve.bts1216", seconds=1.0)
    assert not outcome.correct
    assert outcome.checks["depth_tf32_gap"][0] > outcome.checks["depth_tf32_gap"][1]


def test_a_stale_answer_is_caught(monkeypatch, pipeline_class):
    process = pipeline_class.process
    last = []

    def stale(self, img, frame_index=0):
        result = process(self, img, frame_index)
        last.append(result)
        return last[-2] if len(last) > 1 else result

    monkeypatch.setattr(pipeline_class, "process", stale)
    outcome = run("serve.bts1216", seconds=1.0)
    assert not outcome.correct


def test_half_of_the_rig_left_out_is_caught(monkeypatch, pipeline_class):
    process_batch = pipeline_class.process_batch

    def first_camera(self, imgs, frame_index=0):
        results = process_batch(self, imgs, frame_index)
        return [results[0]] * len(results)

    monkeypatch.setattr(pipeline_class, "process_batch", first_camera)
    outcome = run("serve.bts1216_rig2", seconds=1.0)
    assert not outcome.correct
    assert outcome.checks["depth_tf32_gap"][0] > outcome.checks["depth_tf32_gap"][1]
