"""Port parity for the KITTI host data: the image and depth-PNG loaders
(utils/transforms.py), the split files (data/splits.py), the datasets and
their batching (data/kitti.py) and velodyne ground truth (data/velo_gt.py),
against the JAX package over the synthesized mini-KITTI tree of
tests/test_data.py.

Both packages decode and resize with PIL, so frames, depth PNGs and split
files are compared byte for byte; intrinsics and OXTS odometry at atol
1e-7. Velodyne ground truth may differ only at pixels where a projected
coordinate lies within rounding of a pixel edge; those are counted.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_data import DATE, DRIVE, NUM_FRAMES, mini_kitti  # noqa: F401
from unsupervised_pseuso_lidar_tpu.data import kitti as jax_kitti
from unsupervised_pseuso_lidar_tpu.data import splits as jax_splits
from unsupervised_pseuso_lidar_tpu.train.config import Config as JaxConfig
from unsupervised_pseuso_lidar_tpu.utils import transforms as jax_transforms
from unsupervised_pseuso_lidar_tpu_torch.data import kitti, splits
from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
from unsupervised_pseuso_lidar_tpu_torch.utils import transforms

torch.set_num_threads(1)
# 40x30 fixture frames resized up (the config of record's 1242x375 ->
# 1280x384 at a reduced size) and down
SIZES = [(32, 42), (24, 32)]


def _raw(split_path, root="", hw=(24, 32), **datasets):
    return {
        "datasets": {"path": root, "split": split_path, "sequence_length": 3,
                     "augmentation": {"image_height": hw[0], "image_width": hw[1]},
                     **datasets},
        "action": {"batch_size": 2},
    }


def _pair(split_path, root="", hw=(24, 32), **datasets):
    """(port dataset, JAX dataset) over the same split and config."""
    raw = _raw(split_path, root, hw, **datasets)
    return (kitti.UnSupKittiDataset(Config.from_dict(raw)),
            jax_kitti.UnSupKittiDataset(JaxConfig.from_dict(raw)))


def _annotated_split(mini_kitti, tmp_path):  # noqa: F811
    path = str(tmp_path / "annotated.txt")
    splits.kitti_depth_annotated_prepare(mini_kitti["kitti"], mini_kitti["depth"], path)
    return path


def _drive_split(mini_kitti, tmp_path):  # noqa: F811
    path = str(tmp_path / "drive.txt")
    splits.raw_drive_split(os.path.join(mini_kitti["kitti"], DATE, DRIVE), path)
    return path


def _assert_samples_equal(got, ref):
    # byte-equal images and depth, intrinsics and oxts at atol 1e-7
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        if key in ("intrinsics", "oxts"):
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize("ref_offset", [1, 3])
def test_split_files_are_the_bytes_jax_writes(mini_kitti, tmp_path, ref_offset):  # noqa: F811
    drive = os.path.join(mini_kitti["kitti"], DATE, DRIVE)
    for name, port_fn, jax_fn, args in (
        ("annotated", splits.kitti_depth_annotated_prepare,
         jax_splits.kitti_depth_annotated_prepare, (mini_kitti["kitti"], mini_kitti["depth"])),
        ("drive", splits.raw_drive_split, jax_splits.raw_drive_split, (drive,)),
    ):
        ours, theirs = tmp_path / f"{name}_port.txt", tmp_path / f"{name}_jax.txt"
        lines = port_fn(*args, str(ours), ref_offset=ref_offset)
        assert lines == jax_fn(*args, str(theirs), ref_offset=ref_offset)
        assert ours.read_bytes() == theirs.read_bytes()
    assert len(lines) == NUM_FRAMES - 2 * ref_offset


@pytest.mark.parametrize("hw", SIZES)
def test_image_and_depth_loaders_match_jax(mini_kitti, hw):  # noqa: F811
    frame = os.path.join(mini_kitti["kitti"], DATE, DRIVE, "image_02", "data",
                         "0000000002.png")
    gt = os.path.join(mini_kitti["depth"], "train", DRIVE, "proj_depth", "groundtruth",
                      "image_02", "0000000002.png")
    for size in (hw, None):
        got, ref = transforms.load_image_uint8(frame, size), jax_transforms.load_image_uint8(
            frame, size)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[0].dtype == np.uint8 and got[1:] == ref[1:] == (30, 40)
        got, ref = transforms.load_image(frame, size), jax_transforms.load_image(frame, size)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(transforms.load_depth_png(gt, size),
                                      jax_transforms.load_depth_png(gt, size))
    depth = transforms.load_depth_png(gt, hw)
    assert depth.shape == hw and depth.dtype == np.float32 and depth.max() > 1.0


@pytest.mark.parametrize("hw", SIZES)
def test_annotated_dataset_matches_jax(mini_kitti, tmp_path, hw):  # noqa: F811
    split = _annotated_split(mini_kitti, tmp_path)
    ours, theirs = _pair(split, hw=hw)
    assert len(ours) == len(theirs) == NUM_FRAMES - 2
    for a, b in zip(ours.samples, theirs.samples):
        assert (a.tgt, a.ref_imgs, a.oxts, a.groundtruth) == (
            b.tgt, b.ref_imgs, b.oxts, b.groundtruth)
        np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        np.testing.assert_array_equal(a.imu_to_cam, b.imu_to_cam)
    for seed, ratio, shuffle in ((42, 0.4, True), (0, 0.2, True), (3, 0.4, False)):
        assert ours.train_val_indices(seed, ratio, shuffle) == theirs.train_val_indices(
            seed, ratio, shuffle)
    for i in range(len(ours)):
        for with_gt in (True, False):
            _assert_samples_equal(ours.load_sample(i, with_gt),
                                  theirs.load_sample(i, with_gt))
    assert "groundtruth" in ours[0] and ours[0]["tgt"].shape == (*hw, 3)
    assert ours[0]["tgt"].dtype == ours[0]["ref_imgs"].dtype == np.uint8


def test_velodyne_ground_truth_matches_jax(mini_kitti, tmp_path):  # noqa: F811
    split = _drive_split(mini_kitti, tmp_path)
    ours, theirs = _pair(split, velo_gt=True)
    assert [s.groundtruth for s in ours.samples] == [s.groundtruth for s in theirs.samples]
    assert all(s.groundtruth.endswith(".bin") for s in ours.samples)
    edge_pixels = 0
    for i in range(len(ours)):
        got, ref = ours[i], theirs[i]
        gt, ref_gt = got.pop("groundtruth"), ref.pop("groundtruth")
        _assert_samples_equal(got, ref)
        assert gt.dtype == np.float32 and gt.shape == (24, 32)
        differ = (gt > 0) != (ref_gt > 0)
        edge_pixels += int(differ.sum())
        both = (gt > 0) & (ref_gt > 0)
        np.testing.assert_allclose(gt[both], ref_gt[both], rtol=1e-6)
        assert both.sum() >= 2
    # the fixture's returns project to pixel centres: none on an edge
    assert edge_pixels == 0
    # without velo_gt, a split without a ground-truth column has none
    assert "groundtruth" not in _pair(split)[0][0]


def test_stacked_dataset_matches_jax(mini_kitti):  # noqa: F811
    raw = _raw("", root=mini_kitti["kitti"])
    ours = kitti.UnSupStackedDataset(Config.from_dict(raw))
    theirs = jax_kitti.UnSupStackedDataset(JaxConfig.from_dict(raw))
    assert [(s.tgt, s.ref_imgs, s.oxts) for s in ours.samples] == [
        (s.tgt, s.ref_imgs, s.oxts) for s in theirs.samples]
    assert len(ours) == NUM_FRAMES - 2
    for i in (0, len(ours) - 1):
        _assert_samples_equal(ours[i], theirs[i])
        assert "groundtruth" not in ours[i]


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("workers,processes", [(1, False), (3, False), (2, True)])
def test_batches_match_jax(mini_kitti, tmp_path, workers, processes, drop_last):  # noqa: F811
    # the port's pool (threads, or spawned processes) yields the batches
    # JAX's single-threaded loader makes, in order; 5 samples in batches
    # of 2: 2 batches with drop_last, 3 (the last of 1) without
    ours, theirs = _pair(_annotated_split(mini_kitti, tmp_path))
    idx = [4, 0, 3, 1, 2]
    got = list(ours.batches(idx, 2, workers, drop_last=drop_last,
                            use_processes=processes, lookahead=1))
    ref = list(theirs.batches(idx, 2, 1, drop_last=drop_last))
    assert len(got) == len(ref) == (2 if drop_last else 3)
    for a, b in zip(got, ref):
        _assert_samples_equal(a, b)
    assert got[-1]["tgt"].shape[0] == (2 if drop_last else 1)
    no_gt = next(iter(ours.batches(idx, 2, workers, use_processes=processes,
                                   with_groundtruth=False)))
    assert "groundtruth" not in no_gt
    np.testing.assert_array_equal(no_gt["tgt"], got[0]["tgt"])


def test_process_workers_fall_back_to_threads_for_velodyne_gt(mini_kitti, tmp_path):  # noqa: F811
    ours, theirs = _pair(_drive_split(mini_kitti, tmp_path), velo_gt=True)
    with pytest.warns(UserWarning, match="thread workers"):
        got = list(ours.batches([0, 1], 2, 2, use_processes=True))
    _assert_samples_equal(got[0], next(iter(theirs.batches([0, 1], 2, 1))))


def test_collate_stacks_every_key():
    items = [{"a": np.full((2, 3), i, np.float32), "b": np.arange(4) + i} for i in range(3)]
    out = kitti.collate(items)
    assert sorted(out) == ["a", "b"]
    assert out["a"].shape == (3, 2, 3) and out["b"].shape == (3, 4)
    np.testing.assert_array_equal(out["b"][2], np.arange(4) + 2)
    np.testing.assert_array_equal(out["a"], jax_kitti.collate(items)["a"])


def test_decode_cache_reads_back_what_it_wrote(mini_kitti, tmp_path):  # noqa: F811
    frame = os.path.join(mini_kitti["kitti"], DATE, DRIVE, "image_02", "data",
                         "0000000003.png")
    cache = tmp_path / "cache"
    first = transforms.load_image_uint8_cached(frame, (24, 32), str(cache))
    (entry,) = os.listdir(cache)
    assert entry.endswith(".npz")
    for got in (first, transforms.load_image_uint8_cached(frame, (24, 32), str(cache))):
        np.testing.assert_array_equal(got[0], transforms.load_image_uint8(frame, (24, 32))[0])
        assert got[1:] == (30, 40)
    # JAX reads the port's entry: the same key and the same arrays
    np.testing.assert_array_equal(
        jax_transforms.load_image_uint8_cached(frame, (24, 32), str(cache))[0], first[0])
    # a damaged entry is decoded again and rewritten
    (cache / entry).write_bytes(b"not a zip")
    healed = transforms.load_image_uint8_cached(frame, (24, 32), str(cache))
    np.testing.assert_array_equal(healed[0], first[0])
    assert os.listdir(cache) == [entry]
    # the dataset reads through it when datasets.cache_dir is set
    split = _annotated_split(mini_kitti, tmp_path)
    cfg = Config.from_dict(_raw(split, cache_dir=str(tmp_path / "ds_cache")))
    ours = kitti.UnSupKittiDataset(cfg)
    _assert_samples_equal(ours[0], _pair(split)[1][0])
    assert len(os.listdir(tmp_path / "ds_cache")) == 3


def test_missing_split_and_calibration_raise(mini_kitti, tmp_path):  # noqa: F811
    with pytest.raises(FileNotFoundError, match="Split file not found"):
        kitti.UnSupKittiDataset(Config.from_dict(_raw(str(tmp_path / "none.txt"))))
    line = os.path.join(str(tmp_path), "2011_09_30", "x_sync", "image_02", "data", "1.png")
    bad = tmp_path / "bad.txt"
    bad.write_text(f"{line} {line} {line}\n")
    with pytest.raises(FileNotFoundError, match="no calibration"):
        kitti.UnSupKittiDataset(Config.from_dict(_raw(str(bad))))
    assert kitti.find_calib_dir(line) == os.path.join(str(tmp_path), "2011_09_30")
    assert kitti.oxts_path_for_image(line) == os.path.join(
        str(tmp_path), "2011_09_30", "x_sync", "oxts", "data", "1.txt")
