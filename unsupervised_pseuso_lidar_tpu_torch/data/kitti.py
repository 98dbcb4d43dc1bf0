"""KITTI raw dataset: split-file indexing, calib/OXTS caching, batching.

Counterpart of unsupervised_pseuso_lidar_tpu/data/kitti.py (find_calib_dir
:44, oxts_path_for_image :53, UnSupKittiDataset :87, UnSupStackedDataset
:358, collate :412). The host data stage: PNG decode and resize (PIL,
utils/transforms.py), the calibration (parsed once per drive date), the
OXTS camera-frame odometry and, for split lines without an annotated-depth
column, velodyne ground truth rasterized on CPU tensors (data/velo_gt.py).

  * The calib directory is the path up to the KITTI date component
    (YYYY_MM_DD); the OXTS file of a frame is <drive>/oxts/data/<frame>.txt.
  * Images stay uint8 on the host; the step normalizes them on the device.
  * Batches are numpy dicts in the JAX schema (tgt [B, H, W, 3] uint8,
    ref_imgs [B, 2, H, W, 3], intrinsics [B, 3, 3], oxts [B, 2, 6][,
    groundtruth [B, H, W]]), made by a thread or process pool `lookahead`
    batches ahead of the consumer.
  * The train/validation split is the JAX one: np.random.default_rng(seed)
    shuffles the indices, the first floor(val_ratio · N) validate.
"""

from __future__ import annotations

import multiprocessing
import os
import re
import warnings
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from unsupervised_pseuso_lidar_tpu_torch.geometry.calibration import Calibration
from unsupervised_pseuso_lidar_tpu_torch.geometry.oxts import (
    load_oxts_packets_and_poses,
    relative_pose_6dof,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import (
    load_depth_png,
    load_image_uint8,
    load_image_uint8_cached,
)

_DATE_RE = re.compile(r"(\d{4}_\d{2}_\d{2})")


def find_calib_dir(image_path: str) -> str:
    """The drive-date directory that holds the calib txt files."""
    m = _DATE_RE.search(image_path)
    if not m:
        raise ValueError(f"No KITTI date component in path: {image_path}")
    end = image_path.index(m.group(1)) + len(m.group(1))
    return image_path[:end]


def oxts_path_for_image(image_path: str) -> str:
    """image_02/data/xxx.png -> oxts/data/xxx.txt for the same frame."""
    frame = os.path.splitext(os.path.basename(image_path))[0]
    drive_dir = os.path.dirname(os.path.dirname(os.path.dirname(image_path)))
    return os.path.join(drive_dir, "oxts", "data", frame + ".txt")


# Process workers: the dataset reaches each worker once, through the pool's
# initializer; a task carries only (index, with_groundtruth).
_WORKER_DATASET = None


def _worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_load(index: int, with_groundtruth: bool):
    return _WORKER_DATASET.load_sample(index, with_groundtruth)


@dataclass
class Sample:
    tgt: str
    ref_imgs: Tuple[str, str]
    oxts: Tuple[str, str, str]  # (tgt, ref0, ref1)
    intrinsics: np.ndarray  # [3,3] P_rect_02[:, :3]
    imu_to_cam: np.ndarray  # [4,4]
    groundtruth: Optional[str]


class UnSupKittiDataset:
    """Split-file driven dataset of training triplets. A split line is
    "<tgt.png> <ref0.png> <ref1.png> [<gt_depth.png>]"; without the fourth
    column and with `datasets.velo_gt`, the ground truth is the frame's
    velodyne scan, rasterized when a sample loads."""

    def __init__(self, config):
        self.split = config.datasets.split
        self.img_width = config.datasets.augmentation.image_width
        self.img_height = config.datasets.augmentation.image_height
        self.seq_len = config.datasets.sequence_length
        # decoded-uint8 disk cache ('' = decode every epoch)
        self.cache_dir = config.datasets.cache_dir or ""
        self.velo_gt = bool(config.datasets.velo_gt)
        self.samples: List[Sample] = []
        self._calib_cache: Dict[str, Calibration] = {}
        self._init_samples()

    def _calibration(self, calib_dir: str) -> Calibration:
        if calib_dir not in self._calib_cache:
            self._calib_cache[calib_dir] = Calibration(calib_dir)
        return self._calib_cache[calib_dir]

    def _sample(self, tgt: str, refs: Tuple[str, str], gt: Optional[str]) -> Sample:
        calib = self._calibration(find_calib_dir(tgt))
        return Sample(
            tgt=tgt,
            ref_imgs=refs,
            oxts=(oxts_path_for_image(tgt), oxts_path_for_image(refs[0]),
                  oxts_path_for_image(refs[1])),
            intrinsics=calib.intrinsics.astype(np.float32),
            imu_to_cam=calib.imu_to_cam,
            groundtruth=gt,
        )

    def _init_samples(self) -> None:
        if not os.path.isfile(self.split):
            raise FileNotFoundError(
                f"Split file not found: {self.split!r}. Shipped splits live "
                "in ./splits/ (kitti_mac.txt smoke split, "
                "kitti_depth_annotated_test_files.txt eval split); generate "
                "one from a KITTI tree with "
                "`python -m unsupervised_pseuso_lidar_tpu_torch.cli.splits`."
            )
        from unsupervised_pseuso_lidar_tpu_torch.data.velo_gt import velo_path_for_image

        with open(self.split, "r") as f:
            lines = [line.strip() for line in f if line.strip()]
        for line in lines:
            parts = line.split()
            if len(parts) < 3:
                raise ValueError(f"Malformed split line: {line!r}")
            tgt, ref0, ref1 = parts[0], parts[1], parts[2]
            gt = parts[3] if len(parts) > 3 else None
            if gt is None and self.velo_gt:
                velo = velo_path_for_image(tgt)
                if os.path.isfile(velo):
                    gt = velo  # a .bin ground truth is rasterized at load time
            try:
                self.samples.append(self._sample(tgt, (ref0, ref1), gt))
            except (FileNotFoundError, NotADirectoryError) as e:
                raise FileNotFoundError(
                    f"KITTI drive data missing for split {self.split!r}: "
                    f"no calibration under {find_calib_dir(tgt)!r} (first "
                    f"missing file: {e}). Download the KITTI raw drives the "
                    "split names or pass --synthetic to train without KITTI."
                ) from e

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.load_sample(index, with_groundtruth=True)

    def load_sample(
        self, index: int, with_groundtruth: bool = True
    ) -> Dict[str, np.ndarray]:
        """One sample dict; with_groundtruth=False skips the ground truth
        (training batches drop it unless a supervised term uses it)."""
        sample = self.samples[index]
        size = (self.img_height, self.img_width)
        if self.cache_dir:
            def loader(p, s):
                return load_image_uint8_cached(p, s, self.cache_dir)
        else:
            loader = load_image_uint8
        tgt, orig_h, orig_w = loader(sample.tgt, size)
        refs = np.stack([loader(p, size)[0] for p in sample.ref_imgs], axis=0)

        intrinsics = sample.intrinsics.copy()
        intrinsics[0] *= self.img_width / orig_w
        intrinsics[1] *= self.img_height / orig_h

        world = load_oxts_packets_and_poses(sample.oxts)
        oxts = np.stack([
            relative_pose_6dof(world[0], world[1], sample.imu_to_cam),
            relative_pose_6dof(world[0], world[2], sample.imu_to_cam),
        ], axis=0)

        out = {
            "tgt": tgt,
            "ref_imgs": refs,
            "intrinsics": intrinsics.astype(np.float32),
            "oxts": oxts.astype(np.float32),
        }
        if sample.groundtruth is not None and with_groundtruth:
            if sample.groundtruth.endswith(".bin"):
                from unsupervised_pseuso_lidar_tpu_torch.data.velo_gt import (
                    depth_gt_from_velo,
                )

                out["groundtruth"] = depth_gt_from_velo(
                    sample.groundtruth,
                    self._calibration(find_calib_dir(sample.tgt)),
                    self.img_width, self.img_height,
                    orig_size=(orig_h, orig_w),
                )
            else:
                out["groundtruth"] = load_depth_png(sample.groundtruth, size)
        return out

    def train_val_indices(
        self, seed: int, val_ratio: float, shuffle: bool = True
    ) -> Tuple[List[int], List[int]]:
        """(train indices, validation indices): the seeded shuffle, then
        the first floor(val_ratio · N) validate."""
        indices = list(range(len(self)))
        split = int(np.floor(val_ratio * len(self)))
        if shuffle:
            np.random.default_rng(seed).shuffle(indices)
        return indices[split:], indices[:split]

    def batches(
        self,
        indices: Sequence[int],
        batch_size: int,
        num_workers: int = 8,
        drop_last: bool = True,
        use_processes: bool = False,
        lookahead: int = 2,
        with_groundtruth: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Collated batches of `indices`, loaded by `num_workers` workers
        (one: in the caller's thread) `lookahead` batches ahead.

        use_processes: a process pool (spawned workers, each given the
        dataset once) instead of threads, so the host's cores all decode.
        When ground truth is wanted and a sample's is a velodyne scan, the
        pool falls back to threads with a warning, as in JAX: the
        rasterizer runs torch operations, which must not run in a worker
        process whose parent has started torch's thread pools and CUDA.
        """
        end = len(indices) - (len(indices) % batch_size if drop_last else 0)
        starts = list(range(0, end, batch_size))
        if use_processes and with_groundtruth and any(
            self.samples[i].groundtruth is not None
            and self.samples[i].groundtruth.endswith(".bin")
            for i in indices
        ):
            warnings.warn(
                "velodyne ground truth is rasterized with torch, which does "
                "not run in process workers; using thread workers for this "
                "iterator instead",
                stacklevel=2,
            )
            use_processes = False
        if num_workers > 1 and starts:
            if use_processes:
                with ProcessPoolExecutor(
                    max_workers=num_workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_worker_init,
                    initargs=(self,),
                ) as pool:
                    yield from self._pipelined(pool, starts, indices, batch_size,
                                               lookahead, with_groundtruth,
                                               load=_worker_load)
            else:
                with ThreadPoolExecutor(max_workers=num_workers) as pool:
                    yield from self._pipelined(pool, starts, indices, batch_size,
                                               lookahead, with_groundtruth,
                                               load=self.load_sample)
        else:
            for start in starts:
                yield collate([self.load_sample(i, with_groundtruth)
                               for i in indices[start : start + batch_size]])

    @staticmethod
    def _pipelined(pool, starts, indices, batch_size, lookahead,
                   with_groundtruth, load):
        """Keep `lookahead` + 1 batches of load(index, with_groundtruth)
        futures in flight, yielding them collated in order."""
        inflight = deque()
        it = iter(starts)

        def submit_next():
            start = next(it, None)
            if start is not None:
                inflight.append([pool.submit(load, i, with_groundtruth)
                                 for i in indices[start : start + batch_size]])

        for _ in range(max(1, lookahead) + 1):
            submit_next()
        while inflight:
            items = [f.result() for f in inflight.popleft()]
            submit_next()
            yield collate(items)


class UnSupStackedDataset(UnSupKittiDataset):
    """Sliding windows over the raw drives under datasets.path (no split
    file, no ground truth): every run of sequence_length consecutive
    frames of one drive, the middle one the target."""

    def __init__(self, config):
        self.root = config.datasets.path
        super().__init__(config)

    def _init_samples(self) -> None:
        import glob

        frames: List[str] = []
        for date_dir in sorted(glob.glob(os.path.join(self.root, "*"))):
            if not os.path.isdir(date_dir):
                continue
            for drive in sorted(glob.glob(os.path.join(date_dir, "*_sync"))):
                frames.extend(sorted(
                    glob.glob(os.path.join(drive, "image_02", "data", "*.png"))
                ))
        mid = self.seq_len // 2
        for i in range(len(frames) - self.seq_len + 1):
            window = frames[i : i + self.seq_len]
            if len({os.path.dirname(p) for p in window}) != 1:
                continue  # windows never span drives
            refs = tuple(p for j, p in enumerate(window) if j != mid)
            self.samples.append(self._sample(window[mid], refs, None))


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of samples into one batch dict."""
    return {k: np.stack([item[k] for item in items], axis=0) for k in items[0]}
