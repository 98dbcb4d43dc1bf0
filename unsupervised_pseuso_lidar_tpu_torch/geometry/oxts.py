"""KITTI OXTS GPS/IMU parsing -> SE(3) world poses (host-side, numpy).

Counterpart of unsupervised_pseuso_lidar_tpu/geometry/oxts.py (OxtsPacket
:17, pose_from_oxts_packet :82, load_oxts_packets_and_poses :109,
axis_angle_from_matrix :141, relative_pose_6dof :158, load_velo_scan
:196), copied because the port imports nothing of the JAX package. All of
it is float64 numpy on the host, as there: Mercator projection of lat/lon
to a metric translation plus Euler-angle rotation gives T_w_imu per
packet; the velodyne .bin loader reads a scan.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

EARTH_RADIUS_M = 6378137.0


class OxtsPacket(NamedTuple):
    """The 30 fields of a KITTI OXTS packet, in dataformat.txt order:
    position and attitude, velocities, accelerations, angular rates,
    accuracies and navigation status. Poses use the first six."""

    lat: float
    lon: float
    alt: float
    roll: float
    pitch: float
    yaw: float
    vn: float = 0.0
    ve: float = 0.0
    vf: float = 0.0
    vl: float = 0.0
    vu: float = 0.0
    ax: float = 0.0
    ay: float = 0.0
    az: float = 0.0
    af: float = 0.0
    al: float = 0.0
    au: float = 0.0
    wx: float = 0.0
    wy: float = 0.0
    wz: float = 0.0
    wf: float = 0.0
    wl: float = 0.0
    wu: float = 0.0
    pos_accuracy: float = 0.0
    vel_accuracy: float = 0.0
    navstat: float = 0.0
    numsats: float = 0.0
    posmode: float = 0.0
    velmode: float = 0.0
    orimode: float = 0.0


class OxtsData(NamedTuple):
    """A packet and its assembled world pose."""

    packet: OxtsPacket
    T_w_imu: np.ndarray


def rotx(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def pose_from_oxts_packet(packet: OxtsPacket, scale: float) -> np.ndarray:
    """One OXTS packet -> 4x4 T_w_imu via the Mercator projection."""
    tx = scale * packet.lon * np.pi * EARTH_RADIUS_M / 180.0
    ty = scale * EARTH_RADIUS_M * np.log(
        np.tan((90.0 + packet.lat) * np.pi / 360.0)
    )
    tz = packet.alt
    rot = rotz(packet.yaw) @ roty(packet.pitch) @ rotx(packet.roll)
    pose = np.eye(4, dtype=np.float64)
    pose[:3, :3] = rot
    pose[:3, 3] = (tx, ty, tz)
    return pose


def parse_oxts_line(line: str) -> OxtsPacket:
    """One line of a KITTI oxts/data/*.txt file (up to 30 fields; a short
    line is zero-padded past the 6 pose fields)."""
    values = [float(v) for v in line.split()[:30]]
    if len(values) < 6:
        raise ValueError(f"OXTS line has {len(values)} fields, need >= 6")
    return OxtsPacket(*values)


def load_oxts_packets_and_poses(oxts_files: Sequence[str]) -> List[np.ndarray]:
    """OXTS files -> their 4x4 T_w_imu world poses. The Mercator scale
    comes from the first packet's latitude; translations are not moved to
    the first pose (relative poses cancel the offset)."""
    return [d.T_w_imu for d in load_oxts_data(oxts_files)]


def load_oxts_data(oxts_files: Sequence[str]) -> List[OxtsData]:
    """OXTS files -> [(packet, T_w_imu)], one per non-empty line."""
    scale = None
    out: List[OxtsData] = []
    for filename in oxts_files:
        with open(filename, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                packet = parse_oxts_line(line)
                if scale is None:
                    scale = np.cos(packet.lat * np.pi / 180.0)
                out.append(OxtsData(packet, pose_from_oxts_packet(packet, scale)))
    return out


def axis_angle_from_matrix(rot: np.ndarray) -> np.ndarray:
    """SO(3) log map: [3, 3] rotation -> axis-angle vector. Below 1e-7 rad
    it takes the first-order skew part; the arccos is clamped. Inter-frame
    rotations are far from pi, so that branch is not handled."""
    trace = float(np.trace(rot))
    cos = np.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(cos))
    skew = np.array(
        [rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]]
    )
    if theta < 1e-7:
        return 0.5 * skew  # log(R) ~ (R - R^T)/2 for small angles
    return skew * (theta / (2.0 * np.sin(theta)))


def relative_pose_6dof(
    origin_world: np.ndarray, target_world: np.ndarray, imu_to_cam: np.ndarray
) -> np.ndarray:
    """Camera-frame relative odometry as the warp's 6-vector [rx, ry, rz,
    tx, ty, tz] (axis-angle, float32): the transform that maps ORIGIN
    (target-frame) camera coordinates into the TARGET (reference-frame)
    camera, C @ inv(T_w_ref) @ T_w_tgt @ inv(C) — what the pose nets
    predict, so `semi_sup_pose` can use it in their place."""
    cam_from_imu = imu_to_cam
    odo = (
        cam_from_imu
        @ np.linalg.inv(target_world)
        @ origin_world
        @ np.linalg.inv(cam_from_imu)
    )
    return np.concatenate(
        [axis_angle_from_matrix(odo[:3, :3]), odo[:3, 3]]
    ).astype(np.float32)


def load_velo_scan(filename: str) -> np.ndarray:
    """A KITTI velodyne .bin scan -> [N, 4] float32 (x, y, z, reflectance)."""
    return np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
