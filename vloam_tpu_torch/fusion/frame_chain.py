"""The static extrinsic chain of the frame bus (the part of
vloam_tpu/fusion/frame_chain.py that unpack_vloam_outputs needs; reference
vloam_tf.cpp:55-56), in float64 numpy."""

from __future__ import annotations

import numpy as np

# the vehicle base frame is the IMU frame (frame_chain.py:47)
BASE_T_IMU = np.eye(4)


def base_T_cam0(imu_T_cam0: np.ndarray) -> np.ndarray:
    """base_T_cam0 = base_T_imu @ imu_T_cam0."""
    return BASE_T_IMU @ np.asarray(imu_T_cam0, np.float64)
