"""Fixed-shape point-cloud containers (port of vloam_tpu/lidar/types.py).

Every ragged cloud is a (points, ring, rel_time, mask) bundle of tensors
with a static capacity, so the frame loop has no data-dependent shapes and
never has to ask the device how many points survived.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FeatureCloud(NamedTuple):
    """A padded feature point set.

    xyz      [cap, 3]  float32 (sensor frame)
    ring     [cap]     int32   scan line id
    rel_time [cap]     float32 azimuth-relative time in [0, 1)
    mask     [cap]     bool
    """

    xyz: torch.Tensor
    ring: torch.Tensor
    rel_time: torch.Tensor
    mask: torch.Tensor


class ScanFeatures(NamedTuple):
    """Output of scan registration: the five clouds of A-LOAM plus the LO
    candidate sets in the per-ring slab layout the association kernel
    consumes (ring_assoc.RingSlab; sentinel-padded [n_scans, cap, 3])."""

    sharp: FeatureCloud
    less_sharp: FeatureCloud
    flat: FeatureCloud
    less_flat: FeatureCloud
    full: FeatureCloud  # ring-ordered filtered cloud (laserCloud)
    less_sharp_slab: object = None  # RingSlab
    less_flat_slab: object = None  # RingSlab
