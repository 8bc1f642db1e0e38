"""LOAM scan registration as fixed-shape tensor code (port of
vloam_tpu/lidar/scan_registration.py; reference
scan_registration.cpp:131-449).

- a polar range image is the dense per-ring layout (polar_layout),
- the 11-point curvature is a windowed prefix-sum difference per ring,
  summed in the JAX reference's order (voxel.blocked_cumsum) so the
  discrete selection sees bit-identical curvatures on the same points,
- the reference-exact strict sector selection (6 sectors x (20 corner + 4
  flat) serialized picks with +-5 gap-connected suppression) is
  select_rings on every device (the engines' strict_sector_order; any
  other order is refused),
- the per-ring 0.2 m VoxelGrid on the less-flat cloud is
  voxel.voxel_downsample_rows_slab.

Every sort whose keys can repeat is stable, as JAX's sorts are.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch

from ..lidar.ring_assoc import SENTINEL, RingSlab
from .types import FeatureCloud, ScanFeatures
from .voxel import (blocked_cumsum, reciprocal_f32,
                    voxel_downsample_rows_slab)

_2PI = 2.0 * math.pi
_IBIG = 2**30


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    """x^2 + y^2 + z^2 over the last axis, rounded as the JAX reference's
    compiled CPU code rounds it: XLA contracts the sum into fused
    multiply-adds, fma(z, z, fma(y, y, x*x)). A fused multiply-add is
    emulated exactly in float64 (the f32 product is exact there), so the
    result is bit-identical on every device. The squared norms it feeds
    decide discrete outcomes (feature labels, gap breaks, the range gate)."""
    w = v.to(torch.float64)
    s = (v[..., 0] * v[..., 0]).to(torch.float64)
    s = (s + w[..., 1] * w[..., 1]).to(torch.float32).to(torch.float64)
    return (s + w[..., 2] * w[..., 2]).to(torch.float32)


def _curvature(ring_pts: torch.Tensor) -> torch.Tensor:
    """11-point curvature per ring: ||sum_{|l|<=5} p_{i+l} - 11 p_i||^2
    (reference :288-307), window sums clamped at the ring ends."""
    S, r = ring_pts.shape[0], ring_pts.shape[1]
    cs = torch.cat([torch.zeros_like(ring_pts[:, :1]),
                    blocked_cumsum(ring_pts, 1)], dim=1)  # [S, R+1, 3]
    pad = torch.cat([cs[:, :1].expand(S, 5, 3), cs,
                     cs[:, -1:].expand(S, 6, 3)], dim=1)
    win = pad[:, 11:11 + r] - pad[:, :r]  # sum over [i-5, i+5] (clamped)
    # win - 11 p as one fused multiply-add, as the reference computes it
    diff = (win.to(torch.float64)
            - 11.0 * ring_pts.to(torch.float64)).to(torch.float32)
    return _sq_norm(diff)


def _break_prefix(pts: torch.Tensor, gap_sq: float) -> torch.Tensor:
    """bf[s, i] = number of 3D gap breaks (consecutive-point distance^2 >
    gap_sq) among gaps (0,1)...(i-1,i) of ring s, for i < R. Two indices are
    gap-connected iff their bf values are equal, so the reference's +-5
    suppression window around a pick is one compare against the pick's bf
    value (scan_registration.cpp:353-376)."""
    brk = (_sq_norm(pts[:, 1:] - pts[:, :-1]) > gap_sq).to(torch.int32)
    return torch.cat([torch.zeros_like(brk[:, :1]),
                      torch.cumsum(brk, 1, dtype=torch.int32)], dim=1)


def select_rings(curv: torch.Tensor, bf: torch.Tensor,
                 counts: torch.Tensor, cfg) -> torch.Tensor:
    """Plain PyTorch strict sector selection for all rings (the strict branch
    of the reference's _select_ring, in its all-rings form). curv [S, R] f32,
    bf [S, R] int32, counts [S] int -> label [S, R] int32: 2 sharp, 1
    less-sharp, -1 flat, 0 none. Argmaxes are explicit first-index (iota-min)
    reductions."""
    S, R = curv.shape
    col = torch.arange(R, device=curv.device)[None, :]
    cnt = counts.to(torch.int64)[:, None]
    start = 5
    end = cnt - 6
    width = end - start
    ring_ok = width >= 6
    exists = col < cnt
    thr = cfg.curvature_threshold
    n_corner = cfg.max_less_sharp_per_sector
    n_flat = cfg.max_flat_per_sector
    per_sector = n_corner + n_flat
    ns = cfg.n_sectors
    picked = torch.zeros((S, R), dtype=torch.bool, device=curv.device)
    label = torch.zeros((S, R), dtype=torch.int32, device=curv.device)
    for s in range(ns * per_sector):
        j, k = divmod(s, per_sector)
        corner = k < n_corner
        sp = start + _floor_div(width * j, ns)
        ep = start + _floor_div(width * (j + 1), ns) - 1
        in_sector = (col >= sp) & (col <= ep) & ring_ok & exists
        # corner: maximize curv gated at curv > thr; flat: maximize -curv
        # gated at curv < thr
        score = curv if corner else -curv
        tj = thr if corner else -thr
        c = torch.where(in_sector & ~picked & (score > tj), score, -math.inf)
        m = torch.amax(c, dim=1)
        ind = torch.amin(torch.where(c >= m[:, None], col, _IBIG), dim=1)
        ok = m > tj
        lab = (2 if k < cfg.max_sharp_per_sector else 1) if corner else -1
        at_pick = col == ind[:, None]
        label = torch.where(at_pick & ok[:, None], lab, label)
        # the reference breaks before suppressing the last flat pick
        if corner or k - n_corner < n_flat - 1:
            bf_pick = torch.amax(torch.where(at_pick, bf, -1), dim=1)
            supp = ((torch.abs(col - ind[:, None]) <= 5)
                    & (bf == bf_pick[:, None]) & ok[:, None])
            picked = picked | supp
    return label


def _selectable(counts: torch.Tensor, R: int) -> torch.Tensor:
    """[S, R] mask of the in-ring range the selection may pick from."""
    idx = torch.arange(R, device=counts.device)[None, :]
    cnt = counts.to(torch.int64)[:, None]
    start, end = 5, cnt - 6
    ring_ok = (end - start) >= 6
    return (idx >= start) & (idx <= end - 1) & ring_ok & (idx < cnt)


def ring_labels(pts, counts, cfg) -> torch.Tensor:
    """Curvature and sector selection of a dense per-ring layout pts
    [S, R, 3] / counts [S]: the labels [S, R]. Every step is a ring's own
    (elementwise, ring-wise scans, and maxima and minima, which are exact),
    so the rings of many frames may come in one call and give each frame's
    labels bit for bit."""
    curv = _curvature(pts)
    bf = _break_prefix(pts, cfg.neighbor_suppress_gap_sq)
    if not cfg.strict_sector_order:
        raise ValueError("the reference follows the strict sector order")
    return select_rings(curv, bf, counts, cfg)


def _features_from_layout(pts, rt, counts, cfg, label=None) -> ScanFeatures:
    """Shared back half: curvature, the strict sector selection and
    feature-cloud assembly from a dense per-ring layout
    pts [S, R, 3] / rt [S, R] / counts [S] (reference
    scan_registration.cpp:288-449). label: ring_labels' result, where the
    caller has it already."""
    S, R = pts.shape[0], pts.shape[1]
    dev = pts.device
    if label is None:
        label = ring_labels(pts, counts, cfg)
    selectable = _selectable(counts, R)

    ring_ids = torch.arange(S, dtype=torch.int32, device=dev)[:, None]
    exists = torch.arange(R, device=dev)[None, :] < counts[:, None]

    # Per-ring label partition: one stable row-wise sort by group key
    # (0=sharp, 1=less-sharp, 2=flat, 3=rest); each cloud is then a fixed
    # per-ring block — sharp is a prefix of less-sharp, flat the following
    # group — flattened with masks; capacity splits evenly across rings.
    group = torch.where(label == 2, 0,
                        torch.where(label == 1, 1,
                                    torch.where(label == -1, 2, 3)))
    _, order = torch.sort(group, dim=1, stable=True)
    pts_s = torch.take_along_dim(pts, order[..., None], dim=1)
    rt_s = torch.take_along_dim(rt, order, dim=1)
    n_sharp_r = torch.sum(group == 0, dim=1)
    n_less_r = torch.sum(group == 1, dim=1)
    n_flat_r = torch.sum(group == 2, dim=1)

    def slice_rows(start_r, count_r, cap):
        per = cap // S
        ar = torch.arange(per, device=dev)[None, :]
        cols = torch.clamp(start_r[:, None] + ar, 0, R - 1)
        m = ar < torch.clamp(count_r, max=per)[:, None]
        xyz_b = torch.take_along_dim(pts_s, cols[..., None], dim=1)
        rt_b = torch.take_along_dim(rt_s, cols, dim=1)
        return FeatureCloud(
            xyz=torch.where(m[..., None], xyz_b, 0.0).reshape(cap, 3),
            ring=torch.where(m, ring_ids, 0).reshape(cap),
            rel_time=torch.where(m, rt_b, 0.0).reshape(cap),
            mask=m.reshape(cap),
        )

    zero_r = torch.zeros_like(n_sharp_r)
    sharp = slice_rows(zero_r, n_sharp_r, cfg.sharp_cap)
    less_sharp = slice_rows(zero_r, n_sharp_r + n_less_r, cfg.less_sharp_cap)
    flat = slice_rows(n_sharp_r + n_less_r, n_flat_r, cfg.flat_cap)

    # LO candidate slabs in the native per-ring layout, sentinel-padded so
    # the association kernel needs no masks.
    ls_per = cfg.less_sharp_cap // S
    ls_xyz = less_sharp.xyz.reshape(S, ls_per, 3)
    ls_m = less_sharp.mask.reshape(S, ls_per)
    less_sharp_slab = RingSlab(torch.where(ls_m[..., None], ls_xyz, SENTINEL))

    lf_mask = selectable & (label <= 0)
    lf_cap_r = cfg.less_flat_cap // S
    lf_xyz, lf_extra, lf_m = voxel_downsample_rows_slab(
        pts, lf_mask, cfg.less_flat_leaf, lf_cap_r, extra=rt[..., None])
    less_flat_slab = RingSlab(torch.where(lf_m[..., None], lf_xyz, SENTINEL))
    less_flat = FeatureCloud(
        xyz=torch.where(lf_m[..., None], lf_xyz, 0.0).reshape(-1, 3),
        ring=torch.where(lf_m, ring_ids, 0).reshape(-1),
        rel_time=torch.where(lf_m, lf_extra[..., 0], 0.0).reshape(-1),
        mask=lf_m.reshape(-1),
    )

    full = FeatureCloud(xyz=pts.reshape(-1, 3),
                        ring=ring_ids.expand(S, R).reshape(-1),
                        rel_time=rt.reshape(-1), mask=exists.reshape(-1))

    return ScanFeatures(sharp=sharp, less_sharp=less_sharp,
                        flat=flat, less_flat=less_flat, full=full,
                        less_sharp_slab=less_sharp_slab,
                        less_flat_slab=less_flat_slab)


@functools.cache
def _libm():
    """The C library's math functions, float32 cosf / sinf typed."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "sinf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


def _cos_sin_f32(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float32 cos and sin of float32 x by the C library's cosf / sinf, the
    functions XLA's CPU code calls for the reference's jnp.cos / jnp.sin:
    torch's and numpy's float32 cos / sin differ from them by an ulp on a
    few per cent of the arguments."""
    lib, vals = _libm(), x.tolist()
    return (np.array([lib.cosf(v) for v in vals], np.float32),
            np.array([lib.sinf(v) for v in vals], np.float32))


def azimuth_angles(n_azimuth: int) -> np.ndarray:
    """Column azimuths -linspace(0, 2 pi, A, endpoint=False) as float32 on
    the host: -(i * f32(f32(2 pi) * f32(1 / A))), XLA's fold of the
    reference's linspace under jit (its division by A is a product by the
    float32 reciprocal)."""
    step = np.float32(_2PI) * np.float32(reciprocal_f32(n_azimuth))
    return -(np.arange(n_azimuth, dtype=np.float32) * step)


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def ray_directions(elev_rad, az, device=None) -> torch.Tensor:
    """Unit ray directions [S, A, 3] of rings at elevations elev_rad [S]
    and columns at azimuths az [A] (tensors or arrays). The one source of
    the port's direction tables: built on the host with _cos_sin_f32 and
    float32 products, so it equals the reference's table bit for bit, then
    uploaded once to `device` (default: elev_rad's device, else the CPU)."""
    if device is None:
        device = (elev_rad.device if isinstance(elev_rad, torch.Tensor)
                  else "cpu")
    ce, se = _cos_sin_f32(_host_f32(elev_rad))
    ca, sa = _cos_sin_f32(_host_f32(az))
    S, A = ce.shape[0], ca.shape[0]
    table = np.stack([
        ce[:, None] * ca[None, :],
        ce[:, None] * sa[None, :],
        np.broadcast_to(se[:, None], (S, A)),
    ], axis=-1)
    return torch.from_numpy(table).to(device)


def polar_directions(elev_rad, n_azimuth: int, device=None) -> torch.Tensor:
    """Unit ray directions [S, A, 3] of a range image's rings x columns."""
    return ray_directions(elev_rad, azimuth_angles(n_azimuth), device)


def polar_layout(ranges_u16: torch.Tensor, dirs: torch.Tensor, profile,
                 scale: float = 0.005):
    """The dense per-ring layout of a quantized range image [S, A] (0 = no
    return): (pts [S, A, 3], rel_time [S, A], counts [S] int32). The image
    IS the layout (row = ring, column order = firing order, rel_time =
    column * f32(1 / A), the reference's column / A as XLA rounds it), so
    the xyz path's ring assignment, azimuth unwrap and global sort
    collapse into one stable per-row compaction of valid returns."""
    S, A = ranges_u16.shape
    dev = ranges_u16.device
    r = ranges_u16.to(torch.float32) * scale
    valid = r >= profile.minimum_range  # also rejects r == 0 (no return)
    xyz = dirs * r[..., None]  # [S, A, 3]
    rel = (torch.arange(A, dtype=torch.float32, device=dev)
           * reciprocal_f32(A))[None, :]

    col = torch.arange(A, device=dev)[None, :]
    key = torch.where(valid, col, A)
    _, order = torch.sort(key, dim=1, stable=True)
    ok = torch.take_along_dim(valid, order, dim=1)
    xyz_s = torch.take_along_dim(xyz, order[..., None], dim=1)
    rel_s = torch.take_along_dim(rel.expand(S, A), order, dim=1)
    pts = torch.where(ok[..., None], xyz_s, 0.0)
    rt = torch.where(ok, rel_s, 0.0)
    counts = torch.sum(valid, dim=1).to(torch.int32)
    return pts, rt, counts


