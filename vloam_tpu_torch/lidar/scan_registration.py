"""LOAM scan registration as fixed-shape tensor code (port of
vloam_tpu/lidar/scan_registration.py; reference
scan_registration.cpp:131-449).

- range/NaN filtering, ring assignment and azimuth relative time are
  elementwise ops over a padded [N] point buffer,
- the per-ring cloud becomes a dense [n_scans, ring_capacity] layout built
  with one sort (keys are unique, so the order is that of the reference),
- the 11-point curvature is a windowed prefix-sum difference per ring,
  summed in the JAX reference's order (voxel.blocked_cumsum) so the
  discrete selection sees bit-identical curvatures on the same points,
- the reference-exact strict sector selection (6 sectors x (20 corner + 4
  flat) serialized picks with +-5 gap-connected suppression) runs on CUDA
  as the hand-written kernel K1 (kernels/csrc/select_rings.cu) and on the
  CPU as select_rings_plain; with strict_sector_order=False the batched
  selection (all sectors' k-th picks in one round) runs as plain torch,
  select_rings_batched,
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

from .. import kernels
from ..lidar.ring_assoc import SENTINEL, RingSlab
from .types import FeatureCloud, ScanFeatures
from .voxel import (blocked_cumsum, reciprocal_f32,
                    voxel_downsample_rows_slab)

_2PI = 2.0 * math.pi
_IBIG = 2**30


def _trunc_int(x: torch.Tensor) -> torch.Tensor:
    """C-style int() cast: truncation toward zero."""
    return torch.trunc(x).to(torch.int32)


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def assign_rings(xyz: torch.Tensor, valid: torch.Tensor, profile):
    """Elevation-angle ring id (reference scan_registration.cpp:192-226)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    angle = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
    n = profile.n_scans
    if n == 16:
        sid = _trunc_int((angle + 15.0) / 2.0 + 0.5)
        ok = (sid >= 0) & (sid < n)
    elif n == 32:
        sid = _trunc_int((angle + 92.0 / 3.0) * 3.0 / 4.0)
        ok = (sid >= 0) & (sid < n)
    elif n == 64:
        upper = _trunc_int((2.0 - angle) * 3.0 + 0.5)
        lower = n // 2 + _trunc_int((-8.83 - angle) * 2.0 + 0.5)
        sid = torch.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (sid >= 0) & (sid <= 50)
    else:
        raise ValueError(f"unsupported scan_line {n}")
    return sid, valid & ok


def _relative_time(xyz, valid_range, valid_full):
    """Azimuth-interpolated relative time (reference :166-264). The
    reference's sequential halfPassed flag is an exclusive cumulative-or."""
    n = xyz.shape[0]
    ori = -torch.atan2(xyz[:, 1], xyz[:, 0])
    vr = valid_range.to(torch.int32)
    first = torch.argmax(vr)
    last = n - 1 - torch.argmax(torch.flip(vr, (0,)))
    # gathers, not ori[first]: a 0-d index tensor would be read to the host
    start_ori = torch.gather(ori, 0, first[None])[0]
    end_ori = torch.gather(ori, 0, last[None])[0] + _2PI
    span = end_ori - start_ori
    end_ori = torch.where(span > 3 * math.pi, end_ori - _2PI,
                          torch.where(span < math.pi, end_ori + _2PI,
                                      end_ori))

    before = ori
    before = torch.where(before < start_ori - math.pi / 2, before + _2PI,
                         before)
    before = torch.where(before > start_ori + 3 * math.pi / 2, before - _2PI,
                         before)
    trigger = valid_full & (before - start_ori > math.pi)
    half_passed = torch.cat([
        torch.zeros((1,), dtype=torch.bool, device=xyz.device),
        torch.cumsum(trigger.to(torch.int32), 0)[:-1] > 0])

    after = ori + _2PI
    after = torch.where(after < end_ori - 3 * math.pi / 2, after + _2PI,
                        after)
    after = torch.where(after > end_ori + math.pi / 2, after - _2PI, after)

    o = torch.where(half_passed, after, before)
    return (o - start_ori) / (end_ori - start_ori)


def _ring_layout(xyz, ring, rel_time, valid, n_scans: int, ring_cap: int):
    """Scatter points into a dense [n_scans, ring_cap] layout preserving
    firing order within each ring (reference :266, :276-281)."""
    n = xyz.shape[0]
    dev = xyz.device
    ar = torch.arange(n, device=dev)
    ring_k = torch.where(valid, ring.to(torch.int64), n_scans)
    order = torch.argsort(ring_k * n + ar)  # unique keys: ring-major order
    ring_s = ring_k[order]
    # per-ring counts without bincount (which reads its max back on CUDA)
    counts_raw = torch.zeros(n_scans + 1, dtype=torch.int64, device=dev)
    counts_raw.scatter_add_(0, ring_s, torch.ones_like(ring_s))
    counts_raw = counts_raw[:n_scans]
    counts = torch.clamp(counts_raw, max=ring_cap)
    starts = torch.cat([counts_raw.new_zeros(1),
                        torch.cumsum(counts_raw, 0)[:-1]])
    rank = ar - starts[torch.clamp(ring_s, max=n_scans - 1)]
    dest_r = torch.where((ring_s < n_scans) & (rank >= 0) & (rank < ring_cap),
                         ring_s, n_scans)
    rank = torch.clamp(rank, 0, ring_cap - 1)

    # destinations are unique apart from the dump row n_scans, sliced off
    pts = xyz.new_zeros((n_scans + 1, ring_cap, 3))
    pts[dest_r, rank] = xyz[order]
    rt = xyz.new_zeros((n_scans + 1, ring_cap))
    rt[dest_r, rank] = rel_time[order]
    return pts[:n_scans], rt[:n_scans], counts.to(torch.int32)


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


def select_rings_plain(curv: torch.Tensor, bf: torch.Tensor,
                       counts: torch.Tensor, cfg) -> torch.Tensor:
    """Plain PyTorch strict sector selection for all rings (the strict
    branch of the reference's _select_ring, written in its Pallas kernel's
    all-rings form). curv [S, R] f32, bf [S, R] int32, counts [S] int ->
    label [S, R] int32: 2 sharp, 1 less-sharp, -1 flat, 0 none. Argmaxes
    are explicit first-index (iota-min) reductions."""
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


def select_rings(curv: torch.Tensor, bf: torch.Tensor, counts: torch.Tensor,
                 cfg) -> torch.Tensor:
    """Strict sector selection (K1). CPU tensors take select_rings_plain;
    CUDA tensors launch kernels/csrc/select_rings.cu (or raise)."""
    if curv.device.type == "cpu":
        return select_rings_plain(curv, bf, counts, cfg)
    return kernels.select_rings(
        curv.contiguous(), bf.to(torch.int32).contiguous(),
        counts.to(torch.int32).contiguous(), cfg.curvature_threshold,
        cfg.n_sectors, cfg.max_sharp_per_sector,
        cfg.max_less_sharp_per_sector, cfg.max_flat_per_sector)


def select_rings_batched(curv: torch.Tensor, bf: torch.Tensor,
                         counts: torch.Tensor, cfg) -> torch.Tensor:
    """Batched sector selection (strict_sector_order=False, the batched
    branch of the reference's _select_ring) for all rings: each pick round
    takes the k-th pick of every sector of every ring at once, one argmax
    over [S, n_sectors, R], then max_less_sharp_per_sector corner rounds
    and max_flat_per_sector flat rounds. It differs from the strict order
    only where a pick's +-5 suppression window crosses into the next sector
    in the same round. Plain torch on every device (there is no TPU kernel
    for it). curv [S, R] f32, bf [S, R] int32, counts [S] -> label [S, R]
    int32: 2 sharp, 1 less-sharp, -1 flat, 0 none."""
    S, R = curv.shape
    dev = curv.device
    col = torch.arange(R, device=dev)
    cnt = counts.to(torch.int64)[:, None, None]
    start, end = 5, cnt - 6
    ring_ok = (end - start) >= 6
    j = torch.arange(cfg.n_sectors, device=dev)[None, :, None]
    sp = start + _floor_div((end - start) * j, cfg.n_sectors)
    ep = start + _floor_div((end - start) * (j + 1), cfg.n_sectors) - 1
    sect = (col >= sp) & (col <= ep) & ring_ok & (col < cnt)  # [S, ns, R]
    thr = cfg.curvature_threshold
    picked = torch.zeros((S, R), dtype=torch.bool, device=dev)
    label = torch.zeros((S, R), dtype=torch.int32, device=dev)
    n_flat = cfg.max_flat_per_sector
    rounds = ([(True, 2 if k < cfg.max_sharp_per_sector else 1, True)
               for k in range(cfg.max_less_sharp_per_sector)]
              # the reference does not suppress around the last flat pick
              + [(False, -1, k < n_flat - 1) for k in range(n_flat)])
    for corner, lab, suppress in rounds:
        # corner: maximize curv gated at curv > thr; flat: maximize -curv
        # gated at curv < thr (the first index of the reference's argmin).
        # argmax gives the first index, as JAX's; a sector with no
        # candidate picks index 0 with ok false, and writes nothing
        score = curv if corner else -curv
        tj = thr if corner else -thr
        elig = sect & (~picked & (score > tj))[:, None, :]
        c = torch.where(elig, score[:, None, :], -torch.inf)  # [S, ns, R]
        ind = torch.argmax(c, dim=2)
        ok = torch.take_along_dim(c, ind[..., None], dim=2)[..., 0] > tj
        at = (col == ind[..., None]) & ok[..., None]
        label = torch.where(torch.any(at, dim=1), lab, label)
        if suppress:
            bf_pick = torch.take_along_dim(bf, ind, dim=1)
            supp = ((torch.abs(col - ind[..., None]) <= 5)
                    & (bf[:, None, :] == bf_pick[..., None]) & ok[..., None])
            picked = picked | torch.any(supp, dim=1)
    return label


def _selectable(counts: torch.Tensor, R: int) -> torch.Tensor:
    """[S, R] mask of the in-ring range the selection may pick from."""
    idx = torch.arange(R, device=counts.device)[None, :]
    cnt = counts.to(torch.int64)[:, None]
    start, end = 5, cnt - 6
    ring_ok = (end - start) >= 6
    return (idx >= start) & (idx <= end - 1) & ring_ok & (idx < cnt)


def _features_from_layout(pts, rt, counts, cfg) -> ScanFeatures:
    """Shared back half: curvature, sector selection (strict: K1; else the
    batched rounds) and feature-cloud assembly from a dense per-ring layout
    pts [S, R, 3] / rt [S, R] / counts [S] (reference
    scan_registration.cpp:288-449)."""
    S, R = pts.shape[0], pts.shape[1]
    dev = pts.device
    curv = _curvature(pts)
    bf = _break_prefix(pts, cfg.neighbor_suppress_gap_sq)
    select = select_rings if cfg.strict_sector_order else select_rings_batched
    label = select(curv, bf, counts, cfg)
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


def register_scan(xyz: torch.Tensor, n_points, profile, cfg) -> ScanFeatures:
    """Extract LOAM features from one padded scan [max_points, 3]."""
    n = xyz.shape[0]
    in_range = torch.arange(n, device=xyz.device) < n_points
    finite = torch.all(torch.isfinite(xyz), dim=-1)
    xyz = torch.where(finite[:, None], xyz, 0.0)
    rng_sq = _sq_norm(xyz)
    valid_range = in_range & finite & (rng_sq >= profile.minimum_range**2)

    ring, valid = assign_rings(xyz, valid_range, profile)
    rel = _relative_time(xyz, valid_range, valid)

    S, R = profile.n_scans, profile.ring_capacity
    pts, rt, counts = _ring_layout(xyz, ring, rel, valid, S, R)
    return _features_from_layout(pts, rt, counts, cfg)


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


def register_scan_polar(ranges_u16: torch.Tensor, dirs: torch.Tensor,
                        profile, cfg, scale: float = 0.005) -> ScanFeatures:
    """Extract LOAM features straight from a quantized range image
    [S, A] (0 = no return) and its ray directions [S, A, 3]
    (polar_directions, computed once per sensor rather than per frame)."""
    pts, rt, counts = polar_layout(ranges_u16, dirs, profile, scale)
    return _features_from_layout(pts, rt, counts, cfg)
