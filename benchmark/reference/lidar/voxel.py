"""Voxel-grid downsampling with static shapes (port of
vloam_tpu/lidar/voxel.py): quantize -> hash -> stable sort by hash ->
prefix-sum segment mean -> compact.

Two things differ from a literal translation, both for exactness:

- The uint32 murmur hash runs in int64 with every intermediate masked to
  32 bits (torch has no uint32 right shift on the CPU), and each 32x32-bit
  product is split into 16-bit halves so no intermediate leaves int64's
  range. Voxel keys are bit-identical to the JAX reference.
- Float prefix sums use ``blocked_cumsum``, which adds in the same order as
  XLA's CPU cumsum (a two-level scan over blocks of 16). Sums therefore
  round exactly like the reference's on the same inputs, and the curvature
  that feeds the discrete feature selection stays bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch

_P1, _P2, _P3, _P4 = 73856093, 19349669, 83492791, 2654435761
_M32 = 0xFFFFFFFF
_SCAN_BLOCK = 16


def reciprocal_f32(x: float) -> float:
    """1 / x rounded to float32, as a Python float. Scaling by it is how the
    reference divides by a constant: XLA rewrites ``a / c`` into
    ``a * (1 / c)`` with the reciprocal rounded to the operand's type, and
    PyTorch on CUDA does the same for a Python-scalar divisor, while PyTorch
    on the CPU divides. ``t * reciprocal_f32(c)`` rounds alike everywhere."""
    return float(np.float32(1.0) / np.float32(x))


def _cell_of(p: torch.Tensor, cell: float) -> torch.Tensor:
    """int32 floor of p / cell, rounded as the reference rounds it: a voxel
    filter's cell, a map cell, the insert's voxel index."""
    return torch.floor(p * reciprocal_f32(cell)).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant c,
    without any intermediate reaching 2^63."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or int64 holding an int32 value) -> its uint32 bit pattern,
    held in int64."""
    return x.to(torch.int32).to(torch.int64) & _M32


def hash_avalanche(h: torch.Tensor, final_shift: bool = True) -> torch.Tensor:
    """Murmur3 finalizer steps shared by the voxel and map hashes."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    if final_shift:
        h = _mul32(h, 0xC2B2AE35)
        h = h ^ (h >> 16)
    return h


def _hash_cells(ix, iy, iz, part):
    """Murmur3-finalized spatial hash of int32 cell coordinates; returns the
    uint32 value in int64 (bit-exact with vloam_tpu.lidar.voxel._hash_cells)."""
    h = (_mul32(as_u32(ix), _P1) + _mul32(as_u32(iy), _P2)
         + _mul32(as_u32(iz), _P3) + _mul32(as_u32(part), _P4)) & _M32
    return hash_avalanche(h)


def _sequential_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    out = [x.select(dim, 0)]
    for k in range(1, x.shape[dim]):
        out.append(out[-1] + x.select(dim, k))
    return torch.stack(out, dim=dim)


def blocked_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along `dim`, added in XLA's CPU order: a
    sequential scan inside blocks of 16, the block totals scanned the same
    way (recursively), then each block offset by the exclusive prefix of the
    totals. Integer inputs may use torch.cumsum instead (exact either way)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        return _sequential_cumsum(x, 0).movedim(0, dim)
    nb = -(-n // _SCAN_BLOCK)
    pad = nb * _SCAN_BLOCK - n
    rest = x.shape[1:]
    xp = torch.cat([x, x.new_zeros((pad,) + rest)]).reshape(
        (nb, _SCAN_BLOCK) + rest)
    w = _sequential_cumsum(xp, 1)
    totals = blocked_cumsum(w[:, -1], 0)
    offset = torch.cat([totals.new_zeros((1,) + rest), totals[:-1]])
    out = (w + offset[:, None]).reshape((nb * _SCAN_BLOCK,) + rest)[:n]
    return out.movedim(0, dim)


def _scatter_rows(vals: torch.Tensor, dest: torch.Tensor, n_out: int):
    """out[..., dest[..., j], :] = vals[..., j, :] along the second-to-last
    axis for dest < n_out; other entries go to a dump slot that is sliced
    off (destinations below n_out are unique). vals [..., N, C],
    dest [..., N] -> [..., n_out, C] (zeros where nothing landed)."""
    lead = vals.shape[:-2]
    buf = vals.new_zeros(lead + (n_out + 1, vals.shape[-1]))
    idx = torch.clamp(dest, max=n_out).to(torch.int64)
    buf.scatter_(-2, idx[..., None].expand_as(vals), vals)
    return buf[..., :n_out, :]


def _segment_sums(hs, ms, chans, out_cap):
    """Shared post-sort reduction along the last axis: per-segment sums of
    `chans` [..., N, C] over runs of equal sorted keys `hs` [..., N] whose
    mask `ms` is set (valid points form a prefix: invalid keys sort last).
    A segment's sum is the difference of the inclusive prefix sum at
    consecutive segment ends. Returns (sums [..., out_cap, C],
    occupied [..., out_cap], end_dest [..., N])."""
    first = torch.ones_like(ms[..., :1])
    is_start = torch.cat([first, hs[..., 1:] != hs[..., :-1]], dim=-1) & ms
    seg = torch.cumsum(is_start.to(torch.int32), dim=-1) - 1
    n_seg = torch.amax(torch.where(ms, seg, -1), dim=-1) + 1
    nxt_start = torch.cat([is_start[..., 1:], first], dim=-1)
    nxt_ms = torch.cat([ms[..., 1:], ~first], dim=-1)
    is_end = ms & (nxt_start | ~nxt_ms)  # last element of each segment

    cs = blocked_cumsum(chans, chans.dim() - 2)
    m = min(out_cap, hs.shape[-1])
    dest = torch.where(is_end, seg, m)
    ends = _scatter_rows(cs, dest, m)
    if out_cap > m:
        ends = torch.cat(
            [ends, ends.new_zeros(ends.shape[:-2] + (out_cap - m,
                                                     ends.shape[-1]))], -2)
    prev = torch.cat([torch.zeros_like(ends[..., :1, :]), ends[..., :-1, :]],
                     dim=-2)
    occupied = (torch.arange(out_cap, device=hs.device)
                < torch.clamp(n_seg, max=out_cap)[..., None])
    sums = torch.where(occupied[..., None], ends - prev, 0.0)
    return sums, occupied, dest


def _centered_chans(xs, es, ones):
    """[..., N, 4+E] channels: count, xyz centered on the valid mean (keeps
    the f32 difference-of-prefix error ~1e-4 m), extras."""
    cnt_valid = torch.clamp(torch.sum(ones, dim=-1), min=1.0)
    center = torch.stack([torch.sum(xs[..., a] * ones, dim=-1) / cnt_valid
                          for a in range(3)], dim=-1)  # [..., 3]
    chans = [ones] + [(xs[..., a] - center[..., None, a]) * ones
                      for a in range(3)]
    if es is not None:
        chans += [es[..., j] * ones for j in range(es.shape[-1])]
    return torch.stack(chans, dim=-1), center


def voxel_downsample(xyz: torch.Tensor, mask: torch.Tensor, leaf: float,
                     out_cap: int, partition: torch.Tensor | None = None,
                     extra: torch.Tensor | None = None):
    """Centroid-downsample masked points into `out_cap` voxel centroids.

    partition: optional int [N]; points in different partitions never merge.
    extra: optional [N, E] float features averaged alongside xyz.

    Returns (out_xyz [out_cap,3], out_extra [out_cap,E] or None,
             out_part [out_cap] int32, out_mask [out_cap])."""
    n = xyz.shape[0]
    part = (torch.zeros((n,), dtype=torch.int32, device=xyz.device)
            if partition is None else partition)
    cell = _cell_of(xyz, leaf)
    h = _hash_cells(cell[:, 0], cell[:, 1], cell[:, 2], part)
    h = torch.where(mask, h, _M32)  # invalid points sort to the tail

    hs, order = torch.sort(h, stable=True)
    xs = xyz[order]
    es = extra[order] if extra is not None else None
    ps = part[order]
    ms = mask[order]
    chans, center = _centered_chans(xs, es, ms.to(xyz.dtype))
    sums, occupied, dest = _segment_sums(hs, ms, chans, out_cap)
    counts = sums[:, 0]
    denom = torch.clamp(counts, min=1.0)[:, None]
    out_xyz = sums[:, 1:4] / denom + torch.where(occupied[:, None],
                                                 center[None, :], 0.0)
    out_extra = sums[:, 4:] / denom if extra is not None else None
    # partition id of the voxel = any member's (its end element's)
    part_end = _scatter_rows(ps[:, None], dest, min(out_cap, n))[:, 0]
    part_end = torch.cat(
        [part_end, part_end.new_zeros(out_cap - part_end.shape[0])])
    out_part = torch.where(occupied, part_end, 0).to(torch.int32)
    return out_xyz, out_extra, out_part, occupied


def voxel_downsample_rows_slab(pts: torch.Tensor, mask: torch.Tensor,
                               leaf: float, ring_cap: int,
                               extra: torch.Tensor | None = None):
    """Per-ring voxel downsample that KEEPS the per-ring slab layout:
    pts [S, R, 3], mask [S, R], extra [S, R, E] -> (xyz [S, ring_cap, 3],
    extra [S, ring_cap, E] | None, mask [S, ring_cap]) where row s holds
    ring s's voxel centroids as a dense prefix (rings with more than
    ring_cap voxels drop the tail)."""
    S, R = pts.shape[0], pts.shape[1]
    part = torch.arange(S, dtype=torch.int32,
                        device=pts.device)[:, None].expand(S, R)
    cell = _cell_of(pts, leaf)
    h = _hash_cells(cell[..., 0], cell[..., 1], cell[..., 2], part)
    h = torch.where(mask, h, _M32)

    hs, order = torch.sort(h, dim=1, stable=True)
    xs = torch.take_along_dim(pts, order[..., None], dim=1)
    es = (torch.take_along_dim(extra, order[..., None], dim=1)
          if extra is not None else None)
    ms = torch.take_along_dim(mask, order, dim=1)
    chans, center = _centered_chans(xs, es, ms.to(pts.dtype))
    sums, out_mask, _ = _segment_sums(hs, ms, chans, ring_cap)
    counts = sums[..., 0]
    denom = torch.clamp(counts, min=1.0)[..., None]
    out_xyz = sums[..., 1:4] / denom + torch.where(
        out_mask[..., None], center[:, None, :], 0.0)
    out_extra = sums[..., 4:] / denom if extra is not None else None
    return out_xyz, out_extra, out_mask
