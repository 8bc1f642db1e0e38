"""LiDAR -> camera depth association (port of vloam_tpu/vision/depth_map.py;
reference point_cloud_util.cpp):

- build_depth_grid: project the velodyne points into the image (front
  filter depth > min_depth) and average pixel position and depth per
  g x g pixel bucket: ONE 4-channel sum per cell of a flat (gw+1) x (gh+1)
  grid whose extra row and column take the dropped points,
- query_depth: gather the (2r+1)^2 bucket window of each query as one flat
  [Q, win^2, 4] gather, require >= min_depth_neighbors filled buckets and
  inverse-distance-weight the 3 nearest (queryDepth, :302-407).

The per-cell sums add in a fixed order, each cell's points in point order:
a stable sort of the cell ids, then a sequential sum per cell
(``torch.segment_reduce``), the order in which XLA's CPU scatter adds the
reference's ``.at[ix, iy].add``. No atomics (an ``index_add_`` on CUDA adds
in whatever order its atomics land, and two runs differed in the last bits),
so the grid is the same on every run and device. Bucket coordinates scale by
``voxel.reciprocal_f32(g)``, the reference's ``/ g`` as XLA rounds it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..lidar.voxel import reciprocal_f32


class DepthGrid(NamedTuple):
    u: torch.Tensor  # [GW, GH] mean pixel x per bucket
    v: torch.Tensor  # [GW, GH]
    z: torch.Tensor  # [GW, GH] mean depth
    cnt: torch.Tensor  # [GW, GH] int32


def grid_shape(cfg) -> tuple[int, int]:
    g = cfg.downsample_grid_size
    return (-(-cfg.img_width // g), -(-cfg.img_height // g))


def fma_matvec(x: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """x [N, k] @ M[:, :k].T -> [N, r] for small k, each dot product as a
    chain of fused multiply-adds from the first term on (the order XLA's
    CPU dot uses), emulated in float64 and rounded to float32 after every
    step. No cuBLAS call, so TF32 never applies, and the rounding is the
    same on every device: the bucket a point falls into does not depend on
    where the projection ran."""
    xd = x.to(torch.float64)
    Md = M.to(torch.float64)
    acc = (xd[:, :1] * Md[:, 0]).to(torch.float32)
    for j in range(1, x.shape[1]):
        acc = (xd[:, j:j + 1] * Md[:, j] + acc.to(torch.float64)).to(
            torch.float32)
    return acc


def cell_sums(cell: torch.Tensor, vals: torch.Tensor,
              n_cells: int) -> torch.Tensor:
    """Per cell in [0, n_cells - 1) the sum of the rows of vals [N, C]
    whose cell [N] (int64) it is, each cell's rows added one after the
    other in point order from 0 (an empty cell sums to 0): a stable sort by
    cell, then one sequential sum per cell. The same on every run and
    device. The last cell is the dump, whose sum nobody reads: it is left
    at 0, since on CUDA one thread would add its points (most of a scan's)
    one after the other."""
    cell, order = torch.sort(cell, stable=True)
    starts = torch.searchsorted(cell, torch.arange(n_cells,
                                                   device=cell.device))
    starts = torch.cat([starts, starts[-1:]])  # the dump's segment: empty
    return torch.segment_reduce(vals[order], "sum", offsets=starts, axis=0,
                                unsafe=True)


def build_depth_grid(pts_velo: torch.Tensor, mask: torch.Tensor,
                     P_velo_to_img: torch.Tensor, cfg) -> DepthGrid:
    """pts_velo [N, 3] velodyne-frame points with validity mask [N];
    P_velo_to_img [3, 4] = P_rect0 @ cam_T_velo."""
    gw, gh = grid_shape(cfg)
    g = cfg.downsample_grid_size
    ph = fma_matvec(pts_velo, P_velo_to_img[:, :3]) + P_velo_to_img[:, 3]
    z = ph[:, 2]
    front = mask & (z > cfg.min_depth)
    zs = torch.where(front, z, 1.0)
    u = ph[:, 0] / zs
    v = ph[:, 1] / zs
    fx = torch.floor(u * reciprocal_f32(g))
    fy = torch.floor(v * reciprocal_f32(g))
    ok = front & (fx >= 0) & (fx < gw) & (fy >= 0) & (fy < gh)
    ix = torch.where(ok, fx, gw).to(torch.int64)  # out of range -> dump row
    iy = torch.where(ok, fy, gh).to(torch.int64)
    w = ok.to(torch.float32)
    vals = torch.stack([u * w, v * w, z * w, w], dim=1)  # [N, 4]
    # every dropped point goes to the last cell, (gw, gh)
    acc = cell_sums(ix * (gh + 1) + iy, vals, (gw + 1) * (gh + 1))
    acc = acc.reshape(gw + 1, gh + 1, 4)[:gw, :gh]
    denom = torch.clamp(acc[..., 3], min=1.0)
    return DepthGrid(u=acc[..., 0] / denom, v=acc[..., 1] / denom,
                     z=acc[..., 2] / denom, cnt=acc[..., 3].to(torch.int32))


def query_depth(grid: DepthGrid, xy: torch.Tensor, cfg) -> torch.Tensor:
    """Depth [Q] at pixel coords xy [Q, 2]; -1 where the neighbourhood is
    too sparse (reference :336-338)."""
    g = cfg.downsample_grid_size
    r = cfg.depth_search_radius
    win = 2 * r + 1
    gw, gh = grid.u.shape
    ph = gh + 2 * r
    dev = xy.device

    # padding cells have cnt == 0: the reference's bounds check
    planes = torch.stack([
        F.pad(grid.u, (r, r, r, r)), F.pad(grid.v, (r, r, r, r)),
        F.pad(grid.z, (r, r, r, r)),
        F.pad(grid.cnt.to(torch.float32), (r, r, r, r)),
    ], dim=-1).reshape(-1, 4)

    x, y = xy[:, 0], xy[:, 1]
    ix = torch.clamp(torch.floor(x * reciprocal_f32(g)).to(torch.int64), 0,
                     gw - 1)
    iy = torch.clamp(torch.floor(y * reciprocal_f32(g)).to(torch.int64), 0,
                     gh - 1)
    dx, dy = torch.meshgrid(torch.arange(win, device=dev),
                            torch.arange(win, device=dev), indexing="ij")
    off = dx.reshape(-1) * ph + dy.reshape(-1)
    wall = planes[(ix * ph + iy)[:, None] + off[None, :]]  # [Q, win^2, 4]
    wu, wv, wz = wall[..., 0], wall[..., 1], wall[..., 2]
    ok = wall[..., 3] > 0
    n_ok = torch.sum(ok, dim=1)
    dist = torch.sqrt((x[:, None] - wu) ** 2 + (y[:, None] - wv) ** 2)
    dist = torch.where(ok, dist, torch.inf)
    # the 3 nearest by a stable sort: ties (and empty cells) keep the lower
    # window slot first, as lax.top_k does
    d3, ni = torch.sort(dist, dim=1, stable=True)
    d3, ni = d3[:, :3], ni[:, :3]
    z3 = torch.gather(wz, 1, ni)
    num = (z3[:, 0] * d3[:, 1] * d3[:, 2]
           + z3[:, 1] * d3[:, 0] * d3[:, 2]
           + z3[:, 2] * d3[:, 0] * d3[:, 1])
    den = (1e-4 + d3[:, 1] * d3[:, 2] + d3[:, 0] * d3[:, 2]
           + d3[:, 0] * d3[:, 1])
    ok_q = n_ok >= cfg.min_depth_neighbors
    return torch.where(ok_q, num / den, -1.0)
