"""Distributed BA inside the fused engines: the mapping chunk sharded over
a Mesh (port of vloam_tpu/parallel/mesh_fused.py).

The mapping chunk of LoamEngine(mesh=) and VloamEngine(mesh=) runs on
every rank in step:

- the hashed cell-slab map stays sharded for the whole sequence: its rows
  are hash buckets, rank r owns the rows [r nb/D, (r+1) nb/D) and holds
  only that block [nb/D, 3 cap] (shard_map_state);
- per frame each rank compacts its block to the `window_rows` bucket rows
  nearest the predicted pose (_window_block: one top-k over the rows'
  nearest live slot, then one row_gather), which bounds the ring k-NN's
  candidates per hop to window_rows * cap whatever the map's size; the
  rows that actually held a point are summed over the ranks and reported,
  so a caller can check the window was large enough;
- the pose refinement is sharded_mapping.aligned_rounds: each rank's slice
  dev*Cc/D of the (replicated) scan stacks, the global 5-NN by ring hops
  over the windowed blocks, the 6x6 normal equations all-reduced;
- each frame's refined points are inserted into the block of the rank that
  owns their bucket (batch_mapping._merged_row_insert, whose row fetch is
  the row_gather kernel on the card), and every block is evicted on
  cube-boundary crossings.

Departures from the reference, none of which changes a result: the evict
is computed every frame and selected with torch.where (the reference's
lax.cond would be a host read), the ranks' insert and evict counts are
summed in one all_reduce a frame, and the active-row counts in one a
chunk. Nothing in the frame loop reads a device value back to the host
(under gloo on CUDA its collectives stage through host memory).

Reference being distributed: laser_mapping.cpp:458-626 (solve) and
:638-702 (insert); the window is the analogue of its 5x5x3 neighbour-cube
gather (:404-428).
"""

from __future__ import annotations

import torch

from ..geometry import so3
from ..lidar.batch_mapping import _merged_row_insert
from ..lidar.gridmap import SENTINEL, FeatureGrid, _bucket_of, row_gather
from ..lidar.knn import dist_key, smallest_keys
from ..lidar.mapping import GridMap, _cube_coord, window_half_extent
from .sharded import Mesh, all_gather, psum
from .sharded_mapping import aligned_rounds, ring_shards

MESH_MO_OUT = 10  # [q_mo(4), t_mo(3), mapped, n_active_rows_c, n_active_rows_s]


def _window_block(blk: torch.Tensor, center: torch.Tensor, w_rows: int):
    """Compact a rank's bucket-row block [nbD, 3*cap] to its w_rows rows
    nearest `center` [3] (by their nearest live slot; empty rows last, lower
    row first on ties, as the reference's top_k). Returns (pts
    [w_rows*cap, 3], mask, n_active_rows): n_active_rows counts the rows
    holding a live point; above w_rows the window truncated."""
    nbD, W = blk.shape
    cap = W // 3
    xyz = blk.reshape(nbD, 3, cap)
    live = xyz[:, 0] < SENTINEL * 0.5  # [nbD, cap]
    diff = xyz - center[None, :, None]
    sq = diff * diff
    d2 = torch.where(live, (sq[:, 0] + sq[:, 1]) + sq[:, 2], torch.inf)
    row_key = torch.min(d2, dim=1).values  # [nbD]
    n_active = torch.sum(torch.isfinite(row_key), dtype=torch.int32)
    rows_idx = torch.arange(nbD, device=blk.device)
    idx = smallest_keys(dist_key(row_key, rows_idx), w_rows) & 0xFFFFFFFF
    rows = row_gather(blk, idx)  # [w_rows, 3*cap]
    pts = rows.reshape(w_rows, 3, cap).transpose(1, 2).reshape(-1, 3)
    return pts, pts[:, 0] < SENTINEL * 0.5, n_active


def _block_evict(blk: torch.Tensor, center_w: torch.Tensor,
                 radius: torch.Tensor):
    """gridmap.grid_evict on one rank's block; returns (blk', live slots
    left in it)."""
    cap = blk.shape[1] // 3
    xyz = blk.reshape(-1, 3, cap)
    live = xyz[:, 0] < SENTINEL * 0.5
    inside = torch.all(torch.abs(xyz - center_w[None, :, None])
                       <= radius[None, :, None], dim=1)
    keep = live & inside
    pts = torch.where(keep[:, None, :], xyz, SENTINEL)
    return pts.reshape(blk.shape), torch.sum(keep, dtype=torch.int32)


def shard_map_state(mstate, mesh: Mesh):
    """This rank's form of a vloam_step.MapState for the mesh chunk: its
    block of each grid's rows (hash buckets), everything else as given."""
    nbD = mstate.cube.corner.pts.shape[0] // mesh.size
    lo = mesh.rank * nbD

    def block(g: FeatureGrid) -> FeatureGrid:
        return FeatureGrid(g.pts[lo:lo + nbD].contiguous(), g.n_live)

    cube = mstate.cube
    return mstate._replace(cube=GridMap(block(cube.corner), block(cube.surf),
                                        cube.center))


def gather_map(cube: GridMap, mesh: Mesh) -> GridMap:
    """The whole map from the ranks' blocks (a collective: every rank calls
    it). Rows in bucket order, as a single-device map's."""
    return GridMap(*(FeatureGrid(all_gather(g.pts, mesh), g.n_live)
                     for g in (cube.corner, cube.surf)), cube.center)


class MeshMappingChunk:
    """One rank's mesh mapping chunk (make_mesh_mapping_chunk) and what a
    fused engine keeps of it: called as the chunk, it keeps each chunk's
    active-row counts on the device; window_active_rows reads them back:
    (peak active map rows, the window's rows over all ranks). shard() lays
    a MapState out for the chunk (shard_map_state), whole_map() gathers the
    ranks' blocks (a collective)."""

    def __init__(self, mesh: Mesh, cfg, window_rows: int = 4096):
        self.mesh = mesh
        self.window_rows = window_rows
        self._chunk = make_mesh_mapping_chunk(mesh, cfg, window_rows)
        self._active: list[torch.Tensor] = []

    def shard(self, mstate):
        return shard_map_state(mstate, self.mesh)

    def __call__(self, mstate, *frames):
        mstate, out = self._chunk(mstate, *frames)
        self._active.append(out[:, 8:10])
        return mstate, out

    @property
    def window_active_rows(self) -> tuple[int, int]:
        peak = int(torch.cat(self._active).max()) if self._active else 0
        return peak, self.window_rows * self.mesh.size

    def whole_map(self, cube: GridMap) -> GridMap:
        return gather_map(cube, self.mesh)


class MeshFrameStages:
    """The stages of one frame of this rank's mesh mapping chunk, in the
    order the chunk runs them (make_mesh_mapping_chunk composes them; the
    measurement tools/model_mesh_scaling.py times them one by one):

    window(qwm, twm, q_w, t_w, c_blk, s_blk): the map prediction, both
      grids' windows and their ring shards -> (x0, corner shards, surf
      shards, the active-row counts [2]);
    aligned_rounds(...): sharded_mapping.aligned_rounds on this rank's
      slice of the stacks (round_knn, the masked_knn sweep, then round_lm,
      the LM chain, cfg.outer_rounds times);
    update(...): the 'enough map' select, the inserts into the owning
      ranks' blocks, the evict on cube-boundary crossings (its counts
      all-reduced) and transformUpdate;
    tail(poses, active, ...): the chunk's output rows and state."""

    def __init__(self, mesh: Mesh, cfg, window_rows: int = 4096):
        if cfg.lo.mapping_skip_frame != 1:
            raise NotImplementedError(
                "fused mesh mapping supports mapping_skip_frame == 1 "
                "(use the host engine's mesh path for skipping)")
        self.mesh = mesh
        self.mcfg = mcfg = cfg.mapping
        D = mesh.size
        nb = mcfg.map_n_buckets
        if nb % D:
            raise ValueError(
                f"map_n_buckets {nb} not divisible by mesh size {D}")
        self.nb, self.nbD = nb, nb // D
        self.w_rows = min(window_rows, self.nbD)
        self.lo_row = mesh.rank * self.nbD
        self.radius = window_half_extent(mcfg, mesh.device)

    def rank_slices(self, c_xyz, s_xyz):
        """This rank's slices of the [F, C, 3] corner and surf stacks."""
        D, r = self.mesh.size, self.mesh.rank
        CcD, CsD = c_xyz.shape[1] // D, s_xyz.shape[1] // D
        return (slice(r * CcD, (r + 1) * CcD),
                slice(r * CsD, (r + 1) * CsD))

    def window(self, qwm, twm, q_w, t_w, c_blk, s_blk):
        q_pred = so3.quat_normalize(so3.quat_multiply(qwm, q_w))
        t_pred = twm + so3.quat_rotate(qwm, t_w)
        wc, wc_m, nact_c = _window_block(c_blk, t_pred, self.w_rows)
        ws, ws_m, nact_s = _window_block(s_blk, t_pred, self.w_rows)
        x0 = torch.cat([q_pred, t_pred]).to(torch.float32)
        return (x0, ring_shards(wc, wc_m, self.mesh),
                ring_shards(ws, ws_m, self.mesh),
                torch.stack([nact_c, nact_s]))

    def aligned_rounds(self, c_xyz, c_m, s_xyz, s_m, shards_c, shards_s,
                       x0):
        """c_xyz ... s_m: this rank's slices of one frame's stacks."""
        x, _ = aligned_rounds(c_xyz, c_m, s_xyz, s_m, shards_c, shards_s,
                              x0, self.mcfg, self.mesh)
        return x

    def _insert(self, blk, stack, mask, q_m, t_m, cell, res):
        pw = so3.quat_rotate(q_m, stack) + t_m
        local = _bucket_of(pw, cell, self.nb) - self.lo_row
        key = torch.where(mask & (local >= 0) & (local < self.nbD), local,
                          self.nbD)
        blk, ok, _ = _merged_row_insert(blk, key, pw, res)
        return blk, torch.sum(ok, dtype=torch.int32)

    def update(self, x, x0, c_xyz, c_m, s_xyz, s_m, q_w, t_w, c_blk, s_blk,
               n_c, n_s, center):
        """c_xyz ... s_m: one frame's whole stacks. Returns (x, c_blk,
        s_blk, n_c, n_s, center, qwm, twm)."""
        mcfg = self.mcfg
        enough = ((n_c > mcfg.min_corner_map_points)
                  & (n_s > mcfg.min_surf_map_points))
        x = torch.where(enough, x, x0)
        q_m, t_m = x[:4], x[4:]
        c_blk, add_c = self._insert(c_blk, c_xyz, c_m, q_m, t_m,
                                    mcfg.corner_cell, mcfg.line_resolution)
        s_blk, add_s = self._insert(s_blk, s_xyz, s_m, q_m, t_m,
                                    mcfg.surf_cell, mcfg.plane_resolution)

        # recenter on cube-boundary crossings (laser_mapping.cpp:207-402)
        new_center = _cube_coord(t_m, mcfg.cube_size)
        changed = torch.any(new_center != center)
        c_w = new_center.to(torch.float32) * mcfg.cube_size
        c_ev, keep_c = _block_evict(c_blk, c_w, self.radius)
        s_ev, keep_s = _block_evict(s_blk, c_w, self.radius)
        counts = psum(torch.stack([add_c, add_s, keep_c, keep_s]),
                      self.mesh)
        n_c = torch.where(changed, counts[2], n_c + counts[0])
        n_s = torch.where(changed, counts[3], n_s + counts[1])
        c_blk = torch.where(changed, c_ev, c_blk)
        s_blk = torch.where(changed, s_ev, s_blk)
        center = torch.where(changed, new_center, center)

        # transformUpdate (laser_mapping.cpp:140-144)
        qwm = so3.quat_normalize(
            so3.quat_multiply(q_m, so3.quat_conjugate(q_w)))
        twm = t_m - so3.quat_rotate(qwm, t_w)
        return x, c_blk, s_blk, n_c, n_s, center, qwm, twm

    def tail(self, mstate, poses, active, c_blk, s_blk, n_c, n_s, center,
             qwm, twm, n_frames: int):
        """The chunk's rows [F, MESH_MO_OUT] (active rows summed over the
        ranks) and its new state."""
        active = psum(torch.stack(active), self.mesh).to(torch.float32)
        out = torch.cat([torch.stack(poses),
                         torch.ones_like(active[:, :1]), active], dim=1)
        new = mstate._replace(
            cube=GridMap(FeatureGrid(c_blk, n_c), FeatureGrid(s_blk, n_s),
                         center),
            q_wmap_wodom=qwm, t_wmap_wodom=twm,
            frame_idx=mstate.frame_idx + n_frames)
        return new, out


def make_mesh_mapping_chunk(mesh: Mesh, cfg, window_rows: int = 4096):
    """The mesh mapping chunk for this rank, with the contract of
    vloam_step.mapping_run_chunk:
        (mstate, c_xyz [F, Cc, 3], c_m, s_xyz, s_m, q_w_lo [F, 4], t_w_lo)
        -> (mstate', out [F, MESH_MO_OUT])
    where mstate holds this rank's blocks (shard_map_state). Needs
    mapping_skip_frame == 1, as the reference's. A frame is
    MeshFrameStages' window, aligned_rounds and update, in that order."""
    st = MeshFrameStages(mesh, cfg, window_rows)

    def chunk(mstate, c_xyz, c_m, s_xyz, s_m, q_w_lo, t_w_lo):
        cube = mstate.cube
        c_blk, s_blk = cube.corner.pts, cube.surf.pts
        n_c, n_s, center = cube.corner.n_live, cube.surf.n_live, cube.center
        qwm, twm = mstate.q_wmap_wodom, mstate.t_wmap_wodom
        mc, ms = st.rank_slices(c_xyz, s_xyz)
        poses, active = [], []
        for f in range(q_w_lo.shape[0]):
            q_w, t_w = q_w_lo[f], t_w_lo[f]
            x0, shards_c, shards_s, act = st.window(qwm, twm, q_w, t_w,
                                                    c_blk, s_blk)
            active.append(act)
            x = st.aligned_rounds(c_xyz[f, mc], c_m[f, mc], s_xyz[f, ms],
                                  s_m[f, ms], shards_c, shards_s, x0)
            x, c_blk, s_blk, n_c, n_s, center, qwm, twm = st.update(
                x, x0, c_xyz[f], c_m[f], s_xyz[f], s_m[f], q_w, t_w, c_blk,
                s_blk, n_c, n_s, center)
            poses.append(x)
        return st.tail(mstate, poses, active, c_blk, s_blk, n_c, n_s,
                       center, qwm, twm, q_w_lo.shape[0])

    return chunk
