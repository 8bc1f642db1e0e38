"""Map- and scan-sharded scan-to-map alignment, the distributed BA core
(port of vloam_tpu/parallel/sharded_mapping.py).

Both the data and the compute are sharded over the ranks of a Mesh
(parallel/sharded.py):

- each rank holds one block of the map candidates and 1/D of the scan
  stacks, so k-NN distances, feature geometry and Jacobians scale 1/D;
- the global 5-NN of a rank's scan points is built by rotating the map
  blocks around the ring (D - 1 hops, ppermute_ring) and merging a running
  top-k of (distance, coordinates): no rank holds the whole map;
- each rank accumulates the 6x6 normal equations over its own scan points,
  one all_reduce sums them (the Schur-style reduction: the point-block
  variables are eliminated by the closed-form line and plane fits, only the
  6-dof pose crosses ranks), and every rank applies the same LM step: the
  accept / reject compares summed costs, so every rank takes the same
  branch.

The rounds mirror the reference's (aligned_rounds); the LM is the port's
lm_solve with the ranks' sums as its reduce hook, the residuals the single
device solve's fused family (lidar/mapping.py) linearized in closed form.
Ties among the k nearest fall as the reference's: by distance, then lower
candidate index, then earlier hop (lidar/knn.py). The ring hops of a frame
are made once and reused by both outer rounds (the reference sends the
same blocks again in its second round).
"""

from __future__ import annotations

import torch

from ..geometry import so3
from ..lidar.knn import dist_key, key_dist, masked_knn, smallest_keys
from ..lidar.mapping import (_retract, corner_geometry, fused_family,
                             surf_geometry)
from ..solver.lm import lm_solve
from .sharded import Mesh, all_gather, ppermute_ring, psum_normal_equations


def ring_shards(pts: torch.Tensor, mask: torch.Tensor, mesh: Mesh):
    """The map blocks this rank visits, in ring order: its own (pts [C, 3],
    mask [C]) first, then each block passed on from rank r-1, D - 1 hops
    (the reference's ppermute loop in _ring_knn)."""
    shards = [(pts, mask)]
    packed = torch.cat([pts, mask.to(pts.dtype)[:, None]], dim=1)
    for _ in range(mesh.size - 1):
        packed = ppermute_ring(packed, mesh)
        shards.append((packed[:, :3], packed[:, 3] > 0.5))
    return shards


def _ring_knn(queries: torch.Tensor, shards, k: int):
    """Global k-NN of this rank's queries [Q, 3] over the visiting map
    shards (ring_shards). Returns (d_sq [Q, k] ascending, near [3, Q, k]
    planar coordinates); the merge of [best, visiting shard] keeps the
    earlier hop on equal distances, as the reference's top_k does."""
    best_d = best_p = None
    for pts, mask in shards:
        d, i = masked_knn(queries, pts, mask, k=k)
        # a gather past the end clamps, as the reference's does
        p = pts[torch.clamp(i, max=pts.shape[0] - 1)]  # [Q, k, 3]
        if best_d is None:
            best_d, best_p = d, p
            continue
        cand_d = torch.cat([best_d, d], dim=1)
        cand_p = torch.cat([best_p, p], dim=1)
        pos = torch.arange(2 * k, device=queries.device)
        key = smallest_keys(dist_key(cand_d, pos), k)
        best_d = key_dist(key)
        best_p = torch.take_along_dim(cand_p, (key & 0xFFFFFFFF)[:, :, None],
                                      dim=1)
    return best_d, best_p.permute(2, 0, 1)


def rounds_setup(c_stack, s_stack, x):
    """What every round of aligned_rounds shares: (is_edge [Bc + Bs, 1],
    the stacked scan points, the accepted count before any round)."""
    B_c = c_stack.shape[0]
    is_edge = (torch.arange(B_c + s_stack.shape[0], device=x.device)
               < B_c)[:, None]
    cp = torch.cat([c_stack, s_stack])
    return is_edge, cp, torch.zeros((), dtype=torch.float32, device=x.device)


def round_knn(c_stack, s_stack, corner_shards, surf_shards, x, cfg):
    """A round's global 5-NN: this rank's scan points moved by x, each
    grid's ring k-NN over its visiting shards. Returns (corner, surf)
    (d_sq, near) pairs."""
    pc = so3.quat_rotate(x[:4], c_stack) + x[4:]
    ps = so3.quat_rotate(x[:4], s_stack) + x[4:]
    return (_ring_knn(pc, corner_shards, cfg.knn),
            _ring_knn(ps, surf_shards, cfg.knn))


def round_lm(c_mask, s_mask, cp, is_edge, knn_c, knn_s, x, cfg, mesh: Mesh):
    """A round's line and plane fits and its LM chain, the normal
    equations all-reduced: (x', the residuals this rank accepted)."""
    corner = corner_geometry(c_mask, *knn_c, cfg)
    surf = surf_geometry(s_mask, *knn_s, cfg)
    x = lm_solve(fused_family(cp, is_edge, corner, surf), _retract, x,
                 iterations=cfg.gn_iterations, huber_delta=cfg.huber_delta,
                 reduce=psum_normal_equations(mesh))
    return x, (corner[3].sum() + surf[2].sum()).to(torch.float32)


def aligned_rounds(c_stack, c_mask, s_stack, s_mask, corner_shards,
                   surf_shards, x, cfg, mesh: Mesh):
    """This rank's part of the distributed scan-to-map refinement (the
    reference's aligned_rounds, run by every rank in step). c/s_stack and
    masks: this rank's scan points; corner/surf_shards: ring_shards of the
    map blocks. Returns (x [7], the same on every rank, and the residuals
    this rank accepted in the last round). Each round is round_knn then
    round_lm (tools/model_mesh_scaling.py times them apart)."""
    is_edge, cp, n_loc = rounds_setup(c_stack, s_stack, x)
    for _ in range(cfg.outer_rounds):
        knn_c, knn_s = round_knn(c_stack, s_stack, corner_shards,
                                 surf_shards, x, cfg)
        x, n_loc = round_lm(c_mask, s_mask, cp, is_edge, knn_c, knn_s, x,
                            cfg, mesh)
    return x, n_loc


def sharded_map_alignment(mesh: Mesh, corner_stack, corner_mask, surf_stack,
                          surf_mask, map_corner, map_corner_mask, map_surf,
                          map_surf_mask, x0, cfg,
                          return_counts: bool = False):
    """Distributed scan-to-map pose refinement from x0 [7] = (quat, t).
    Every array argument is this rank's shard (sharded.shard_batch). Returns
    x [7]; with return_counts also every rank's accepted residual count
    [D] (final round), for load-balance checks."""
    x, n_loc = aligned_rounds(
        corner_stack, corner_mask, surf_stack, surf_mask,
        ring_shards(map_corner, map_corner_mask, mesh),
        ring_shards(map_surf, map_surf_mask, mesh),
        x0.to(torch.float32), cfg, mesh)
    if return_counts:
        return x, all_gather(n_loc[None], mesh)
    return x
