"""Pose-graph optimization, the loop-consistency backend (port of
vloam_tpu/parallel/pose_graph.py).

A batched SE(3) pose graph solved by Gauss-Newton with matrix-free,
block-Jacobi preconditioned conjugate gradient. State: poses [N, 7] (quat
xyzw, t). Edges: measured relative poses T_i^-1 T_j with per-edge weights.
The gauge is fixed by a strong prior on pose 0.

Every sum over the edges of a node (the right-hand side, the preconditioner
blocks and each CG matrix-vector product) adds the node's terms in a fixed
order: its edges as the first end in edge order, then as the second end, as
the reference's two scatter-adds do on the CPU. It is a stable sort of the
edge ends once per solve and a sequential segment sum per node
(torch.segment_reduce), never an atomic index_add_, so the result is the
same on every run and device.

With a mesh (parallel/sharded.py) the edges are sharded over its ranks
(shard_graph; padding edges have weight 0) and the poses are replicated:
each rank sums the right-hand side, the preconditioner blocks and each CG
product over its own edges, one all_reduce adds them over the ranks, and
every rank runs the same PCG on the sums.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import so3
from .sharded import psum, shard_batch


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # [N, 7] (qx,qy,qz,qw, tx,ty,tz)
    edge_i: torch.Tensor  # [E] int64
    edge_j: torch.Tensor  # [E] int64
    meas: torch.Tensor  # [E, 7] measured T_i^-1 T_j
    weight: torch.Tensor  # [E] (0 for padding edges)


def _edge_residual(delta, qi, ti, qj, tj, qm, tm):
    """r(delta) in R^6 for one edge, with local perturbations
    delta = [dth_i, dt_i, dth_j, dt_j] (12)."""
    qi = so3.quat_multiply(qi, so3.quat_from_axis_angle(delta[0:3]))
    ti = ti + delta[3:6]
    qj = so3.quat_multiply(qj, so3.quat_from_axis_angle(delta[6:9]))
    tj = tj + delta[9:12]
    qi_inv = so3.quat_conjugate(qi)
    q_ij = so3.quat_multiply(qi_inv, qj)
    t_ij = so3.quat_rotate(qi_inv, tj - ti)
    r_rot = so3.axis_angle_from_quat(
        so3.quat_multiply(so3.quat_conjugate(qm), q_ij))
    return torch.cat([r_rot, t_ij - tm])


def _edge_terms(poses, edge_i, edge_j, meas, weight):
    """Weighted per-edge residual r [E, 6] and Jacobian J [E, 6, 12] at
    delta = 0 (forward mode, vmapped over the edges, as the reference's
    jacfwd). Forward mode carries some tangents in float64 (a Python scalar
    times a dual tensor, in the log map); J is rounded to the poses'
    dtype."""
    args = (poses[edge_i, :4], poses[edge_i, 4:], poses[edge_j, :4],
            poses[edge_j, 4:], meas[:, :4], meas[:, 4:])
    zero = poses.new_zeros((edge_i.shape[0], 12))
    r = torch.func.vmap(_edge_residual)(zero, *args)
    J = torch.func.vmap(torch.func.jacfwd(_edge_residual, argnums=0))(
        zero, *args).to(poses.dtype)
    w = weight[:, None]
    return r * w, J * w[:, :, None]


def _retract_all(poses, delta):
    q = so3.quat_normalize(so3.quat_multiply(
        poses[:, :4], so3.quat_from_axis_angle(delta[:, :3])))
    return torch.cat([q, poses[:, 4:] + delta[:, 3:]], dim=-1)


class _NodeSums:
    """Per-node sums of per-edge-end values in a fixed order: the ends
    (edge_i then edge_j, each in edge order) stably sorted by node once,
    then one sequential sum per node."""

    def __init__(self, edge_i, edge_j, n: int):
        ends = torch.cat([edge_i, edge_j])
        nodes, self.order = torch.sort(ends, stable=True)
        self.offsets = torch.searchsorted(
            nodes, torch.arange(n + 1, device=ends.device))

    def __call__(self, at_i, at_j):
        vals = torch.cat([at_i, at_j])[self.order]
        return torch.segment_reduce(vals, "sum", offsets=self.offsets,
                                    axis=0, unsafe=True)


def _contract(J, x):
    """einsum("erk,ek->er") as a broadcast product and sum (no cuBLAS)."""
    return (J * x[:, None, :]).sum(-1)


def _contract_t(J, u):
    """einsum("erk,er->ek")."""
    return (J * u[:, :, None]).sum(1)


def shard_graph(graph: PoseGraph, mesh) -> PoseGraph:
    """This rank's edge shard of a whole graph: the edges padded to a
    multiple of the mesh size (node 0 to node 0, identity measurement,
    weight 0) and split in rank order; the poses stay whole."""
    pad = (-graph.edge_i.shape[0]) % mesh.size
    meas = graph.meas
    if pad:
        ident = torch.zeros((pad, 7), dtype=meas.dtype, device=meas.device)
        ident[:, 3] = 1.0
        meas = torch.cat([meas, ident])
    return PoseGraph(graph.poses, shard_batch(graph.edge_i, mesh),
                     shard_batch(graph.edge_j, mesh), shard_batch(meas, mesh),
                     shard_batch(graph.weight, mesh))


def optimize_pose_graph(graph: PoseGraph, mesh=None, gn_iters: int = 8,
                        cg_iters: int = 32, damping: float = 1e-6,
                        gauge_weight: float = 1e6) -> torch.Tensor:
    """Optimized poses [N, 7] on the graph's device. Nothing is read back to
    the host: gn_iters Gauss-Newton steps of cg_iters PCG iterations each
    are queued as they come. mesh: a parallel.sharded.Mesh over whose
    ranks the graph's edges are sharded (shard_graph), every rank calling
    with its own shard; the result is the same on every rank."""
    def reduce(x):
        return x if mesh is None else psum(x, mesh)

    poses = graph.poses
    n = poses.shape[0]
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    sums = _NodeSums(ei, ej, n)
    eye6 = torch.eye(6, dtype=poses.dtype, device=poses.device)
    # the gauge prior acts on pose 0 only
    gauge = torch.zeros((n, 1), dtype=poses.dtype, device=poses.device)
    gauge[0] = gauge_weight

    for _ in range(gn_iters):
        r, J = _edge_terms(poses, ei, ej, graph.meas, graph.weight)
        Ji, Jj = J[:, :, :6], J[:, :, 6:]

        def A(v):
            u = _contract(J, torch.cat([v[ei], v[ej]], dim=-1))
            y = reduce(sums(_contract_t(Ji, u), _contract_t(Jj, u)))
            return y + damping * v + gauge * v

        # the right-hand side and the block-Jacobi preconditioner (without
        # it CG on a chain graph needs O(N) iterations), in one reduction
        bD = reduce(sums(
            torch.cat([-_contract_t(Ji, r)[:, :, None],
                       (Ji[:, :, :, None] * Ji[:, :, None, :]).sum(1)], 2),
            torch.cat([-_contract_t(Jj, r)[:, :, None],
                       (Jj[:, :, :, None] * Jj[:, :, None, :]).sum(1)], 2)))
        b = bD[:, :, 0]
        D = bD[:, :, 1:] + damping * eye6 + gauge[:, :, None] * eye6
        Minv = torch.linalg.inv_ex(D).inverse  # no singularity check: no sync

        def apply_M(res):
            return (Minv * res[:, None, :]).sum(-1)

        x = torch.zeros_like(b)
        res = b - A(x)
        z = apply_M(res)
        p = z
        rz = torch.sum(res * z)
        for _ in range(cg_iters):
            Ap = A(p)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
            x = x + alpha * p
            res = res - alpha * Ap
            z = apply_M(res)
            rz_new = torch.sum(res * z)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            p = z + beta * p
            rz = rz_new
        poses = _retract_all(poses, x)
    return poses


def build_odometry_graph(poses_qt: np.ndarray, loop_pairs=None,
                         odo_weight: float = 1.0, loop_weight: float = 1.0,
                         meas_fn=None, device="cuda") -> PoseGraph:
    """Consecutive-frame edges (+ optional loop closures) from an initial
    trajectory [N, 7]. meas_fn(i, j) can supply measured relative poses
    (defaults to the relative pose of the given trajectory)."""
    from scipy.spatial.transform import Rotation as R

    n = len(poses_qt)
    pairs = [(i, i + 1) for i in range(n - 1)]
    weights = [odo_weight] * len(pairs)
    if loop_pairs:
        pairs += list(loop_pairs)
        weights += [loop_weight] * len(loop_pairs)

    def rel(i, j):
        qi = R.from_quat(poses_qt[i, :4])
        qj = R.from_quat(poses_qt[j, :4])
        q = (qi.inv() * qj).as_quat()
        t = qi.inv().apply(poses_qt[j, 4:] - poses_qt[i, 4:])
        return np.concatenate([q, t])

    meas = np.stack([
        rel(i, j) if meas_fn is None else meas_fn(i, j) for i, j in pairs
    ])

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return PoseGraph(
        poses=f32(poses_qt),
        edge_i=torch.tensor([p[0] for p in pairs], dtype=torch.int64,
                            device=device),
        edge_j=torch.tensor([p[1] for p in pairs], dtype=torch.int64,
                            device=device),
        meas=f32(meas), weight=f32(weights))
