"""The one-pass shortlist LO association (port of scripts/legacy_assoc.py).

The JAX package retired it from its LO path: the engines associate by the
exact per-ring minimum (lidar/ring_assoc.py, the port's ring_min1_packed).
It stays, as in the reference, a comparison baseline for the measurement
tools (tools/profile_lo2.py); nothing on an engine's path calls it.

shortlist_ring_assoc computes the [Q, C] distance matrix once, keeps each
query's `shortlist` nearest live candidates and derives all picks from
them: the nearest (d0, i0), the nearest on another ring within nearby_scan
rings (d2, i2) and, for surfaces, the nearest other point on the nearest's
own ring (d3, i3). A constrained pick outside the shortlist is lost (+inf),
which at most drops that residual.

Departures from the reference, none of which changes a pick on data
without exact ties:
- the shortlist is exact: the `shortlist` smallest (distance, index) keys
  (lidar/knn.py's keys: equal distances lower index first). The reference
  takes lax.approx_min_k, which on its CPU backend is exact too, and on the
  TPU keeps the nearest exactly and misses ~5 % deeper in the shortlist;
  the card has no approximate top-k;
- the distances are the reference's expanded form |q|^2 + |c|^2 - 2 q.c
  rounded as XLA's CPU code rounds it under jit: every sum of three
  products a chain of fused multiply-adds (ring_assoc.fma_f32, emulated in
  float64 on any device), so the CPU and the card give the reference's
  distances bit for bit. No matmul: no TF32 setting reaches them;
- the argmins take the lowest shortlist position on ties
  (ring_assoc.first_argmin), as jnp.argmin does.
"""

from __future__ import annotations

import torch

from ..lidar.knn import dist_key, key_dist, smallest_keys
from ..lidar.ring_assoc import first_argmin, fma_f32


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of length 3 as XLA's CPU code sums it:
    fma(a2, b2, fma(a1, b1, a0 b0))."""
    return fma_f32(a[..., 2], b[..., 2],
                   fma_f32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def dist_sq(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[Q, C] max(|q|^2 + |c|^2 - 2 q.c, 0), the reference's _dist_sq
    (vloam_tpu/lidar/knn.py:32) rounded as under jit on its CPU."""
    Q, C = q.shape[0], c.shape[0]
    qq, cc = _dot3(q, q), _dot3(c, c)
    qc = _dot3(q[:, None, :].expand(Q, C, 3), c[None, :, :].expand(Q, C, 3))
    return torch.clamp((qq[:, None] + cc[None, :]) - 2.0 * qc, min=0.0)


def shortlist_ring_assoc(queries: torch.Tensor, cands: torch.Tensor,
                         c_ring: torch.Tensor, c_mask: torch.Tensor,
                         nearby_scan: float, mode: str = "corner",
                         shortlist: int = 24) -> dict:
    """LO correspondences from a distance shortlist, one pass (the
    reference's shortlist_ring_assoc). queries [Q, 3], cands [C, 3], c_ring
    [C] int, c_mask [C] bool. Returns {d0, i0, d2, i2, d3, i3}: squared
    distances (+inf where no pick) and candidate indices (int64); corner
    mode gives d3 = +inf, i3 = 0."""
    Q, C = queries.shape[0], cands.shape[0]
    dev = queries.device
    inf = torch.full((), float("inf"), device=dev)  # a fill: capturable
    d = torch.where(c_mask[None, :], dist_sq(queries, cands), inf)
    key = smallest_keys(dist_key(d, torch.arange(C, device=dev)), shortlist)
    sl_d, sl_i = key_dist(key), key & 0xFFFFFFFF  # [Q, s] ascending
    d0, i0 = sl_d[:, 0], sl_i[:, 0]
    rings = c_ring.to(torch.int64)[sl_i]  # [Q, s]
    diff = rings - rings[:, :1]
    near = torch.abs(diff).to(torch.float32) <= nearby_scan
    d_other = torch.where((diff != 0) & near, sl_d, inf)
    a2 = first_argmin(d_other, 1)[:, None]
    d2 = torch.take_along_dim(d_other, a2, 1)[:, 0]
    i2 = torch.take_along_dim(sl_i, a2, 1)[:, 0]
    if mode == "surf":
        d_same = torch.where((diff == 0) & (sl_i != i0[:, None]), sl_d, inf)
        a3 = first_argmin(d_same, 1)[:, None]
        d3 = torch.take_along_dim(d_same, a3, 1)[:, 0]
        i3 = torch.take_along_dim(sl_i, a3, 1)[:, 0]
    else:
        d3 = inf.expand(Q).clone()
        i3 = torch.zeros(Q, dtype=torch.int64, device=dev)
    return {"d0": d0, "i0": i0, "d2": d2, "i2": i2, "d3": d3, "i3": i3}
