"""Essential-matrix RANSAC (port of vloam_tpu/vision/ransac.py; the
reference's alternative VO solver, visual_odometry.cpp solveRANSAC
:188-252: cv::findEssentialMat + cv::recoverPose).

Every hypothesis runs at once: H batched 8-point SVDs, then an H x M
Sampson error matrix and one argmax over the inlier counts. The winning E is
decomposed and its fourfold ambiguity resolved by a midpoint-triangulation
cheirality vote. Small matrix products are broadcast products and sums
(so3.matmul), so no TF32 setting reaches them.

The JAX package draws the hypotheses from its threefry stream, which torch
cannot reproduce: estimate_essential_ransac draws them from an explicit
torch.Generator, and essential_ransac_from_samples takes them as an
argument (what the parity tests feed both packages).
"""

from __future__ import annotations

import torch

from ..geometry import so3


def _lift9(x0, x1):
    """Kronecker lifting: rows a with a . vec(E) = x1^T E x0 = 0.
    x0, x1: [..., 2] normalized image coords."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    one = torch.ones_like(u0)
    return torch.stack(
        [u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0, one], dim=-1)


def _essential_from_8(x0, x1):
    """[H, 8, 2] -> [H, 3, 3] essential candidates: the null vector of each
    8 x 9 system (the last row of V^T), projected onto the essential
    manifold (singular values 1, 1, 0)."""
    A = _lift9(x0, x1).to(torch.float64)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    E = vt[:, -1, :].reshape(-1, 3, 3)
    u, _, vt2 = torch.linalg.svd(E)
    return so3.matmul(u[..., :, :2], vt2[..., :2, :]).to(x0.dtype)


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=1)


def _sampson_sq(E, x0, x1):
    """Squared Sampson distance. E [H, 3, 3], x: [M, 2] -> [H, M]."""
    h0, h1 = _homogeneous(x0), _homogeneous(x1)
    Ex0 = torch.sum(E[:, None, :, :] * h0[None, :, None, :], dim=-1)
    Etx1 = torch.sum(E.transpose(1, 2)[:, None, :, :]
                     * h1[None, :, None, :], dim=-1)
    num = torch.sum(h1[None] * Ex0, dim=-1) ** 2
    den = (Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2
           + Etx1[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def _triangulate_depths(R, t, x0, x1):
    """Midpoint depths for cheirality: z0 R f0 + t = z1 f1 in least
    squares per point; returns (z0, z1) [M]."""
    f0, f1 = _homogeneous(x0), _homogeneous(x1)
    Rf0 = torch.sum(f0[:, None, :] * R[None, :, :], dim=-1)  # R f0
    a = torch.sum(Rf0 * Rf0, dim=1)
    b = -torch.sum(Rf0 * f1, dim=1)
    c = torch.sum(f1 * f1, dim=1)
    tb0 = torch.sum(Rf0 * t, dim=1)
    tb1 = torch.sum(f1 * t, dim=1)
    det = torch.clamp(a * c - b * b, min=1e-12)
    return (-c * tb0 - b * tb1) / det, (b * tb0 + a * tb1) / det


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without reading it to the host."""
    return x.index_select(0, i.reshape(1))[0]


def essential_ransac_from_samples(idx, x0_bar, x1_bar, valid,
                                  thresh: float = 1e-5):
    """RANSAC on given minimal samples idx [H, 8] (indices into the M
    correspondences x0_bar, x1_bar [M, 2], valid [M]). Returns (q [4],
    t_unit [3], inlier_mask [M], n_inliers): the relative pose with R, t
    such that x1 ~ R x0 + t (translation up to scale)."""
    E = _essential_from_8(x0_bar[idx], x1_bar[idx])
    err = _sampson_sq(E, x0_bar, x1_bar)  # [H, M]
    inl = (err < thresh) & valid[None, :]
    scores = torch.sum(inl.to(torch.int32), dim=1)
    best = torch.argmax(scores)  # first maximum, as jnp.argmax
    inlier_mask = _pick(inl, best)

    # decompose: four (R, t) candidates, proper rotations
    u, _, vt = torch.linalg.svd(_pick(E, best).to(torch.float64))
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    W = u.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = so3.matmul(so3.matmul(u, W), vt)
    R2 = so3.matmul(so3.matmul(u, W.T), vt)
    tt = u[:, 2]
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([tt, -tt, tt, -tt])
    votes = []
    for R, t in zip(Rs, ts):
        z0, z1 = _triangulate_depths(R, t, x0_bar, x1_bar)
        votes.append(torch.sum((z0 > 0) & (z1 > 0) & inlier_mask))
    k = torch.argmax(torch.stack(votes))
    q = so3.quat_from_matrix(_pick(Rs, k))
    return (q.to(x0_bar.dtype), _pick(ts, k).to(x0_bar.dtype), inlier_mask,
            _pick(scores, best))


def estimate_essential_ransac(x0_bar, x1_bar, valid,
                              generator: torch.Generator, n_hyp: int = 256,
                              thresh: float = 1e-5):
    """Draw n_hyp minimal samples of 8 valid correspondences, uniformly with
    replacement (as jax.random.choice with p), from `generator` (on the
    device of x0_bar), and run essential_ransac_from_samples on them."""
    w = valid.to(torch.float32)
    p = w / torch.clamp(torch.sum(w), min=1.0)
    idx = torch.multinomial(p, n_hyp * 8, replacement=True,
                            generator=generator).reshape(n_hyp, 8)
    return essential_ransac_from_samples(idx, x0_bar, x1_bar, valid, thresh)
