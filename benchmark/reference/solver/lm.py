"""Batched Huber-IRLS Levenberg-Marquardt on small states (port of
vloam_tpu/solver/lm.py).

- a residual family is a batch of residual blocks linearized at the local
  perturbation delta = 0 of the state: residuals [B, R] and their closed-form
  Jacobian [B, R, d]. The JAX reference differentiates the residual function
  with jacfwd; the port's families compute the same Jacobian in closed form
  (tests/test_torch_geometry_solver.py holds them equal to torch.func.jacfwd),
  which takes a fraction of forward-mode AD's kernel launches (PERF.md),
- the Huber loss enters as per-block IRLS weights w = rho'(||r||^2),
- the normal equations are elementwise products and sums, not matmuls, so
  no TF32 or reduced-precision matmul setting can change them on CUDA,
- they are Jacobi-preconditioned and solved in f32,
- the LM loop is a fixed-trip Python loop whose accept/reject updates are
  ``torch.where`` selects: nothing in it reads a value back to the host, so
  on CUDA the whole solve is queued without a synchronization,
- every function takes optional leading stream axes: families [..., B, R],
  states [..., d], and H [..., d, d], g [..., d], cost, lambda and accept
  [...] per stream (the batch engine's counterpart of the reference's
  batch_mapping._lm_solve_batched; its streams never share a reduction).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def huber_weight(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight rho'(s) for Ceres HuberLoss(delta): rho(s) = s for
    s <= delta^2 else 2 delta sqrt(s) - delta^2."""
    d2 = delta * delta
    safe = torch.clamp(sq_norm, min=1e-20)
    return torch.where(sq_norm <= d2, 1.0, delta / torch.sqrt(safe))


def huber_cost(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    d2 = delta * delta
    safe = torch.clamp(sq_norm, min=1e-20)
    return torch.where(sq_norm <= d2, sq_norm,
                       2.0 * delta * torch.sqrt(safe) - d2)


class ResidualFamily(NamedTuple):
    """A batch of residual blocks of equal shape, linearized at delta = 0.

    r: [..., B, R] residuals (masked rows should still be finite)
    J: [..., B, R, d] Jacobian of r with respect to the local perturbation
       delta
    mask: [..., B] validity of each block (float or bool)
    """

    r: torch.Tensor
    J: torch.Tensor
    mask: torch.Tensor


def normal_equations(fam: ResidualFamily, huber_delta: float):
    """H [..., d, d], g [..., d] and the Huber cost [...] of one family at
    delta = 0, summed over its blocks and residual rows."""
    mask = fam.mask.to(torch.float32)
    sq = torch.sum(fam.r * fam.r, dim=-1)
    Jw = fam.J * (huber_weight(sq, huber_delta) * mask)[..., None, None]
    H = torch.sum(Jw[..., :, None] * fam.J[..., None, :], dim=(-4, -3))
    g = torch.sum(Jw * fam.r[..., None], dim=(-3, -2))
    cost = torch.sum(huber_cost(sq, huber_delta) * mask, dim=-1)
    return H, g, cost


def solve_damped(H: torch.Tensor, g: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """Jacobi-preconditioned damped solve: (H + lam*diag(H)) x = g.

    The JAX reference factors the scaled system with a scalar-unrolled
    Cholesky (lm.py:82-115), which XLA fuses into one kernel; in eager
    PyTorch each scalar step would be a kernel launch (~100 per solve), so
    the port uses one pivoted LU solve. The scaled matrix is SPD with unit
    diagonal plus lam, so both give the same step up to rounding; solve_ex
    does not check for singularity, so nothing waits on the device."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                               min=1e-12))
    Hs = H / (d[..., :, None] * d[..., None, :])
    Hs = Hs + (lam + 1e-8)[..., None, None] * torch.eye(
        H.shape[-1], dtype=H.dtype, device=H.device)
    gs = g / d
    x, _ = torch.linalg.solve_ex(Hs, gs[..., None])
    return x[..., 0] / d


def lm_solve(
    make_family: Callable[[torch.Tensor], ResidualFamily],
    retract: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    iterations: int,
    huber_delta: float,
    init_lambda: float = 1e-4,
    reduce: Callable | None = None,
) -> torch.Tensor:
    """Run `iterations` LM steps. `make_family(x)` linearizes the residuals
    at x in the local delta around x; `retract(x, delta)` applies the local
    step. reduce(H, g, cost), where given, maps each evaluation's normal
    equations to their sums over a mesh (parallel/sharded.py: the reference's
    psum'd LM, sharded_mapping.py:168-185), so every rank takes the same
    branch.

    (H, g, cost) are computed at the TRIAL point and carried: an accepted
    step's normal equations are reused as the next linearization, a rejected
    step keeps the carried ones — the same accept/reject trajectory and
    lambda schedule as the JAX reference (lm.py:157-170)."""
    def evaluate(x):
        ne = normal_equations(make_family(x), huber_delta)
        return ne if reduce is None else reduce(*ne)

    H, g, cost = evaluate(x0)
    x = x0
    lam = torch.full(x0.shape[:-1], init_lambda, dtype=torch.float32,
                     device=x0.device)
    for _ in range(iterations):
        delta = solve_damped(H, g, lam)
        x_try = retract(x, -delta)
        H_t, g_t, cost_t = evaluate(x_try)
        accept = cost_t < cost
        x = torch.where(accept[..., None], x_try, x)
        H = torch.where(accept[..., None, None], H_t, H)
        g = torch.where(accept[..., None], g_t, g)
        cost = torch.where(accept, cost_t, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-7),
                          torch.clamp(lam * 8.0, max=1e2))
    return x
