"""Closed-form batched symmetric 3x3 eigendecomposition (port of
vloam_tpu/solver/eig3.py): the trigonometric eigenvalue formula plus a
cross-product eigenvector recovery — branchless, no LAPACK, no iteration,
so the mapping stage's per-corner covariance test launches a fixed handful
of elementwise kernels and never synchronizes with the host.

Its three divisions by constants (by 3, 6 and 3) are true IEEE divisions on
every device, where the port's other divisions by constants multiply by the
float32 reciprocal as XLA does (``voxel.reciprocal_f32``). On CUDA a Python
divisor would not do: ATen multiplies by its float32 reciprocal, so the card
would run another formula than the CPU. The divisors are 0-dim tensors on
the operand's device instead, made once per device and dtype. Products on
both devices would not round as the JAX package does either: the closed form
turns an ulp of the trace or of p2 into ~1e-4 of the spectrum's scale on
near-degenerate covariances, so the product form misses the JAX function
evaluated op by op (tests/test_torch_geometry_solver.py, 1e-5) by 1.15e-4,
and comes no closer than the division form to the jitted JAX function, which
the engines run. tests/test_torch_eig3.py holds both packages' eigenvalues
to LAPACK, and the port's line decisions and directions to the jitted JAX
package's.
"""

from __future__ import annotations

import functools
import math

import torch

from ..geometry.so3 import cross, unit_vector

_EPS = 1e-12


@functools.cache
def _divisors(device: torch.device, dtype: torch.dtype):
    """3 and 6 as 0-dim tensors on `device`. The first call on a device
    copies them there and waits for the copy: an engine makes it in its
    first (warm-up) frame, before any timed or graph-captured one."""
    return tuple(torch.tensor(v, dtype=dtype, device=device)
                 for v in (3.0, 6.0))


def eigvals_sym3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], ascending [l0 <= l1 <= l2]."""
    three, six = _divisors(A.device, A.dtype)
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / three
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    p = torch.sqrt(torch.clamp(p2 / six, min=_EPS))
    # det(B)/2 with B = (A - qI)/p
    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    det_b = b00 * c00 - a01 * c01 + a02 * c02
    r = det_b / (2.0 * p * p * p)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / three
    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l1 = 3.0 * q - l0 - l2
    return torch.stack([l0, l1, l2], dim=-1)


def principal_eigenvector(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric [..., 3, 3] for eigenvalue lam [...]:
    the kernel of (A - lam I), found as the largest cross product of its rows
    (rows of a rank-2 matrix span the orthogonal complement of the kernel)."""
    B = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    cands = torch.stack([cross(r0, r1), cross(r1, r2), cross(r2, r0)],
                        dim=-2)  # [..., 3, 3]
    norms = torch.sum(cands * cands, dim=-1)  # [..., 3]
    best = torch.argmax(norms, dim=-1)  # first maximum, as jnp.argmax
    v = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    # Degenerate (isotropic) case: fall back to e_x; callers gate on the
    # eigenvalue ratio anyway.
    fallback = unit_vector(3, 0, A.device)
    return torch.where(norm > 1e-9, v / torch.clamp(norm, min=_EPS), fallback)
