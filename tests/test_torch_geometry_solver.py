"""Parity of the PyTorch port's geometry and solver modules with the JAX
reference (vloam_tpu.geometry.so3, vloam_tpu.solver.eig3/lm) on the same
numpy inputs made from a seed.

Tolerances: so3 to 1e-6 (float32 elementwise formulas, transcendental
functions may differ by an ulp); eig3 eigenvalues to 1e-5 relative to the
spectrum scale and eigenvectors to 1e-4 up to sign; LM solutions to 1e-5
with an identical accept/reject sequence (normal-equation sums add in a
different order, so only rounding differs). The port linearizes in closed
form where the reference uses jacfwd: its float32 Jacobians equal
torch.func.jacfwd's, taken in float64, to 2e-5 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.geometry import so3 as jso3
from vloam_tpu.solver import eig3 as jeig3
from vloam_tpu.solver import lm as jlm
from vloam_tpu_torch.geometry import so3 as tso3
from vloam_tpu_torch.solver import eig3 as teig3
from vloam_tpu_torch.solver import lm as tlm

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture
def quats(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.uniform(-50, 50, (64, 3)).astype(np.float32)
    # include tiny angles (series branch) and large ones
    aa = np.concatenate([rng.normal(0, 1.0, (48, 3)),
                         rng.normal(0, 1e-5, (16, 3))]).astype(np.float32)
    return q, v, aa


@pytest.mark.parametrize("name", ["quat_normalize", "quat_multiply",
                                  "quat_conjugate", "quat_rotate",
                                  "quat_from_axis_angle",
                                  "axis_angle_from_quat"])
def test_so3_matches_jax(quats, name):
    q, v, aa = quats
    q2 = np.roll(q, 1, axis=0)
    args = {"quat_normalize": (q * 3.0,), "quat_multiply": (q, q2),
            "quat_conjugate": (q,), "quat_rotate": (q, v),
            "quat_from_axis_angle": (aa,),
            "axis_angle_from_quat": (np.concatenate([q, -q[:8]]),)}[name]
    want = np.asarray(getattr(jso3, name)(*map(jnp.asarray, args)))
    got = getattr(tso3, name)(*map(_t, args)).numpy()
    scale = 50.0 if name == "quat_rotate" else 1.0
    np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=0)


def test_so3_batched_broadcast(quats):
    q, v, _ = quats
    got = tso3.quat_rotate(_t(q[0]), _t(v)).numpy()
    want = np.asarray(jso3.quat_rotate(jnp.asarray(q[0]), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_eig3_matches_jax(rng):
    pts = rng.normal(size=(256, 5, 3)).astype(np.float32)
    pts[:64, :, 2] *= 1e-3  # near-planar
    pts[64:128] *= np.array([5.0, 0.1, 0.1], np.float32)  # line-like
    c = pts - pts.mean(1, keepdims=True)
    cov = np.einsum("qki,qkj->qij", c, c) / 5.0
    lj = np.asarray(jeig3.eigvals_sym3(jnp.asarray(cov)))
    lt = teig3.eigvals_sym3(_t(cov)).numpy()
    scale = np.abs(lj).max(axis=1, keepdims=True)
    np.testing.assert_allclose(lt / scale, lj / scale, atol=1e-5)
    # sanity against LAPACK: the closed form itself (in both packages) loses
    # ~1e-4 of the spectrum scale on the small eigenvalues
    np.testing.assert_allclose(lt / scale, np.linalg.eigvalsh(cov) / scale,
                               atol=5e-4)
    uj = np.asarray(jeig3.principal_eigenvector(jnp.asarray(cov),
                                                jnp.asarray(lj[:, 2])))
    ut = teig3.principal_eigenvector(_t(cov), _t(lj[:, 2])).numpy()
    sign = np.sign(np.sum(uj * ut, axis=1, keepdims=True))
    np.testing.assert_allclose(ut * sign, uj, atol=1e-4)


def _alignment_problem(rng, n=400):
    """Point-to-point alignment with 10% gross outliers (Huber matters)."""
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    aa = np.array([0.05, -0.08, 0.3], np.float32)
    R = np.asarray(jso3.quat_to_matrix(jso3.quat_from_axis_angle(
        jnp.asarray(aa))))
    dst = src @ R.T + np.array([1.5, -0.7, 0.2], np.float32)
    dst += rng.normal(0, 0.02, dst.shape).astype(np.float32)
    out = rng.uniform(size=n) < 0.1
    dst[out] += rng.normal(0, 3.0, (out.sum(), 3)).astype(np.float32)
    mask = (rng.uniform(size=n) < 0.95).astype(np.float32)
    return src, dst.astype(np.float32), mask


def _jax_family(src, dst, mask):
    """The JAX reference's form: a residual function of delta (jacfwd)."""
    def make(x):
        def fn(delta):
            q = jso3.quat_multiply(x[:4], jso3.quat_from_axis_angle(delta[:3]))
            return jso3.quat_rotate(q, src) + x[4:] + delta[3:] - dst
        return [jlm.ResidualFamily(fn, mask)]

    def retract(x, delta):
        q = jso3.quat_normalize(jso3.quat_multiply(
            x[:4], jso3.quat_from_axis_angle(delta[:3])))
        return jnp.concatenate([q, x[4:] + delta[3:]])
    return make, retract


def _torch_family(src, dst, mask):
    """The port's form: residuals and their closed-form Jacobian at x."""
    def make(x):
        rp = tso3.quat_rotate(x[:4], src)
        return tlm.ResidualFamily(rp + x[4:] - dst,
                                  tso3.point_jacobian(x[:4], rp), mask)

    def retract(x, delta):
        q = tso3.quat_normalize(tso3.quat_multiply(
            x[:4], tso3.quat_from_axis_angle(delta[:3])))
        return torch.cat([q, x[4:] + delta[3:]])
    return make, retract


def test_normal_equations_match_jax(rng):
    src, dst, mask = _alignment_problem(rng)
    x0 = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
    jm, _ = _jax_family(*map(jnp.asarray, (src, dst, mask)))
    tm, _ = _torch_family(*map(_t, (src, dst, mask)))
    Hj, gj, cj = jlm.normal_equations(jm(jnp.asarray(x0)), 6, 0.1)
    Ht, gt, ct = tlm.normal_equations(tm(_t(x0)), 0.1)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)


def test_lm_solve_matches_jax_with_same_accept_pattern(rng):
    src, dst, mask = _alignment_problem(rng)
    x0 = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
    jm, jr = _jax_family(*map(jnp.asarray, (src, dst, mask)))
    tm, tr = _torch_family(*map(_t, (src, dst, mask)))
    xs_j, xs_t = [x0], [x0]
    for it in range(1, 9):
        xs_j.append(np.asarray(jax.jit(lambda x, it=it: jlm.lm_solve(
            jm, jr, x, dim=6, iterations=it, huber_delta=0.1))(
                jnp.asarray(x0))))
        xs_t.append(tlm.lm_solve(tm, tr, _t(x0), iterations=it,
                                 huber_delta=0.1).numpy())
        np.testing.assert_allclose(xs_t[-1], xs_j[-1], atol=1e-5)
    # an iteration accepted its step iff x moved
    acc_j = [not np.array_equal(a, b) for a, b in zip(xs_j, xs_j[1:])]
    acc_t = [not np.array_equal(a, b) for a, b in zip(xs_t, xs_t[1:])]
    assert acc_t == acc_j
    assert acc_t[0]


def test_solve_damped_matches_unrolled_cholesky(rng):
    for _ in range(5):
        A = rng.normal(size=(6, 6)).astype(np.float32)
        H = A @ A.T + 0.1 * np.eye(6, dtype=np.float32)
        g = rng.normal(size=6).astype(np.float32)
        want = np.asarray(jlm.solve_damped(jnp.asarray(H), jnp.asarray(g),
                                           jnp.float32(1e-3)))
        got = tlm.solve_damped(_t(H), _t(g), torch.tensor(1e-3)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def _perturbed(q, t, d):
    """(q ⊗ exp(omega), t + tau) for the local perturbation d = (omega, tau)."""
    return (tso3.quat_multiply(q, tso3.quat_from_axis_angle(d[:3])),
            t + d[3:])


def _jacfwd64(fn, *args):
    """torch.func.jacfwd of fn(d, *args) at d = 0, in float64: the exact
    derivative that the float32 closed forms are held to (forward mode in
    float32 through the log map also promotes some tangents to float64)."""
    from torch.func import jacfwd

    args = [a.double() if a.is_floating_point() else a for a in args]
    return jacfwd(lambda d: fn(d, *args))(
        torch.zeros(6, dtype=torch.float64)).numpy()


@pytest.mark.parametrize("angle", [0.0, 1e-4, 0.01, 0.3, 0.6, 2.5])
def test_transform_to_start_jac_equals_jacfwd(rng, angle):
    """LO's closed-form point Jacobian, with deskew (per-point slerp
    fractions s in [0, 1], through J_r and J_r^-1 of SO(3)) and without,
    equals the float64 jacfwd of _transform_to_start, across the series and
    closed-form branches of the coefficients; the points are identical."""
    from vloam_tpu_torch.lidar.odometry import (_transform_to_start,
                                                transform_to_start_jac)

    B = 200
    pts = _t(rng.uniform(-40, 40, (B, 3)).astype(np.float32))
    axis = rng.normal(size=3)
    q = tso3.quat_from_axis_angle(
        _t((axis / np.linalg.norm(axis) * angle).astype(np.float32)))
    t = _t(rng.normal(size=3).astype(np.float32))
    s = _t(rng.uniform(0, 1, (B, 1)).astype(np.float32))
    s[:2] = torch.tensor([[0.0], [1.0]])

    def fn(d, q, t, pts, *frac):
        return _transform_to_start(*_perturbed(q, t, d), pts,
                                   frac[0] if frac else None)

    for frac in ((), (s,)):
        lp, J = transform_to_start_jac(q, t, pts, *frac or (None,))
        np.testing.assert_array_equal(
            lp.numpy(), fn(torch.zeros(6), q, t, pts, *frac).numpy())
        Jf = _jacfwd64(fn, q, t, pts, *frac)
        np.testing.assert_allclose(J.numpy(), Jf, rtol=0,
                                   atol=2e-5 * np.abs(Jf).max())


@pytest.mark.parametrize("which", ["lo", "lo_deskew", "mo"])
def test_analytic_linearization_equals_jacfwd(rng, which):
    """The LO/MO residual families' closed-form Jacobians (the port's only
    linearization; the JAX reference uses jacfwd) equal the float64 jacfwd
    of the same residual function to 2e-5 of the Jacobian scale; the
    residuals are identical."""
    from vloam_tpu_torch.lidar.mapping import mo_families, mo_residual
    from vloam_tpu_torch.lidar.odometry import (_transform_to_start,
                                                lo_families, lo_residual)

    B, Bc = 300, 120
    f = lambda *s: _t(rng.normal(size=s).astype(np.float32))  # noqa: E731
    cp = f(B, 3) * 20
    is_edge = (torch.arange(B) < Bc)[:, None]
    A, Bp = cp + f(B, 3), cp + f(B, 3)
    DE = torch.linalg.norm(A - Bp, dim=-1)
    NH = torch.nn.functional.normalize(f(B, 3), dim=-1)
    PJ = cp + f(B, 3) * 0.1
    NOOD = f(B)
    w = (torch.rand(B) < 0.8).to(torch.float32)
    q = tso3.quat_normalize(torch.tensor([0.0, 0.0, 0.0, 1.0]) + 0.05 * f(4))
    x = torch.cat([q, f(3)])
    if which == "mo":
        fam = mo_families(cp, is_edge, A, Bp, DE, NH, NOOD, w)(x)

        def fn(d, x, cp, A, Bp, DE, NH, NOOD):
            qd, td = _perturbed(x[:4], x[4:], d)
            return mo_residual(tso3.quat_rotate(qd, cp) + td, is_edge, A, Bp,
                               DE, NH, NOOD)
        args = (x, cp, A, Bp, DE, NH, NOOD)
    else:
        s = torch.rand(B, 1) if which == "lo_deskew" else None
        fam = lo_families(cp, is_edge, A, Bp, DE, PJ, NH, w, s)(x)

        def fn(d, x, cp, A, Bp, DE, PJ, NH, *frac):
            return lo_residual(_transform_to_start(
                *_perturbed(x[:4], x[4:], d), cp, frac[0] if frac else None),
                is_edge, A, Bp, DE, PJ, NH)
        args = (x, cp, A, Bp, DE, PJ, NH) + (() if s is None else (s,))
    np.testing.assert_array_equal(fam.r.numpy(),
                                  fn(torch.zeros(6), *args).numpy())
    assert fam.mask is w
    Jf = _jacfwd64(fn, *args)
    np.testing.assert_allclose(fam.J.numpy(), Jf, rtol=0,
                               atol=2e-5 * np.abs(Jf).max())
