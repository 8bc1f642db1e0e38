"""The port's closed-form eig3 (vloam_tpu_torch/solver/eig3.py) against the
jitted JAX functions (vloam_tpu/solver/eig3.py under jax.jit), which are
what the JAX engines run, on 20,000 seeded 5-point covariances of four
kinds (kernel_cases.eig3_covariances: near-planar, line-like at 5 m and at
0.5 m, isotropic; centred 0-80 m out) and on the corner covariances of one
tiny_test_profile frame's map query.

Neither package rounds as the other: the port divides by 3 and 6 as true
IEEE divisions, and XLA's jitted code multiplies by the reciprocal,
contracts products into fused multiply-adds and has its own arccos. The
closed form turns an ulp of the trace or of p2 into ~1e-4 of the
spectrum's scale on near-degenerate covariances, so the two are held to
what the engines use and to LAPACK instead of to each other:

- every eigenvalue of each package within LAPACK_SHARE of the spectrum's
  scale (its largest |eigenvalue|) of np.linalg.eigvalsh in float64: the
  closed form's own float32 error, at most 1.709e-4 (port) and 1.700e-4
  (JAX, jitted as below; 1.855e-4 with eigvals_sym3 jitted alone) on the
  seeded matrices, 1.10e-4 on the frame's: 1.35x the largest;
- the line decision lams[:, 2] > eigen_ratio * lams[:, 1] (kitti_hdl64's
  eigen_ratio, mapping.corner_geometry's test) identical on every matrix;
- the principal direction u (each package's own from its own largest
  eigenvalue, as the engines take it) within U_TOL of the JAX package's,
  sign-aligned, on every row whose decision is true: the only rows whose u
  an engine uses.

test_torch_geometry_solver.py::test_eig3_matches_jax holds the port to the
JAX function evaluated op by op (1e-5) on its own 256 matrices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.solver import eig3 as jeig3
from vloam_tpu_torch.config import kitti_hdl64, tiny_test_profile
from vloam_tpu_torch.data import synthetic
from vloam_tpu_torch.lidar import mapping as tmap
from vloam_tpu_torch.lidar.loam_step import LoamEngine
from vloam_tpu_torch.lidar.voxel import reciprocal_f32
from vloam_tpu_torch.solver import eig3 as teig3
from vloam_tpu_torch.tools import kernel_cases

torch.set_num_threads(1)

LAPACK_SHARE = 2.5e-4
U_TOL = 1e-4
N_PER_KIND = 5000  # 4 kinds: 20,000 covariances
EIGEN_RATIO = kitti_hdl64().mapping.eigen_ratio


@jax.jit
def _jax_line_test(cov):
    lams = jeig3.eigvals_sym3(cov)
    return lams, jeig3.principal_eigenvector(cov, lams[:, 2])


def _port_line_test(cov: np.ndarray):
    c = torch.from_numpy(cov)
    lams = teig3.eigvals_sym3(c)
    return lams.numpy(), teig3.principal_eigenvector(c, lams[:, 2]).numpy()


def _held(cov: np.ndarray) -> dict:
    """The three checks of the module docstring on cov [n, 3, 3] float32;
    returns what they measured."""
    lt, ut = _port_line_test(cov)
    lj, uj = (np.asarray(x) for x in _jax_line_test(jnp.asarray(cov)))
    ref = np.linalg.eigvalsh(cov.astype(np.float64))
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-30)
    err = {"port": float((np.abs(lt - ref) / scale).max()),
           "jax": float((np.abs(lj - ref) / scale).max())}
    assert err["port"] <= LAPACK_SHARE and err["jax"] <= LAPACK_SHARE, err
    line = lt[:, 2] > EIGEN_RATIO * lt[:, 1]
    flips = np.flatnonzero(line != (lj[:, 2] > EIGEN_RATIO * lj[:, 1]))
    assert flips.size == 0, (flips[:10], lt[flips[:10]], lj[flips[:10]])
    sign = np.sign(np.sum(ut * uj, axis=1, keepdims=True))
    du = np.abs(ut * sign - uj).max(axis=1)[line]
    assert du.size == 0 or du.max() <= U_TOL, du.max()
    return {**err, "lines": int(line.sum()),
            "du": float(du.max()) if du.size else 0.0}


@pytest.mark.parametrize("kind", list(kernel_cases.EIG3_KINDS))
def test_eig3_line_test_matches_jitted_jax(kind):
    cov = kernel_cases.eig3_covariances(kind, N_PER_KIND)
    got = _held(cov)
    # each kind reaches the line test's both sides (isotropic and planar
    # neighbourhoods of 5 points pass it often) or only the side it is made
    # for (a line always passes)
    if kind.startswith("line"):
        assert got["lines"] == N_PER_KIND, got
    else:
        assert 0 < got["lines"] < N_PER_KIND, got


def test_eig3_on_a_frames_corner_covariances(monkeypatch):
    """The covariances corner_geometry forms in the last map query (the last
    LM iteration) of a 3-frame tiny_test_profile polar drive through the
    port's LoamEngine on the CPU, on the rows it fits lines to (k live
    neighbours within the radius)."""
    cfg = tiny_test_profile()
    scene = synthetic.urban_scene(21)
    poses = synthetic.drive_trajectory(3, speed=1.0, yaw_rate=0.02)
    seen = []
    real = tmap.corner_geometry

    def recorder(stack_mask, d, near, cfg_m):
        seen.append((stack_mask, d, near))
        return real(stack_mask, d, near, cfg_m)

    monkeypatch.setattr(tmap, "corner_geometry", recorder)
    eng = LoamEngine(cfg, chunk=3, device="cpu")
    for k, T in enumerate(poses):
        eng.push_polar(synthetic.simulate_scan_polar(
            scene, T, n_scans=16, n_azimuth=360, seed=k))
    eng.finish()
    stack_mask, d, near = seen[-1]
    m = cfg.mapping
    ok = stack_mask & (d[:, m.knn - 1] < m.neighbor_radius_sq)
    dm = near - torch.mean(near, dim=2)[:, :, None]
    cov = (tmap._gram(dm) * reciprocal_f32(m.knn))[ok].numpy()
    assert cov.shape[0] >= 100, cov.shape
    got = _held(cov)
    assert 0 < got["lines"] < cov.shape[0], got
