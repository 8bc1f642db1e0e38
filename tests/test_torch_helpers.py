"""The reference's last public helpers in the port, each against the
original on the same seeded numpy inputs (CPU):

- lidar/gridmap.knn_among: distances and neighbours identical to the jitted
  reference (the compiled form, whose sum of squares XLA contracts into
  fused multiply-adds, as the port emulates); against the eager reference,
  which rounds each product and sum, neighbours identical and distances
  within 1e-6 relative. Equal distances (duplicates, SENTINEL slots) keep
  the lower slot first.
- lidar/gridmap.grid_knn on a map built by each package's grid_insert from
  the same points: identical to the reference's (jitted).
- solver/lm.family_cost: the reference's on the same residual blocks
  (linear in delta, so the reference's fn(0) is the port's r), within 1e-6
  relative (the sums run in another order).
- data/synthetic.highway_scene: every field identical to the reference's,
  and scans of it identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.data import synthetic as jsyn
from vloam_tpu.lidar import gridmap as jgm
from vloam_tpu.solver import lm as jlm
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.lidar import gridmap as tgm
from vloam_tpu_torch.solver import lm as tlm

torch.set_num_threads(1)


def _cands(rng, Q=300, C=80):
    cand = rng.uniform(-5, 5, (3, Q, C)).astype(np.float32)
    cand[:, :, 60:] = jgm.SENTINEL
    cand[:, :, 10] = cand[:, :, 3]  # duplicates: equal distances
    q = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    q[:4] = cand[:, :4, 3].T  # queries on the duplicated points
    return cand, q


@pytest.mark.parametrize("k", [5, 1])
def test_knn_among_matches_jax(rng, k):
    cand, q = _cands(rng)
    got = [a.numpy() for a in tgm.knn_among(torch.from_numpy(cand),
                                            torch.from_numpy(q), k)]
    compiled = jax.jit(jgm.knn_among, static_argnums=2)
    for want, exact in ((compiled(jnp.asarray(cand), jnp.asarray(q), k), True),
                        (jgm.knn_among(jnp.asarray(cand), jnp.asarray(q), k),
                         False)):
        d, near = (np.asarray(a) for a in want)
        assert got[0].shape == d.shape == (len(q), k)
        np.testing.assert_array_equal(got[1], near)
        if exact:
            np.testing.assert_array_equal(got[0], d)
        else:
            np.testing.assert_allclose(got[0], d, rtol=1e-6)
    assert (got[0][:4, 0] == 0).all()
    if k == 5:
        assert (got[0][:4, 1] == 0).all()  # the duplicate, next


def test_knn_among_with_few_live_candidates(rng):
    """Fewer live candidates than k: the SENTINEL slots follow in slot
    order, as the reference's top_k returns them."""
    cand, q = _cands(rng, Q=50)
    cand = np.ascontiguousarray(cand[:, :, :8])
    cand[:, :, 4:] = jgm.SENTINEL
    want = jax.jit(jgm.knn_among, static_argnums=2)(jnp.asarray(cand),
                                                    jnp.asarray(q), 5)
    got = tgm.knn_among(torch.from_numpy(cand), torch.from_numpy(q), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grid_knn_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    queries = rng.uniform(-4, 4, (128, 3)).astype(np.float32)
    g = jgm.grid_insert(jgm.grid_create(1 << 12, 32), jnp.asarray(pts),
                        jnp.ones(len(pts), bool), 2.0, 0.05)
    gt = tgm.grid_insert(tgm.grid_create(1 << 12, 32, "cpu"),
                         torch.from_numpy(pts),
                         torch.ones(len(pts), dtype=torch.bool), 2.0, 0.05)
    np.testing.assert_array_equal(gt.pts.numpy(), np.asarray(g.pts))
    want = jgm.grid_knn(g, jnp.asarray(queries), 2.0, k=5)
    got = tgm.grid_knn(gt, torch.from_numpy(queries), 2.0, k=5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[0][:, 4] < 1.0).sum() > 20


def test_family_cost_matches_jax(rng):
    d = 6
    fams_j, fams_t = [], []
    for B, R in ((40, 3), (25, 1)):
        A = rng.normal(0, 1, (B, R, d)).astype(np.float32)
        b = rng.normal(0, 0.3, (B, R)).astype(np.float32)
        b[:5] *= 20.0  # past the Huber threshold
        mask = (rng.random(B) < 0.8).astype(np.float32)
        fams_j.append(jlm.ResidualFamily(
            fn=lambda x, A=jnp.asarray(A), b=jnp.asarray(b): A @ x + b,
            mask=jnp.asarray(mask)))
        fams_t.append(tlm.ResidualFamily(r=torch.from_numpy(b),
                                         J=torch.from_numpy(A),
                                         mask=torch.from_numpy(mask)))
    want = float(jlm.family_cost(fams_j, d, 0.1))
    got = tlm.family_cost(fams_t, 0.1)
    assert got.shape == () and want > 1.0
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    assert tlm.family_cost([], 0.1).item() == 0.0


def test_highway_scene_matches_jax():
    for seed in (0, 3):
        want, got = jsyn.highway_scene(seed), tsyn.highway_scene(seed)
        for f in ("ground_z", "boxes", "poles", "max_range", "tex_scale"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    poses = jsyn.drive_trajectory(2, speed=3.0, yaw_rate=0.0)
    np.testing.assert_array_equal(
        tsyn.simulate_scan_polar(got, poses[1], n_scans=16, n_azimuth=360,
                                 seed=1),
        jsyn.simulate_scan_polar(want, poses[1], n_scans=16, n_azimuth=360,
                                 seed=1))
