"""Parity of the port's scan registration (vloam_tpu_torch.lidar.
scan_registration) with the JAX reference at the tiny test profile.

- Curvature and break prefix: bit-exact on the same per-ring layout (the
  port sums its prefix in the reference's order).
- select_rings_plain (the CPU version of kernel K1) equals the reference's
  Pallas kernel _select_rings_pallas_kernel run in interpret mode, the
  vmapped XLA _select_ring (strict) and tests/np_loam.py::select_ring_np:
  labels identical.
- select_rings_plain on the crafted cases of vloam_tpu_torch/tools/
  kernel_cases.py (a suppression window that crosses a sector's end, equal
  curvatures, short rings, sectors whose candidates run out, curvature at
  the threshold, NaN and zero, ring widths 1800 to 7000) against the vmapped
  strict _select_ring, the Pallas kernel in interpret mode and, where its
  rule is the same, np_loam.select_ring_np: labels identical.
- register_scan and register_scan_polar: labels, masks, ring ids and voxel
  membership exact; points, relative times and slab centroids to 1e-5.
  The polar path runs on each package's own ray directions, which are
  equal bit for bit (tests/test_torch_polar_geometry.py): an ulp in a point
  would move the prefix-sum curvature of its neighbours enough to reorder
  near-tied flat picks.
- The batched selection (strict_sector_order=False), select_rings_batched,
  equals the reference's vmapped batched _select_ring on the layout and on
  every crafted case (labels identical), and register_scan /
  register_scan_polar with it give features as above.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import np_loam
from vloam_tpu.config import ScanRegistrationConfig, tiny_test_profile
from vloam_tpu.data import synthetic
from vloam_tpu.lidar import loam_step as jls
from vloam_tpu.lidar import scan_registration as jsr
from vloam_tpu_torch.lidar import scan_registration as tsr
from vloam_tpu_torch.tools import kernel_cases

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

CFG = tiny_test_profile()
N_AZ = 450


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def frame():
    scene = synthetic.urban_scene(3)
    T = synthetic.drive_trajectory(3, speed=1.0, yaw_rate=0.02)[2]
    img = synthetic.simulate_scan_polar(scene, T, n_scans=16,
                                        n_azimuth=N_AZ, seed=7)
    pts = synthetic.simulate_scan(scene, T, n_scans=16, n_azimuth=N_AZ,
                                  seed=7)
    elev = np.radians(synthetic.hdl64_elevations(16)).astype(np.float32)
    return img, pts, elev


@pytest.fixture(scope="module")
def layout(frame):
    """Real per-ring layout (pts, curv, bf, counts) of one polar frame."""
    img, _, elev = frame
    dirs = tsr.polar_directions(elev, N_AZ, "cpu")
    pts, _, counts = tsr.polar_layout(_t(img.astype(np.int32)), dirs,
                                      CFG.lidar)
    curv = tsr._curvature(pts)
    bf = tsr._break_prefix(pts, CFG.scanreg.neighbor_suppress_gap_sq)
    return pts, curv, bf, counts


def test_curvature_and_break_prefix_bit_exact(layout):
    pts, curv, bf, _ = layout
    pj = jnp.asarray(pts.numpy())
    np.testing.assert_array_equal(
        curv.numpy(), np.asarray(jax.jit(jsr._curvature)(pj)))
    want_bf = jax.jit(jax.vmap(lambda p: jsr._break_prefix(p, 0.05)))(pj)
    np.testing.assert_array_equal(bf.numpy(), np.asarray(want_bf)[:, :N_AZ])


def _pallas_labels(curv, bf, counts, cfg):
    S, R = curv.shape
    return np.asarray(pl.pallas_call(
        partial(jsr._select_rings_pallas_kernel, cfg=cfg),
        out_shape=jax.ShapeDtypeStruct((S, R), jnp.int32),
        interpret=True)(jnp.asarray(curv), jnp.asarray(bf),
                        jnp.asarray(counts)[:, None]))


def test_select_rings_plain_matches_pallas_xla_and_numpy(layout):
    pts, curv, bf, counts = layout
    cfg = CFG.scanreg
    got = tsr.select_rings_plain(curv, bf, counts, cfg).numpy()
    assert (got == 2).sum() > 0 and (got == -1).sum() > 0
    np.testing.assert_array_equal(
        got, _pallas_labels(curv.numpy(), bf.numpy(), counts.numpy(), cfg))
    xla = jax.jit(jax.vmap(lambda p, c, k: jsr._select_ring(p, c, k, cfg)[0]))(
        jnp.asarray(pts.numpy()), jnp.asarray(curv.numpy()),
        jnp.asarray(counts.numpy()))
    np.testing.assert_array_equal(got, np.asarray(xla))
    for s in range(curv.shape[0]):
        want = np_loam.select_ring_np(pts.numpy()[s], curv.numpy()[s],
                                      int(counts[s]))
        np.testing.assert_array_equal(got[s], want)


def test_select_rings_plain_ties_and_short_rings(rng):
    """Quantized curvatures (many exact ties, lowest index wins), random
    gap breaks, and rings too short to select from."""
    cfg = ScanRegistrationConfig(max_less_sharp_per_sector=6,
                                 max_flat_per_sector=3)
    S, R = 16, 200
    curv = (rng.integers(0, 6, (S, R)) * 0.05).astype(np.float32)
    bf = np.cumsum(rng.uniform(size=(S, R)) < 0.1, axis=1).astype(np.int32)
    counts = rng.integers(0, R + 1, S).astype(np.int32)
    counts[:3] = [0, 10, 17]
    got = tsr.select_rings_plain(_t(curv), _t(bf), _t(counts), cfg).numpy()
    np.testing.assert_array_equal(got, _pallas_labels(curv, bf, counts, cfg))
    assert (got[:2] == 0).all()


@pytest.mark.parametrize("case", kernel_cases.select_rings_cases(),
                         ids=lambda c: c.name)
def test_select_rings_plain_crafted_cases(case):
    cfg = ScanRegistrationConfig()
    pts, curv, bf, counts = case.pts, case.curv, case.bf, case.counts
    np.testing.assert_array_equal(
        tsr._break_prefix(_t(pts), cfg.neighbor_suppress_gap_sq).numpy(), bf)
    got = tsr.select_rings_plain(_t(curv), _t(bf), _t(counts), cfg).numpy()
    xla = jax.jit(jax.vmap(lambda p, c, k: jsr._select_ring(p, c, k, cfg)[0]))(
        jnp.asarray(pts), jnp.asarray(curv), jnp.asarray(counts))
    np.testing.assert_array_equal(got, np.asarray(xla))
    np.testing.assert_array_equal(got, _pallas_labels(curv, bf, counts, cfg))
    if case.numpy_rule:
        for s in range(curv.shape[0]):
            want = np_loam.select_ring_np(
                pts[s], curv[s], int(counts[s]),
                thr=np.float32(cfg.curvature_threshold))
            np.testing.assert_array_equal(got[s], want)
    # each case bites, and where the references leave a point open (NaN in
    # np_loam, which also takes equal corners from the highest index down)
    # the plain version's own rule is held: NaN is never a candidate, equal
    # scores go to the lowest index
    sp, ep = kernel_cases.sector_bounds(curv.shape[1], 0)
    if case.name == "window_crosses_sector_end":
        assert got[0, ep] == 2 and (got[0, ep + 1:ep + 6] == 0).all()
        assert got[5, ep] == 2 and got[5, ep + 5] == 2  # a gap between them
    elif case.name == "equal_curvatures":
        assert got[0, sp:sp + 19].tolist() == [2] + [0] * 5 + [2] + [0] * 5 \
            + [1] + [0] * 5 + [1]
        flat = np.flatnonzero(got[1, sp:ep + 1])
        assert flat.tolist() == [0, 6, 12, 18] and (got[1] <= 0).all()
    elif case.name == "ring_lengths":
        assert (got[:3] == 0).all() and (got[3:] != 0).any(axis=1).all()
    elif case.name == "candidates_run_out":
        assert (got[0] <= 0).all() and (got[1] >= 0).all()
        assert np.flatnonzero(got[2]).tolist() == [sp + 3, sp + 100, ep]
        assert np.flatnonzero(got[3]).tolist() == [sp, sp + 50]
        assert np.flatnonzero(got[4]).tolist() == [sp + 25, sp + 31]
    elif case.name == "at_the_threshold":
        assert (got[curv == kernel_cases.THRESHOLD] == 0).all()
        assert (got[0] == 0).all()
    elif case.name == "nan_and_zero":
        assert (got[np.isnan(curv)] == 0).all() and (got[0] == 0).all()
        assert np.flatnonzero(got[1, sp:ep + 1]).tolist() == [0, 6, 12, 18]


def test_select_rings_dispatch_has_no_fallback():
    m = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor required"):
        tsr.select_rings(m, m.to(torch.int32), torch.zeros(
            2, dtype=torch.int32, device="meta"), CFG.scanreg)


def _assert_features_equal(ft, fj):
    """Selected points to 1e-5 m; the less-flat cloud holds voxel centroids,
    held to the voxel filter's 1e-4 m (test_torch_voxel_gridmap.py)."""
    for name in ("sharp", "less_sharp", "flat", "less_flat", "full"):
        a, b = getattr(ft, name), getattr(fj, name)
        tol = 1e-4 if name == "less_flat" else 1e-5
        m = np.asarray(b.mask)
        np.testing.assert_array_equal(a.mask.numpy(), m, err_msg=name)
        np.testing.assert_array_equal(a.ring.numpy()[m], np.asarray(b.ring)[m])
        np.testing.assert_allclose(a.xyz.numpy(), np.asarray(b.xyz),
                                   atol=tol, err_msg=name)
        np.testing.assert_allclose(a.rel_time.numpy(),
                                   np.asarray(b.rel_time), atol=tol)
    for name, tol in (("less_sharp_slab", 1e-5), ("less_flat_slab", 1e-4)):
        np.testing.assert_allclose(getattr(ft, name).xyz.numpy(),
                                   np.asarray(getattr(fj, name).xyz),
                                   atol=tol, rtol=0)


def test_register_scan_matches_jax(frame):
    _, pts, _ = frame
    padded, n = synthetic.pad_scan(pts, CFG.lidar.max_points)
    fj = jsr.register_scan(jnp.asarray(padded), jnp.int32(n), CFG.lidar,
                           CFG.scanreg)
    ft = tsr.register_scan(_t(padded), n, CFG.lidar, CFG.scanreg)
    assert ft.sharp.mask.sum() > 20 and ft.flat.mask.sum() > 20
    _assert_features_equal(ft, fj)


def test_register_scan_polar_matches_jax(frame):
    img, _, elev = frame
    dirs = tsr.polar_directions(elev, N_AZ, "cpu")
    unit = jnp.ones((elev.shape[0], N_AZ), jnp.uint16)  # the JAX table
    np.testing.assert_array_equal(
        dirs.numpy(), np.asarray(jax.jit(jls.polar_to_xyz, static_argnums=2)(
            unit, jnp.asarray(elev), 1.0)).reshape(dirs.shape))
    fj = jsr.register_scan_polar(jnp.asarray(img), jnp.asarray(elev),
                                 CFG.lidar, CFG.scanreg)
    ft = tsr.register_scan_polar(_t(img.astype(np.int32)), dirs,
                                 CFG.lidar, CFG.scanreg)
    _assert_features_equal(ft, fj)


def _xla_batched_labels(pts, curv, counts, cfg):
    return np.asarray(jax.jit(jax.vmap(
        lambda p, c, k: jsr._select_ring(p, c, k, cfg)[0]))(
            jnp.asarray(pts), jnp.asarray(curv), jnp.asarray(counts)))


def test_select_rings_batched_matches_jax(layout):
    pts, curv, bf, counts = layout
    cfg = dataclasses.replace(CFG.scanreg, strict_sector_order=False)
    got = tsr.select_rings_batched(curv, bf, counts, cfg).numpy()
    np.testing.assert_array_equal(got, _xla_batched_labels(
        pts.numpy(), curv.numpy(), counts.numpy(), cfg))
    strict = tsr.select_rings_plain(curv, bf, counts, CFG.scanreg).numpy()
    # the edge effect the reference's docstring names: a few labels move
    assert (got == 2).sum() > 0 and (got == -1).sum() > 0
    assert 0 < (got != strict).sum() < 0.05 * (got != 0).sum()


@pytest.mark.parametrize("case", kernel_cases.select_rings_cases(),
                         ids=lambda c: c.name)
def test_select_rings_batched_crafted_cases(case):
    cfg = ScanRegistrationConfig(strict_sector_order=False)
    got = tsr.select_rings_batched(_t(case.curv), _t(case.bf),
                                   _t(case.counts), cfg).numpy()
    np.testing.assert_array_equal(got, _xla_batched_labels(
        case.pts, case.curv, case.counts, cfg))


def test_register_scan_batched_matches_jax(frame):
    img, pts, elev = frame
    cfg = dataclasses.replace(CFG.scanreg, strict_sector_order=False)
    padded, n = synthetic.pad_scan(pts, CFG.lidar.max_points)
    fj = jsr.register_scan(jnp.asarray(padded), jnp.int32(n), CFG.lidar, cfg)
    ft = tsr.register_scan(_t(padded), n, CFG.lidar, cfg)
    assert ft.sharp.mask.sum() > 20 and ft.flat.mask.sum() > 20
    _assert_features_equal(ft, fj)
    fj = jsr.register_scan_polar(jnp.asarray(img), jnp.asarray(elev),
                                 CFG.lidar, cfg)
    ft = tsr.register_scan_polar(_t(img.astype(np.int32)),
                                 tsr.polar_directions(elev, N_AZ, "cpu"),
                                 CFG.lidar, cfg)
    _assert_features_equal(ft, fj)
