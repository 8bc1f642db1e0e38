"""Parity of the port's voxel filters and hashed cell-slab map with the JAX
reference (vloam_tpu.lidar.voxel / gridmap) on the same numpy inputs.

Tolerances: hashes, voxel membership, voxel counts, partition ids and map
contents are exact (bit-for-bit); voxel centroids agree to 1e-4 m (the
reference's own prefix-sum bound, voxel.py:53-55; the port adds in the same
order, so it is usually exact); k-NN distances to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.config import LaserMappingConfig
from vloam_tpu.lidar import batch_mapping as jbm
from vloam_tpu.lidar import gridmap as jg
from vloam_tpu.lidar import voxel as jv
from vloam_tpu_torch.lidar import batch_mapping as tbm
from vloam_tpu_torch.lidar import gridmap as tg
from vloam_tpu_torch.lidar import voxel as tv
from vloam_tpu_torch.tools import kernel_cases

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

I32 = np.iinfo(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _coords(rng, n=4096):
    c = rng.integers(-5000, 5000, (n, 3)).astype(np.int32)
    c[:8] = [[I32.max, I32.min, 0], [I32.min, I32.max, -1],
             [-1, -1, -1], [0, 0, 0], [I32.max] * 3, [I32.min] * 3,
             [123456789, -987654321, 2**30], [-2**30, 7, -7]]
    return c


def test_voxel_hash_bit_exact(rng):
    c = _coords(rng)
    part = rng.integers(0, 64, len(c)).astype(np.int32)
    part[:3] = [I32.max, -1, 0]
    want = np.asarray(jax.jit(jv._hash_cells)(*(jnp.asarray(c[:, i])
                                                for i in range(3)),
                                              jnp.asarray(part)))
    got = tv._hash_cells(*(_t(c[:, i]) for i in range(3)), _t(part))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n_buckets", [1 << 13, 1 << 17])
def test_map_hash_bit_exact(rng, n_buckets):
    c = _coords(rng)
    want = np.asarray(jax.jit(jg._hash_cell, static_argnums=3)(
        *(jnp.asarray(c[:, i]) for i in range(3)), n_buckets))
    got = tg._hash_cell(*(_t(c[:, i]) for i in range(3)), n_buckets)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _cloud(rng, n=3000):
    """Clustered points (many share voxels) with a few far ones."""
    centers = rng.uniform(-60, 60, (200, 3))
    pts = centers[rng.integers(0, 200, n)] + rng.normal(0, 0.3, (n, 3))
    pts[:10] *= 2.0  # far returns at ~120 m, the sensor scale
    mask = rng.uniform(size=n) < 0.9
    return pts.astype(np.float32), mask


@pytest.mark.parametrize("out_cap", [512, 4096])
def test_voxel_downsample_matches_jax(rng, out_cap):
    pts, mask = _cloud(rng)
    part = rng.integers(0, 3, len(pts)).astype(np.int32)
    extra = rng.uniform(size=(len(pts), 2)).astype(np.float32)
    jx, je, jp, jm = jax.jit(jv.voxel_downsample, static_argnums=(2, 3))(
        jnp.asarray(pts), jnp.asarray(mask), 0.4, out_cap,
        jnp.asarray(part), jnp.asarray(extra))
    tx, te, tp, tm = tv.voxel_downsample(_t(pts), _t(mask), 0.4, out_cap,
                                         _t(part), _t(extra))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tm.sum()) == int(np.asarray(jm).sum())
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # Centroids are differences of f32 prefix sums of mean-centred
    # coordinates. The two packages add the prefix sums in the same order
    # but take the mean with different reduction trees, so the sums can
    # round one ulp apart: at this cloud's prefix magnitude (~2e3 m) that
    # is 2.4e-4 m, above the reference's 1e-4 m estimate for smaller clouds.
    live = pts[mask]
    scale = np.abs(np.cumsum(live - live.mean(0), axis=0)).max()
    atol = max(1e-4, 2 * float(np.spacing(np.float32(scale))))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=atol)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4)
    # and both are the exact per-voxel means to that tolerance
    cell = np.floor(pts / 0.4).astype(np.int64)
    for i in np.flatnonzero(np.asarray(jm))[:64]:
        c = np.floor(np.asarray(jx)[i] / 0.4).astype(np.int64)
        sel = mask & np.all(cell == c, axis=1) & (part == int(tp[i]))
        np.testing.assert_allclose(tx.numpy()[i], pts[sel].mean(0),
                                   atol=atol)


def test_voxel_downsample_rows_slab_matches_jax(rng):
    S, R = 8, 300
    pts = np.cumsum(rng.normal(0, 0.15, (S, R, 3)), axis=1).astype(np.float32)
    pts += rng.uniform(-40, 40, (S, 1, 3)).astype(np.float32)
    mask = rng.uniform(size=(S, R)) < 0.8
    extra = rng.uniform(size=(S, R, 1)).astype(np.float32)
    for cap in (32, 512):
        jx, je, jm = jax.jit(jv.voxel_downsample_rows_slab,
                             static_argnums=(2, 3))(
            jnp.asarray(pts), jnp.asarray(mask), 0.2, cap, jnp.asarray(extra))
        tx, te, tm = tv.voxel_downsample_rows_slab(_t(pts), _t(mask), 0.2,
                                                   cap, _t(extra))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4)


def test_blocked_cumsum_adds_in_xla_order(rng):
    for shape, axis in (((2049,), 0), ((5, 700, 3), 1), ((16,), 0)):
        x = rng.normal(0, 30, shape).astype(np.float32)
        want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=axis))(x))
        np.testing.assert_array_equal(
            tv.blocked_cumsum(_t(x), axis).numpy(), want)


def _grid_pair(nb=1 << 10, cap=8):
    return jg.grid_create(nb, cap), tg.grid_create(nb, cap, "cpu")


def _insert_both(gj, gt, p, m, cell=2.0, res=0.4):
    gj = jg.grid_insert(gj, jnp.asarray(p), jnp.asarray(m), cell, res)
    gt = tg.grid_insert(gt, _t(p), _t(m), cell, res)
    return gj, gt


def _assert_grid_equal(gj, gt):
    np.testing.assert_array_equal(gt.pts.numpy(), np.asarray(gj.pts))
    assert int(gt.n_live) == int(gj.n_live)


def test_grid_insert_and_evict_match_jax(rng):
    gj, gt = _grid_pair()
    for k in range(4):
        # dense clusters overfill buckets; repeats exercise the voxel dedup
        c = rng.uniform(-30, 30, (40, 3))
        p = (c[rng.integers(0, 40, 1500)]
             + rng.normal(0, 0.5, (1500, 3))).astype(np.float32)
        m = rng.uniform(size=1500) < 0.9
        gj, gt = _insert_both(gj, gt, p, m)
        _assert_grid_equal(gj, gt)
    center = np.array([5.0, -3.0, 0.0], np.float32)
    radius = np.array([20.0, 25.0, 10.0], np.float32)
    gj = jg.grid_evict(gj, jnp.asarray(center), jnp.asarray(radius))
    gt = tg.grid_evict(gt, _t(center), _t(radius))
    _assert_grid_equal(gj, gt)
    # inserts after an evict refill the holes identically
    p = rng.uniform(-30, 30, (800, 3)).astype(np.float32)
    gj, gt = _insert_both(gj, gt, p, np.ones(800, bool))
    _assert_grid_equal(gj, gt)


def test_grid_gather_and_knn_match_jax(rng):
    gj, gt = _grid_pair()
    p = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    gj, gt = _insert_both(gj, gt, p, np.ones(3000, bool))
    q = (p[rng.integers(0, 3000, 256)]
         + rng.normal(0, 0.3, (256, 3))).astype(np.float32)
    cj = jg.grid_gather(gj, jnp.asarray(q), 2.0)
    ct = tg.grid_gather_plain(gt, _t(q), 2.0)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    for got in tg.grid_gather_pair(gt, _t(q), 2.0, gt, _t(q), 2.0):
        assert torch.equal(got, ct)
    dj, nj = jg.knn_among_planar(cj, jnp.asarray(q), k=5)
    dt, nt = tg.knn_among_planar(ct, _t(q), k=5)
    dj, nj = np.asarray(dj), np.asarray(nj)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5)
    # neighbours inside the 1 m gate are the same points (slot order among
    # exactly equal sentinel distances may differ)
    gate = dj < 1.0
    np.testing.assert_array_equal(nt.numpy()[:, gate], nj[:, gate])


@pytest.mark.parametrize(
    "case", [c for c in kernel_cases.grid_probe_cases() if c.n_streams == 1],
    ids=lambda c: c.name)
def test_grid_gather_pair_matches_jax(case):
    """Both grids' probe candidates through grid_gather_pair (on the CPU:
    grid_gather_plain) equal the JAX grid_gather's bit for bit, at the
    engines' bucket capacities and cells: both signs, queries at cell
    midpoints and on borders, an empty job, all-SENTINEL rows."""
    grids, args = [], []
    for table, q, cell in case.jobs:
        gj = jg.FeatureGrid(pts=jnp.asarray(table),
                            n_live=jnp.zeros((), jnp.int32))
        want = np.asarray(jg.grid_gather(gj, jnp.asarray(q), cell))
        grids.append(want)
        args += [tg.FeatureGrid(pts=_t(table),
                                n_live=torch.zeros((), dtype=torch.int32)),
                 _t(q), cell]
    got = tg.grid_gather_pair(*args)
    for g, w, (table, q, _) in zip(got, grids, case.jobs):
        assert g.shape == w.shape == (3, len(q), 8 * table.shape[1] // 3)
        np.testing.assert_array_equal(g.numpy(), w)
    if case.name == "sentinel_rows":
        assert (grids[0] == tg.SENTINEL).mean() > 0.8


def test_probe_buckets_follow_the_reference_cell(rng):
    """A query's cell is floor(q * float32(1 / cell)), as XLA computes the
    reference's q / cell: on queries where that differs from an IEEE
    division, the buckets follow the product."""
    cell = 2.4
    q = rng.uniform(-300, 300, (200000, 3)).astype(np.float32)
    inv = np.float32(1) / np.float32(cell)
    by_mul = np.floor(q * inv)
    by_div = np.floor(q / np.float32(cell))
    differ = (by_mul != by_div).any(1)
    assert differ.sum() > 0
    q = q[differ]
    want = np.asarray(jax.jit(jg._bucket_of, static_argnums=(1, 2))(
        jnp.asarray(q), cell, 1 << 17))
    got = tg._bucket_of(_t(q), cell, 1 << 17)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    c = by_mul[differ].astype(np.int32)
    np.testing.assert_array_equal(
        got.numpy(), tg._hash_cell(*(_t(c[:, i]) for i in range(3)),
                                   1 << 17).numpy())


def test_grid_gather_pair_dispatch_has_no_fallback():
    """Only CPU tensors take the plain version; anything else goes to the
    kernel wrapper, which refuses non-CUDA tensors."""
    g = tg.FeatureGrid(pts=torch.zeros((16, 48), device="meta"),
                       n_live=torch.zeros((), dtype=torch.int32))
    q = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor required"):
        tg.grid_gather_pair(g, q, 2.0, g, q, 2.4)


def _border_points(rng, res, n=400, extent=40.0):
    """Points on the map resolution's voxel borders: exact float32 multiples
    k * res (k != 0, so no point is a denormal; a map never holds one, and
    XLA flushes them to zero), one ulp either side of them, and mixes of
    the three per axis. Also the voxel interiors (k + 1/2) * res, which
    make the border points' buckets live and their voxel on one side
    occupied."""
    k = rng.integers(1, int(extent / res), (n, 3))
    k = k * rng.choice([-1, 1], (n, 3))
    base = (k * np.float32(res)).astype(np.float32)
    up = np.nextafter(base, np.float32(np.inf))
    down = np.nextafter(base, np.float32(-np.inf))
    pick = rng.integers(0, 3, base.shape)
    mixed = np.where(pick == 0, base, np.where(pick == 1, up, down))
    border = np.concatenate([base, up, down, mixed]).astype(np.float32)
    inside = (base + np.float32(res / 2)).astype(np.float32)
    return inside, border


_MAP = LaserMappingConfig()


@pytest.mark.parametrize("cell,res,cap", [
    (_MAP.corner_cell, _MAP.line_resolution, _MAP.corner_bucket_cap),
    (_MAP.surf_cell, _MAP.plane_resolution, _MAP.surf_bucket_cap)],
    ids=["corner", "surf"])
def test_insert_dedup_rounds_as_the_jitted_reference(rng, cell, res, cap):
    """The insert's voxel dedup at the map resolution rounds as the
    reference's floor(p / res) does under jit (p * float32(1 / res)): on
    voxel-border points inside live buckets, grid_insert and the batch
    engine's merged insert give tables and n_live bit-identical to the
    jitted JAX grid_insert / batch_grid_insert."""
    nb = 1 << 10
    ins_j = jax.jit(jg.grid_insert, static_argnames=("cell", "res"))
    bins_j = jax.jit(jbm.batch_grid_insert,
                     static_argnames=("cell", "res", "batch"))
    gj, gt = jg.grid_create(nb, cap), tg.grid_create(nb, cap, "cpu")
    bj = jbm.BatchFeatureGrid(
        pts=jnp.full((2 * nb, 3 * cap), jg.SENTINEL, jnp.float32),
        n_live=jnp.zeros((2,), jnp.int32))
    bt = tbm.BatchFeatureGrid(pts=_t(np.asarray(bj.pts)),
                              n_live=torch.zeros((2,), dtype=torch.int32))
    for _ in range(2):
        inside, border = _border_points(rng, res)
        for p in (inside, border):
            m = np.ones(len(p), bool)
            gj = ins_j(gj, jnp.asarray(p), jnp.asarray(m), cell=cell, res=res)
            gt = tg.grid_insert(gt, _t(p), _t(m), cell, res)
            _assert_grid_equal(gj, gt)
            half = len(p) // 2
            pb, mb = p[:2 * half].reshape(2, half, 3), m[:2 * half].reshape(
                2, half)
            bj = bins_j(bj, jnp.asarray(pb), jnp.asarray(mb), cell=cell,
                        res=res, batch=2)
            bt = tbm.batch_grid_insert(bt, _t(pb), _t(mb), cell, res, 2)
            np.testing.assert_array_equal(bt.pts.numpy(), np.asarray(bj.pts))
            np.testing.assert_array_equal(bt.n_live.numpy(),
                                          np.asarray(bj.n_live))
    assert int(gt.n_live) > 1000 and int(bt.n_live.sum()) > 1000
