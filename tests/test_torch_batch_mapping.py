"""The port's flat-batched mapping (vloam_tpu_torch.lidar.batch_mapping), its
row gather and the min-only ring reduction against the JAX reference, on the
CPU, where every kernel wrapper takes its plain PyTorch version.

- row_gather_plain against np.take: exact. The dispatcher takes the plain
  version only for CPU tensors; the kernel wrapper refuses what the kernel
  does not take (row width, dtypes) instead of falling back.
- ring_min1_plain against the first two outputs of the reference's
  ring_min2_xla and ring_min2_pallas (interpret mode), and against the
  min-only measurement kernel's formulation (per ring min / argmin of the
  summed squared differences) restated in numpy: slots exact, distances to
  1e-6 relative (all add (dx^2 + dy^2) + dz^2 in float32). It equals
  ring_min2_plain's first two outputs bit for bit, so impl="xla" picks
  exactly what impl="pallas" picks.
- batch_grid_insert / gather / evict / batch_solve_mapping against their
  JAX counterparts on the same inputs, mirroring tests/test_batch_mapping.py:
  n_live exact; bucket rows within the insert's fixed-point step
  (res / 2^14 < 1e-4 m; the slot layout is identical, or the SENTINEL
  padding would differ by 1e6); gathers exact on identical tables (the
  probe pair on kernel_cases.grid_probe_cases too); poses
  q 3e-4, t 5e-3 m (the adjugate plane fit's conditioning, as in
  tests/test_torch_loam_engine.py).
- the LM's closed-form Jacobian with a stream axis against a float64
  torch.func.jacfwd of the retracted residual, and the batched solve against
  the single-stream solve stream by stream.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.config import kitti_hdl64
from vloam_tpu.lidar import batch_mapping as jbm
from vloam_tpu.lidar import ring_assoc as jra
from vloam_tpu_torch import kernels
from vloam_tpu_torch.lidar import batch_mapping as tbm
from vloam_tpu_torch.lidar import gridmap as tgm
from vloam_tpu_torch.lidar import mapping as tmap
from vloam_tpu_torch.lidar import ring_assoc as tra
from vloam_tpu_torch.solver import lm as tlm
from vloam_tpu_torch.tools import kernel_cases

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

B = 2


def _t(x):
    return torch.from_numpy(np.array(x))


def small_map_cfg():
    return dataclasses.replace(
        kitti_hdl64().mapping, map_n_buckets=1 << 10, corner_bucket_cap=8,
        surf_bucket_cap=8, corner_stack_cap=128, surf_stack_cap=256)


def _rand_stream(seed, n, extent=20.0):
    r = np.random.default_rng(seed)
    return r.uniform(-extent, extent, (n, 3)).astype(np.float32)


# ---------------------------------------------------------------- row gather

@pytest.mark.parametrize("width", [48, 96])
def test_row_gather_plain_matches_numpy_take(rng, width):
    table = rng.normal(size=(1 << 10, width)).astype(np.float32)
    idx = rng.integers(0, 1 << 10, 4096)
    idx[:4] = [0, (1 << 10) - 1, 7, 7]  # both ends and a repeated row
    want = np.take(table, idx, axis=0)
    for fn in (tgm.row_gather_plain, tgm.row_gather):
        got = fn(_t(table), _t(idx))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_row_gather_dispatch_has_no_fallback():
    table = torch.zeros((16, 8), device="meta")
    idx = torch.zeros((4,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor required"):
        tgm.row_gather(table, idx)


def test_ring_min1_dispatch_has_no_fallback():
    q = torch.zeros((4, 3), device="meta")
    s = torch.zeros((8, 3, 16), device="meta")
    for fn in (tra.ring_min1, kernels.ring_argmin2):
        with pytest.raises(ValueError, match="CUDA tensor required"):
            fn(q, s)


def test_launch_counters_cover_all_six_kernels():
    assert set(kernels.LAUNCHES) == {
        "select_rings", "ring_min2", "zncc_describe", "row_gather",
        "grid_probe", "ring_min1", "ring_argmin2", "ring_min1_packed",
        "masked_knn"}
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())


# ----------------------------------------------------------------- ring_min1

def _slab(rng, S=8, C=128, live=0.7):
    xyz = np.full((S, C, 3), jra.SENTINEL, np.float32)
    for s in range(S):
        n = int(C * live * rng.uniform(0.3, 1.0))
        xyz[s, :n] = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    return xyz


def _ring_case(rng, case):
    slab = _slab(rng)
    q = rng.uniform(-40, 40, (96, 3)).astype(np.float32)
    if case == "ties":
        slab[1, 10] = slab[1, 3]  # duplicated point: an exact tie
        slab[2] = jra.SENTINEL  # an all-SENTINEL ring
        q[:4] = slab[1, 3]
    return q, np.ascontiguousarray(np.swapaxes(slab, 1, 2))


@pytest.mark.parametrize("case", ["random", "ties"])
def test_ring_min1_plain_matches_reference_reductions(rng, case):
    q, slab_t = _ring_case(rng, case)
    dmin, amin = tra.ring_min1_plain(_t(q), _t(slab_t))
    assert dmin.dtype == torch.float32 and amin.dtype == torch.int32
    # the min-only measurement kernel's formulation, in numpy
    diff = q[None, :, :, None] - slab_t[:, None, :, :]  # [S, Q, 3, C]
    d = np.zeros(diff.shape[:2] + diff.shape[3:], np.float32)
    for ax in range(3):
        d = d + diff[:, :, ax] * diff[:, :, ax]
    refs = {
        "numpy": (d.min(-1), d.argmin(-1)),
        "xla": jra.ring_min2_xla(jnp.asarray(q), jnp.asarray(slab_t))[:2],
        "pallas": jra.ring_min2_pallas(jnp.asarray(q), jnp.asarray(slab_t),
                                       q_tile=32, interpret=True)[:2],
    }
    for name, (want_d, want_a) in refs.items():
        np.testing.assert_array_equal(amin.numpy(), np.asarray(want_a), name)
        np.testing.assert_allclose(dmin.numpy(), np.asarray(want_d),
                                   rtol=1e-6, err_msg=name)
    if case == "ties":
        assert (amin.numpy()[1, :4] == 3).all()  # ties: the lowest slot
        assert (amin.numpy()[2] == 0).all()


@pytest.mark.parametrize("case", ["random", "ties"])
def test_ring_min1_plain_is_first_half_of_ring_min2_plain(rng, case):
    q, slab_t = _ring_case(rng, case)
    full = tra.ring_min2_plain(_t(q), _t(slab_t))
    half = tra.ring_min1_plain(_t(q), _t(slab_t))
    for got, want in zip(half, full[:2]):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    # the argmin variant has no dispatcher: its kernel refuses CPU tensors
    with pytest.raises(ValueError, match="CUDA tensor required"):
        kernels.ring_argmin2(_t(q), _t(slab_t))


def test_corner_assoc_picks_unchanged_by_min_only_reduction(rng):
    """mode="corner" through ring_min1 (impl="xla") gives what it gives
    through the 2-smallest reduction with the second minimum thrown away
    (impl="pallas")."""
    slab = _slab(rng, S=16, C=64)
    live = slab[slab[..., 0] < jra.SENTINEL * 0.5]
    q = (live[rng.integers(0, len(live), 200)]
         + rng.normal(0, 0.5, (200, 3))).astype(np.float32)
    got = tra.ring_slab_assoc(_t(q), tra.RingSlab(_t(slab)), 2.5, "corner",
                              impl="xla")
    want = tra.ring_slab_assoc(_t(q), tra.RingSlab(_t(slab)), 2.5, "corner",
                               impl="pallas")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ref = jra.ring_slab_assoc(jnp.asarray(q), jra.RingSlab(jnp.asarray(slab)),
                              nearby_scan=2.5, mode="corner", impl="xla")
    for k in ("p0", "p2"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


# ------------------------------------------------------------ the flat table

def _empty(nb, cap):
    j = jbm.BatchFeatureGrid(
        pts=jnp.full((B * nb, 3 * cap), 1.0e6, jnp.float32),
        n_live=jnp.zeros((B,), jnp.int32))
    t = tbm.BatchFeatureGrid(
        pts=torch.full((B * nb, 3 * cap), 1.0e6),
        n_live=torch.zeros((B,), dtype=torch.int32))
    return j, t


def _inserted(seeds, S, extent, rounds, cfg):
    """The same points inserted into a JAX and a port table."""
    nb, cap = cfg.map_n_buckets, cfg.corner_bucket_cap
    pts = np.stack([_rand_stream(s, S, extent) for s in seeds])
    mask = np.ones((B, S), bool)
    mask[0, -5:] = False
    gj, gt = _empty(nb, cap)
    for k in range(rounds):
        p = pts + np.float32(0.05 * k)
        gj = jbm.batch_grid_insert(gj, jnp.asarray(p), jnp.asarray(mask),
                                   cfg.corner_cell, cfg.line_resolution, B)
        gt = tbm.batch_grid_insert(gt, _t(p), _t(mask), cfg.corner_cell,
                                   cfg.line_resolution, B)
    return gj, gt


def test_flat_buckets_match_jax_bit_for_bit():
    cfg = small_map_cfg()
    p = np.stack([_rand_stream(3, 500, 300.0), _rand_stream(4, 500, 300.0)])
    want = np.asarray(jbm._flat_buckets(jnp.asarray(p), cfg.corner_cell,
                                        cfg.map_n_buckets))
    got = tbm._flat_buckets(_t(p), cfg.corner_cell, cfg.map_n_buckets)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_insert_matches_jax():
    """Two rounds: the second exercises the dup check and hole filling."""
    cfg = small_map_cfg()
    gj, gt = _inserted((7, 8), 128, 20.0, 2, cfg)
    np.testing.assert_array_equal(gt.n_live.numpy(), np.asarray(gj.n_live))
    assert gt.n_live.dtype == torch.int32 and int(gt.n_live.sum()) > 200
    np.testing.assert_allclose(gt.pts.numpy(), np.asarray(gj.pts), rtol=0,
                               atol=1e-4)


def test_batch_insert_matches_per_stream_insert():
    """Against the port's own single-stream grid_insert, as
    tests/test_batch_mapping.py holds the reference."""
    cfg = small_map_cfg()
    nb, cap = cfg.map_n_buckets, cfg.corner_bucket_cap
    _, gt = _inserted((7, 8), 128, 20.0, 2, cfg)
    pts = np.stack([_rand_stream(s, 128) for s in (7, 8)])
    mask = np.ones((B, 128), bool)
    mask[0, -5:] = False
    for b in range(B):
        g = tgm.grid_create(nb, cap, "cpu")
        for k in range(2):
            g = tgm.grid_insert(g, _t(pts[b] + np.float32(0.05 * k)),
                                _t(mask[b]), cfg.corner_cell,
                                cfg.line_resolution)
        np.testing.assert_allclose(gt.pts[b * nb:(b + 1) * nb].numpy(),
                                   g.pts.numpy(), atol=1e-3)
        assert int(gt.n_live[b]) == int(g.n_live)


def test_batch_gather_matches_jax():
    cfg = small_map_cfg()
    gj, _ = _inserted((17, 18), 128, 20.0, 1, cfg)
    # identical tables on both sides: the gather itself is exact
    gt = tbm.BatchFeatureGrid(pts=_t(gj.pts), n_live=_t(gj.n_live))
    q = np.stack([_rand_stream(27, 64, 18.0), _rand_stream(28, 64, 18.0)])
    want = np.asarray(jbm.batch_grid_gather(gj, jnp.asarray(q),
                                            cfg.corner_cell, B))
    got = tbm.batch_grid_gather_plain(gt, _t(q), cfg.corner_cell, B)
    assert got.shape == want.shape == (3, B * 64, 8 * cfg.corner_bucket_cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 1e5).any()
    # and per stream it is the single-stream probe of that stream's block
    nb = cfg.map_n_buckets
    for b in range(B):
        g = tgm.FeatureGrid(pts=gt.pts[b * nb:(b + 1) * nb],
                            n_live=gt.n_live[b])
        ref = tgm.grid_gather_plain(g, _t(q[b]), cfg.corner_cell)
        assert torch.equal(got[:, b * 64:(b + 1) * 64], ref)
    pair = tbm.batch_grid_gather_pair(gt, _t(q), cfg.corner_cell, gt,
                                      _t(q), cfg.surf_cell, B)
    assert torch.equal(pair[0], got)
    assert torch.equal(pair[1], tbm.batch_grid_gather_plain(
        gt, _t(q), cfg.surf_cell, B))


@pytest.mark.parametrize("case", kernel_cases.grid_probe_cases(),
                         ids=lambda c: c.name)
def test_batch_grid_gather_pair_matches_jax(case):
    """Both grids' probe over n_streams flat tables through
    batch_grid_gather_pair (on the CPU: batch_grid_gather_plain) equal the
    JAX batch_grid_gather's bit for bit, on every probe case: both signs,
    cell midpoints and borders, an empty job, all-SENTINEL rows, and 3
    streams whose last stream's rows the probe reaches. The reference runs
    under jit, as batch_solve_mapping calls it: there q / cell becomes a
    product with float32 1 / cell and the neighbour side a fused
    multiply-add; called op by op it divides, and cell midpoints and
    borders fall elsewhere."""
    S, nb = case.n_streams, case.n_buckets
    gather = jax.jit(jbm.batch_grid_gather, static_argnums=(2, 3))
    args, wants = [], []
    for table, q, cell in case.jobs:
        qs = q.reshape(S, -1, 3)
        gj = jbm.BatchFeatureGrid(pts=jnp.asarray(table),
                                  n_live=jnp.zeros((S,), jnp.int32))
        wants.append(np.asarray(gather(gj, jnp.asarray(qs), cell, S)))
        args += [tbm.BatchFeatureGrid(pts=_t(table),
                                      n_live=torch.zeros((S,),
                                                         dtype=torch.int32)),
                 _t(qs), cell]
    got = tbm.batch_grid_gather_pair(*args, S)
    for g, w, (table, q, cell) in zip(got, wants, case.jobs):
        assert g.shape == w.shape == (3, len(q), 8 * table.shape[1] // 3)
        np.testing.assert_array_equal(g.numpy(), w)
    if S > 1:
        for table, q, cell in case.jobs:
            rows = (tgm.probe_buckets(_t(q.reshape(S, -1, 3)), cell, nb)
                    + tbm._stream_offsets(S, nb, "cpu")[..., None])
            assert int(rows.max()) // nb == S - 1
            assert int(rows[-1].min()) >= (S - 1) * nb


def test_batch_grid_gather_pair_dispatch_has_no_fallback():
    g = tbm.BatchFeatureGrid(pts=torch.zeros((32, 48), device="meta"),
                             n_live=torch.zeros((2,), dtype=torch.int32))
    q = torch.zeros((2, 4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor required"):
        tbm.batch_grid_gather_pair(g, q, 2.0, g, q, 2.4, 2)


def test_batch_evict_matches_jax():
    cfg = small_map_cfg()
    gj, _ = _inserted((57, 58), 128, 400.0, 1, cfg)
    gt = tbm.BatchFeatureGrid(pts=_t(gj.pts), n_live=_t(gj.n_live))
    centers = np.asarray([[10.0, 0.0, 0.0], [-5.0, 3.0, 0.0]], np.float32)
    radius = np.asarray([200.0, 150.0, 100.0], np.float32)
    want = jbm.batch_grid_evict(gj, jnp.asarray(centers), jnp.asarray(radius),
                                B)
    got = tbm.batch_grid_evict(gt, _t(centers), _t(radius), B)
    np.testing.assert_array_equal(got.pts.numpy(), np.asarray(want.pts))
    np.testing.assert_array_equal(got.n_live.numpy(), np.asarray(want.n_live))
    assert 0 < int(got.n_live.sum()) < int(gt.n_live.sum())


def test_batch_map_evict_matches_jax():
    """Chunk-boundary recentering: stream 0 crossed a cube boundary, stream
    1 did not and keeps every point."""
    cfg = small_map_cfg()
    gj, _ = _inserted((57, 58), 128, 400.0, 1, cfg)
    gmj = jbm.BatchGridMap(gj, gj, jnp.zeros((B, 3), jnp.int32))
    gmt = tbm.BatchGridMap(
        *(tbm.BatchFeatureGrid(_t(gj.pts), _t(gj.n_live)) for _ in range(2)),
        torch.zeros((B, 3), dtype=torch.int32))
    t_w = np.asarray([[130.0, 2.0, 0.0], [3.0, -4.0, 1.0]], np.float32)
    want = jbm.batch_map_evict(gmj, jnp.asarray(t_w), cfg, B)
    got = tbm.batch_map_evict(gmt, _t(t_w), cfg, B)
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(want.center))
    for g, w in ((got.corner, want.corner), (got.surf, want.surf)):
        np.testing.assert_array_equal(g.pts.numpy(), np.asarray(w.pts))
        np.testing.assert_array_equal(g.n_live.numpy(), np.asarray(w.n_live))
    assert int(got.corner.n_live[0]) < int(gj.n_live[0])
    assert int(got.corner.n_live[1]) == int(gj.n_live[1])


def _scene(seed, cfg):
    """A line of corners and a ground plane of surfs."""
    r = np.random.default_rng(seed)
    t = r.uniform(-8, 8, (cfg.corner_stack_cap,))
    corners = np.stack([t, np.full_like(t, 2.0), np.full_like(t, 1.0)],
                       1) + r.normal(0, 0.01, (len(t), 3))
    xs = r.uniform(-8, 8, (cfg.surf_stack_cap,))
    ys = r.uniform(-8, 8, (cfg.surf_stack_cap,))
    ground = np.stack([xs, ys, np.zeros_like(xs)], 1)
    return corners.astype(np.float32), ground.astype(np.float32)


def _solve_inputs(cfg):
    streams = [_scene(40 + b, cfg) for b in range(B)]
    c_xyz = np.stack([s[0] for s in streams])
    s_xyz = np.stack([s[1] for s in streams])
    c_m = np.ones(c_xyz.shape[:2], bool)
    s_m = np.ones(s_xyz.shape[:2], bool)
    ident = np.tile(np.asarray([0, 0, 0, 1], np.float32), (B, 1))
    zero = np.zeros((B, 3), np.float32)
    q_pred = np.tile(np.asarray([0.0, 0.0, 0.01, 0.99995], np.float32),
                     (B, 1))
    t_pred = np.tile(np.asarray([0.05, -0.03, 0.02], np.float32), (B, 1))
    return (c_xyz, c_m, s_xyz, s_m), (ident, zero), (q_pred, t_pred)


def test_batch_solve_matches_jax():
    cfg = small_map_cfg()
    stacks, seed_pose, pred = _solve_inputs(cfg)
    gmj = jbm.BatchGridMap.create(cfg, B)
    gmt = tbm.BatchGridMap.create(cfg, B, "cpu")
    # seed the maps (an empty map keeps the prediction), then solve from a
    # slightly wrong prediction: the solve must pull back
    gmj, qj0, tj0 = jbm.batch_solve_mapping(
        gmj, *map(jnp.asarray, stacks), *map(jnp.asarray, seed_pose), cfg, B)
    gmt, qt0, tt0 = tbm.batch_solve_mapping(
        gmt, *map(_t, stacks), *map(_t, seed_pose), cfg, B)
    np.testing.assert_array_equal(qt0.numpy(), seed_pose[0])
    np.testing.assert_array_equal(tt0.numpy(), seed_pose[1])
    for g, w in ((gmt.corner, gmj.corner), (gmt.surf, gmj.surf)):
        np.testing.assert_array_equal(g.n_live.numpy(), np.asarray(w.n_live))
        np.testing.assert_allclose(g.pts.numpy(), np.asarray(w.pts), rtol=0,
                                   atol=1e-4)
    gmj2, qj, tj = jbm.batch_solve_mapping(
        gmj, *map(jnp.asarray, stacks), *map(jnp.asarray, pred), cfg, B)
    gmt2, qt, tt = tbm.batch_solve_mapping(
        gmt, *map(_t, stacks), *map(_t, pred), cfg, B)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=3e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=5e-3)
    assert np.abs(tt.numpy() - pred[1]).max() > 1e-2  # it did move
    np.testing.assert_array_equal(gmt2.corner.n_live.numpy(),
                                  np.asarray(gmj2.corner.n_live))


def test_batch_solve_matches_single_stream_solve():
    cfg = small_map_cfg()
    nb = cfg.map_n_buckets
    stacks, seed_pose, pred = _solve_inputs(cfg)
    gm = tbm.BatchGridMap.create(cfg, B, "cpu")
    gm, _, _ = tbm.batch_solve_mapping(gm, *map(_t, stacks),
                                       *map(_t, seed_pose), cfg, B)
    _, q_b, t_b = tbm.batch_solve_mapping(gm, *map(_t, stacks),
                                          *map(_t, pred), cfg, B)
    for b in range(B):
        single = tmap.GridMap(
            corner=tgm.FeatureGrid(gm.corner.pts[b * nb:(b + 1) * nb],
                                   gm.corner.n_live[b]),
            surf=tgm.FeatureGrid(gm.surf.pts[b * nb:(b + 1) * nb],
                                 gm.surf.n_live[b]),
            center=torch.zeros((3,), dtype=torch.int32))
        _, q_s, t_s, _ = tmap.solve_mapping(
            single, *(_t(x[b]) for x in stacks), _t(pred[0][b]),
            _t(pred[1][b]), cfg)
        np.testing.assert_allclose(q_b[b].numpy(), q_s.numpy(), atol=2e-4)
        np.testing.assert_allclose(t_b[b].numpy(), t_s.numpy(), atol=2e-3)


# ------------------------------------------------------- the batched LM family

def _family_inputs(rng, n=40, dtype=torch.float64):
    def r(*shape):
        return torch.from_numpy(rng.normal(size=shape)).to(dtype)

    n_edge = n // 2
    cp = r(B, n, 3) * 5
    A, Bp = r(B, n, 3) * 5, r(B, n, 3) * 5
    DE = torch.linalg.norm(A - Bp, dim=-1)
    NH = torch.nn.functional.normalize(r(B, n, 3), dim=-1)
    NOOD = r(B, n)
    w = torch.from_numpy(rng.uniform(size=(B, n)) > 0.2).to(dtype)
    is_edge = (torch.arange(n) < n_edge)[:, None]
    q = torch.nn.functional.normalize(r(B, 4), dim=-1)
    x = torch.cat([q, r(B, 3)], dim=-1)
    return (cp, is_edge, A, Bp, DE, NH, NOOD, w), x


def test_batched_mo_family_matches_float64_jacfwd(rng):
    args, x = _family_inputs(rng)
    cp, is_edge, A, Bp, DE, NH, NOOD, w = args
    fam = tmap.mo_families(*args)(x)
    assert fam.r.shape == (B, 40, 3) and fam.J.shape == (B, 40, 3, 6)
    for b in range(B):
        def res(delta):
            xb = tmap._retract(x[b], delta)
            pw = tbm._world(xb[None], cp[b][None])[0]
            return tmap.mo_residual(pw, is_edge, A[b], Bp[b], DE[b], NH[b],
                                    NOOD[b])

        zero = torch.zeros(6, dtype=torch.float64)
        J = torch.func.jacfwd(res)(zero)
        np.testing.assert_allclose(fam.r[b].numpy(), res(zero).numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(fam.J[b].numpy(), J.numpy(), atol=1e-9)
        # and the stream axis changes nothing: the single-stream family
        one = tmap.mo_families(cp[b], is_edge, A[b], Bp[b], DE[b], NH[b],
                               NOOD[b], w[b])(x[b])
        np.testing.assert_allclose(fam.J[b].numpy(), one.J.numpy(),
                                   atol=1e-12)


def test_batched_normal_equations_and_solve_are_per_stream(rng):
    args, x = _family_inputs(rng, dtype=torch.float32)
    fam = tmap.mo_families(*args)(x)
    H, g, cost = tlm.normal_equations(fam, 0.1)
    assert H.shape == (B, 6, 6) and g.shape == (B, 6) and cost.shape == (B,)
    lam = torch.tensor([1e-4, 3e-2])
    step = tlm.solve_damped(H, g, lam)
    for b in range(B):
        one = tlm.ResidualFamily(fam.r[b], fam.J[b], fam.mask[b])
        H1, g1, c1 = tlm.normal_equations(one, 0.1)
        np.testing.assert_allclose(H[b].numpy(), H1.numpy(), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(g[b].numpy(), g1.numpy(), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(cost[b].numpy(), c1.numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            step[b].numpy(), tlm.solve_damped(H1, g1, lam[b]).numpy(),
            rtol=1e-3, atol=1e-6)
    # a stream whose trial step is rejected keeps its state while the other
    # stream's is accepted: accept / lambda are per stream
    xs = tlm.lm_solve(tmap.mo_families(*args), tmap._retract, x,
                      iterations=3, huber_delta=0.1)
    for b in range(B):
        one = tmap.mo_families(*(a if a.dim() == 2 and a.shape[1] == 1
                                 else a[b] for a in args))
        x1 = tlm.lm_solve(one, tmap._retract, x[b], iterations=3,
                          huber_delta=0.1)
        np.testing.assert_allclose(xs[b].numpy(), x1.numpy(), atol=1e-4)
