"""The port's masked brute-force k-NN (vloam_tpu_torch/lidar/knn.py) and the
mesh chunk's window compaction and block evict
(vloam_tpu_torch/parallel/mesh_fused.py) against the JAX reference, on the
CPU.

- masked_knn and nearest_and_ring_constrained on random clouds at 80 m
  coordinates, on equal distances (duplicated candidates) placed across the
  reference's 4096-wide tile boundary and the port's, with fewer live
  candidates than k, and with every candidate masked. Indices must be
  identical (ties: by distance, then lower candidate index, whatever the
  port's tile sizes); distances within 1e-2 m^2 absolute (both compute the
  expanded |q|^2 + |c|^2 - 2 q.c in float32, whose cancellation at 80 m is
  ~1e-3 m^2, and round it in different orders) and +inf exactly where the
  reference's are.
- masked_knn_plain (the plain version of kernels/csrc/knn.cu) against the
  jitted reference on every small case of kernel_cases.knn_cases (ties
  across the reference's tile and the kernel's 256-slot tiles, queries on
  candidates, too few live or too few candidates, k = 1, 3, 5, 8), with the
  same tolerances; masked_knn on CPU tensors launches no kernel; the slices
  the kernel's wrapper cuts cover the candidates; the cases laid out by
  slice hold their layouts at the slices they name.
- _window_block on a [16384, 96] block (2^17 buckets over 8 ranks, corner
  cap 32) holding live rows, empty rows and duplicated rows (equal keys):
  the rows taken, their points and mask bit for bit, and the active-row
  count; _block_evict on the same block bit for bit.
- the same map in both packages at D = 2 and 4: convert.split_map_state's
  rank blocks against the reference's shard_map_state device blocks, each
  rank's window and evict bit for bit against its device's, and the
  evicted blocks joined back (convert.join_map_states) bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.lidar import knn as jknn
from vloam_tpu.parallel import mesh_fused as jmf
from vloam_tpu_torch import kernels
from vloam_tpu_torch.lidar import knn as tknn
from vloam_tpu_torch.parallel import mesh_fused as tmf
from vloam_tpu_torch.tools import kernel_cases

torch.set_num_threads(1)

D_TOL = 1e-2  # m^2, see the module docstring


def _cloud(rng, n, scale=80.0):
    return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


def _case(name, rng):
    q = _cloud(rng, 300)
    if name == "random":
        c = _cloud(rng, 9000)
        m = rng.random(9000) < 0.7
    elif name == "ties_across_tiles":
        # one point duplicated across the reference's 4096 boundary and the
        # port's tile boundaries, and the queries placed on it and near it
        c = _cloud(rng, 9000)
        for lo in (4090, 2045, 8189):
            c[lo:lo + 7] = c[11]
        q[:40] = c[11] + rng.normal(0, 0.01, (40, 3)).astype(np.float32)
        m = np.ones(9000, bool)
        m[4093] = False
    elif name == "fewer_live_than_k":
        c = _cloud(rng, 5000)
        m = np.zeros(5000, bool)
        m[[7, 4095, 4999]] = True
    elif name == "all_masked":
        c = _cloud(rng, 6000)
        m = np.zeros(6000, bool)
    else:  # fewer candidates than k at all
        c = _cloud(rng, 3)
        m = np.ones(3, bool)
    return q, c, m


CASES = ["random", "ties_across_tiles", "fewer_live_than_k", "all_masked",
         "three_candidates"]


def _assert_dist(d_t, d_j):
    d_t, d_j = np.asarray(d_t), np.asarray(d_j)
    np.testing.assert_array_equal(np.isinf(d_t), np.isinf(d_j))
    fin = np.isfinite(d_j)
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=0, atol=D_TOL)


@pytest.mark.parametrize("name", CASES)
def test_masked_knn_matches_jax(name):
    q, c, m = _case(name, np.random.default_rng(7))
    d_j, i_j = jknn.masked_knn(jnp.asarray(q), jnp.asarray(c),
                               jnp.asarray(m), k=5)
    for tiles in ({}, {"q_tile": 64, "c_tile": 1000}):
        d_t, i_t = tknn.masked_knn(torch.from_numpy(q), torch.from_numpy(c),
                                   torch.from_numpy(m), k=5, **tiles)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        _assert_dist(d_t.numpy(), d_j)


_KNN_CASES = [c for c in kernel_cases.knn_cases() if c.small]


@pytest.mark.parametrize("case", _KNN_CASES, ids=lambda c: c.name)
def test_masked_knn_plain_matches_jax_on_crafted_cases(case):
    d_j, i_j = jknn.masked_knn(jnp.asarray(case.queries),
                               jnp.asarray(case.cands), jnp.asarray(case.mask),
                               k=case.k)
    args = (torch.from_numpy(case.queries), torch.from_numpy(case.cands),
            torch.from_numpy(case.mask))
    for tiles in ({}, {"q_tile": 64, "c_tile": 1000}):
        d_t, i_t = tknn.masked_knn_plain(*args, k=case.k, **tiles)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        _assert_dist(d_t.numpy(), d_j)
    d, i = tknn.masked_knn(*args, k=case.k)  # the CPU dispatch
    assert torch.equal(d, d_t) and torch.equal(i, i_t)


def _slice_tiles(case, s):
    """The live flags of the 256-slot tiles slice s of case.slices holds, by
    tile: [tiles of s, 256] (the last tile padded with masked slots)."""
    m = np.zeros(-(-case.mask.size // 256) * 256, bool)
    m[:case.mask.size] = case.mask
    return m.reshape(-1, 256)[s::case.slices]


@pytest.mark.parametrize(
    "case", [c for c in kernel_cases.knn_cases() if c.slices],
    ids=lambda c: c.name)
def test_sliced_cases_hold_their_layout(case):
    """The cases laid out by slice hold at their `slices` what each one
    claims (the card launches them at that count)."""
    tiles = [_slice_tiles(case, s) for s in range(case.slices)]
    if case.name == "masked_tiles_between_live":
        for t in tiles:
            assert len(t) == 3 and not t[1].any()
            assert t[0].any() and t[2].any()
    elif case.name == "slices_all_masked":
        empty = {s for s, t in enumerate(tiles) if not t.any()}
        assert empty == set(range(3, 10)) | {17} | set(range(25, 32))
    elif case.name == "tie_at_the_published_bound":
        # slice 1 live through its first tiles, slice 2 masked there; the
        # tie in slice 1's third tile, below the index of slice 2's copies
        assert tiles[1][:2].all() and not tiles[2][:2].any()
        same = np.flatnonzero((case.cands == case.queries[-1]).all(1)
                              & case.mask)
        assert len(same) == 7
        assert same[0] // 256 == 1 + 2 * case.slices
        assert (same[1:] // 256 == 2 + 2 * case.slices).all()
        assert (case.queries[-24:] == case.queries[-1]).all()
    elif case.name == "few_live_k8_across_slices":
        live = np.flatnonzero(case.mask)
        assert len(live) < case.k
        assert len({g // 256 % case.slices for g in live}) == len(live)
    else:
        assert case.name == "padding_k8"
        assert case.cands.shape[0] < case.k


def test_masked_knn_on_cpu_launches_nothing():
    case = _KNN_CASES[0]
    before = dict(kernels.LAUNCHES)
    tknn.masked_knn(torch.from_numpy(case.queries),
                    torch.from_numpy(case.cands),
                    torch.from_numpy(case.mask), k=case.k)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("Q,n,n_sm", [(2048, 131072, 132), (6144, 65536, 132),
                                      (300, 9005, 132), (1, 1, 132),
                                      (70, 8, 16), (512, 131072, 132),
                                      (9000, 300, 4)])
def test_knn_slices_hold_a_tile_each(Q, n, n_sm):
    """Every slice is dealt a 256-slot tile at least, and the slice kernel's
    blocks come near the asked number an SM: the mesh windows' shapes at
    the default."""
    b = kernels.KNN_BLOCKS_PER_SM
    slices = kernels.knn_slices(Q, n, n_sm, b)
    tiles = -(-n // kernels.KNN_TILE)
    q_blocks = -(-Q // kernels.KNN_THREADS)
    assert 1 <= slices <= tiles
    assert slices == tiles or q_blocks * slices >= b * n_sm
    assert slices == 1 or q_blocks * (slices - 1) < b * n_sm


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mode", ["corner", "surf"])
def test_nearest_and_ring_constrained_matches_jax(name, mode):
    q, c, m = _case(name, np.random.default_rng(8))
    ring = np.random.default_rng(9).integers(0, 64, len(c)).astype(np.int32)
    if name == "ties_across_tiles":
        ring[4090:4097] = ring[11]  # same-ring duplicates: surf's i3 ties
    j = jknn.nearest_and_ring_constrained(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(ring), jnp.asarray(m),
        2.5, mode)
    t = tknn.nearest_and_ring_constrained(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(ring),
        torch.from_numpy(m), 2.5, mode, c_tile=1000)
    for k in ("i0", "i2", "i3"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), k)
    for k in ("d0", "d2", "d3"):
        _assert_dist(t[k].numpy(), j[k])


def _block(rng, nbD=16384, cap=32):
    """A map block: ~2000 live rows of 1-32 points within 60 m of the
    origin, the rest empty, and 20 rows duplicated (equal window keys)."""
    blk = np.full((nbD, 3, cap), 1.0e6, np.float32)
    rows = rng.choice(nbD, 2000, replace=False)
    for r in rows:
        n = rng.integers(1, cap + 1)
        blk[r, :, :n] = rng.uniform(-60, 60, (3, n))
    blk[rows[:20] + 1] = blk[rows[:20]]
    return blk.reshape(nbD, 3 * cap)


def test_window_block_matches_jax():
    blk = _block(np.random.default_rng(3))
    center = np.asarray([4.0, -3.0, 0.5], np.float32)
    for w_rows in (4096, 1024):
        pj, mj, nj = jmf._window_block(jnp.asarray(blk), jnp.asarray(center),
                                       w_rows)
        pt, mt, nt = tmf._window_block(torch.from_numpy(blk),
                                       torch.from_numpy(center), w_rows)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        assert int(nt) == int(nj) > 0


def test_block_evict_matches_jax():
    blk = _block(np.random.default_rng(4))
    center = np.asarray([50.0, 0.0, 0.0], np.float32)
    radius = np.asarray([40.0, 55.0, 30.0], np.float32)
    bj, nj = jmf._block_evict(jnp.asarray(blk), jnp.asarray(center),
                              jnp.asarray(radius))
    bt, nt = tmf._block_evict(torch.from_numpy(blk),
                              torch.from_numpy(center),
                              torch.from_numpy(radius))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert int(nt) == int(nj) > 0


@pytest.mark.parametrize("D", [2, 4])
def test_rank_blocks_match_jax_devices(D):
    """The same map in both packages: convert.split_map_state gives rank r
    the rows the reference's shard_map_state places on device r, so each
    rank's window and evict of its block equal that device's bit for bit,
    and the evicted blocks join back (convert.join_map_states) to the
    reference's whole evicted map."""
    import dataclasses

    import jax
    from jax.sharding import PartitionSpec as P

    from vloam_tpu.parallel.sharded import data_mesh
    from vloam_tpu.parallel.sharded_mapping import shard_map
    from vloam_tpu.vloam_step import MapState as JMapState
    from vloam_tpu_torch import convert

    from test_pipeline import small_cfg

    nb, w_rows = 16384, 1024
    cfg = small_cfg()
    cfg = cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, map_n_buckets=nb, corner_bucket_cap=32))
    st = jax.tree.map(np.asarray, JMapState.create(cfg))
    st = st._replace(cube=st.cube._replace(corner=st.cube.corner._replace(
        pts=_block(np.random.default_rng(8), nb))))
    center = np.asarray([4.0, -3.0, 0.5], np.float32)
    radius = np.asarray([40.0, 55.0, 30.0], np.float32)

    def per_device(blk):
        pts, m, n = jmf._window_block(blk, jnp.asarray(center), w_rows)
        ev, k = jmf._block_evict(blk, jnp.asarray(center),
                                 jnp.asarray(radius))
        return pts, m, n[None], ev, k[None]

    jmesh = data_mesh(jax.devices()[:D])
    run = jax.jit(shard_map(per_device, mesh=jmesh, in_specs=(P("data"),),
                            out_specs=(P("data"),) * 5, check_vma=False))
    want = [np.asarray(a) for a in run(
        jmf.shard_map_state(st, jmesh).cube.corner.pts)]
    n_slots = w_rows * 32
    parts = convert.split_map_state(st, D, "cpu")
    evicted = []
    for r, part in enumerate(parts):
        blk = part.cube.corner.pts
        pts, m, n = tmf._window_block(blk, torch.from_numpy(center), w_rows)
        mine = slice(r * n_slots, (r + 1) * n_slots)
        np.testing.assert_array_equal(pts.numpy(), want[0][mine])
        np.testing.assert_array_equal(m.numpy(), want[1][mine])
        assert int(n) == int(want[2][r])
        ev, k = tmf._block_evict(blk, torch.from_numpy(center),
                                 torch.from_numpy(radius))
        assert int(k) == int(want[4][r])
        evicted.append(part._replace(cube=part.cube._replace(
            corner=part.cube.corner._replace(pts=ev))))
    assert want[2].sum() > 0 and want[4].sum() > 0
    back = convert.join_map_states(evicted)
    np.testing.assert_array_equal(back.cube.corner.pts, want[3])
    np.testing.assert_array_equal(back.cube.surf.pts, st.cube.surf.pts)


_KNN_HEAD = """
\t\tFunction : _ZN12_GLOBAL__N_116knn_slice_kernelILi5EEEvPKfS2_PKhiiiiPiS5_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FMUL R8, R5, R6 ;
        /*0030*/                   FADD R9, R8, R7 ;
        /*0040*/                   FSETP.LTU.OR P0, PT, R9, R3, P0 ;
"""
_KNN_TAIL = """
\t\tFunction : _ZN12_GLOBAL__N_116knn_merge_kernelILi5EEEvPKiS2_iiPfPx
        /*0000*/                   EXIT ;
"""
# the examination after the loop, reached by a forward branch out of it
_KNN_EXAM_AFTER = """
        /*0050*/               @P0 BRA 0x90 ;
        /*0060*/                   IADD3 R2, R2, 0x40, RZ ;
        /*0070*/                   ISETP.GE.AND P1, PT, R2, 0x400, PT ;
        /*0080*/              @!P1 BRA 0x10 ;
        /*0090*/                   SEL R10, R11, R12, P2 ;
        /*00a0*/                   SEL R10, R11, R12, P2 ;
        /*00b0*/                   SEL R10, R11, R12, P2 ;
        /*00c0*/               @P3 BRA 0x10 ;
        /*00d0*/                   EXIT ;
"""
# the examination inside the loop, skipped by a forward branch to the step
# increment
_KNN_EXAM_INSIDE = """
        /*0050*/              @!P0 BRA 0x90 ;
        /*0060*/                   SEL R10, R11, R12, P2 ;
        /*0070*/                   SEL R10, R11, R12, P2 ;
        /*0080*/                   SEL R10, R11, R12, P2 ;
        /*0090*/                   IADD3 R2, R2, 0x40, RZ ;
        /*00a0*/                   ISETP.GE.AND P1, PT, R2, 0x400, PT ;
        /*00b0*/              @!P1 BRA 0x10 ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   BRA 0xd0 ;
"""


@pytest.mark.parametrize("body", [_KNN_EXAM_AFTER, _KNN_EXAM_INSIDE],
                         ids=["exam_after", "exam_inside"])
def test_knn_sass_counts_the_hot_loop(body):
    """kernels.build.knn_sass, which chip_smoke.py phase 2 prints: the slice
    kernel's main loop is its hot path, the shortest way back to the head of
    the loop that loads the most from shared memory, wherever the compiler
    puts the examination (after the loop, or inside it behind a forward
    branch), per KNN_STEP slots."""
    from vloam_tpu_torch.kernels import build

    lines, per_pair = build.knn_sass(_KNN_HEAD + body + _KNN_TAIL)
    assert per_pair == {5: 8 / build.KNN_STEP}
    assert lines == ["knn_slice_kernel<5> 14 instructions, main loop 8 for "
                     f"16 slots = {8 / 16:.2f} a pair"]
