"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where torch sees no GPU;
on a GPU machine run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(--noconftest: the suite's conftest.py pins JAX to the CPU, and nothing here
needs JAX.)

- K1 select_rings: labels identical to select_rings_plain on random rings
  with exact curvature ties, short rings and a full ring, at the main path's
  [64, 2560] and at [64, 4100], and on every crafted case of
  vloam_tpu_torch/tools/kernel_cases.py (a window that crosses a sector's
  end, equal curvatures, sectors of one point, candidates that run out, the
  threshold, NaN and zero, widths up to 7000, whose sectors no longer fit
  the registers and whose ring needs the >48 KB shared-memory opt-in).
- K2 ring_min2: argmins identical and distances within 1e-6 relative of
  ring_min2_plain (the kernel rounds every product and sum as the plain
  version does), including duplicate points, all-SENTINEL rings, a query
  count that is not a multiple of the block and a slab of many tiles; every
  output identical on the crafted cases (duplicates across chunk and tile
  boundaries, the second minimum before the first, SENTINEL slots between
  live ones, one query, two slots).
- The xyz-ingest engine (LoamEngine.push) on the card against the same
  engine on the CPU: LO within 2e-2 m and MO within 3e-2 m, the tolerances
  of tests/test_golden_regression.py (the order of the LM and map sums
  differs between the devices).
- The engine on the card gives identical rows with TF32 / reduced-precision
  matmuls allowed and with them off; so does the combined engine
  (VloamEngine), whose matcher is the path's one cuBLAS product (run in
  float64, which TF32 never touches).
- K3 zncc_describe: within 1e-5 of zncc_describe_plain at the main path's
  [375, 1242] image and 2048 keypoints, p = 24 and 16, with zero rows
  (the 1e-3 floor) in the same places, on keypoints at the image's corners
  (clipping) and on a constant patch; and on every crafted K3 case of
  kernel_cases.py (edges, flat patches either side of the floor, p = 24,
  16 and 7), each with all its keypoints and with 3 fewer (a count no warp
  or block grouping divides), and on an image that starts 4 bytes into its
  buffer (rows at other 16-byte alignments).
- S2 row_gather: bit-identical to table[idx] at both map row widths (the
  kernel's template widths, 48 and 96 floats) and at widths below, at and
  above a warp of 16-byte words (the general path: 4, 12, 128, 260), with
  the table's last row, repeated rows, one row, odd counts and counts that
  are not a multiple of a block's 16-byte words; widths that are not a
  multiple of 4 floats and int32 indices are refused.
- S2 grid_probe: both grids' probe candidates in one launch bit-identical to
  the plain pair (on the card and on the CPU) on every probe case of
  kernel_cases.py (both signs, cell midpoints and borders, one job with no
  query, all-SENTINEL rows, streams up to the last) at the single engine's
  widths (2^17 buckets, caps 32 and 16) and at the batch engine's (4
  streams), and at other caps (the kernel's generic path); what the kernel
  does not take is refused.
- S1 ring_min1 and ring_argmin2: every output identical to the plain
  versions and to K2's, on the shapes and the ties of the K2 test, on K2's
  crafted cases, on the min-only slab shapes of kernel_cases.py (counts
  that ring_min1's block shape divides unevenly, all-SENTINEL rings, equal
  minima across chunk, group and tile boundaries) and on ring_argmin2's
  (the runner-up at the winner's distance, the winner in the last slot,
  slot counts no tile divides, rings all SENTINEL).
- ring_min1_packed, both forms (impl "mxu" and "packed"): every output
  identical to ring_min1_mxu_plain / ring_min1_packed_plain on candidates
  near the queries at the engines' shapes and at a slab of many tiles, and
  on every ring case of kernel_cases.py (quantized ties, duplicates,
  clipped and all-SENTINEL rings, dense clouds at counts no block divides;
  the fast truncation's boundaries: counts at and one ulp below an integer,
  the clip and either side of it, the largest counts under 2^23 at 7 slot
  bits and past it at 6, where the conversion path runs; product-form
  distances below 0; counts that the kernel's blocks, warp shares and
  unrolled steps do not divide).
- ring_slab_assoc under each of the four impls: the card's picks and
  distances equal the CPU's.
- masked_knn (kernels/csrc/knn.cu): indices and distance bits identical to
  masked_knn_plain on the card, and indices to the CPU's, on every case of
  kernel_cases.knn_cases (ties across the reference's 4096 tile and the
  kernel's 256-slot tiles and slices, queries on candidates, too few live
  or too few candidates and the reference's padding indices, k = 1, 3, 5,
  8, the mesh engine's corner window shape) and at random shapes no tile,
  slice or block divides, at the default slices and at 1 and 16 blocks an
  SM (other slice counts); one count a call; k > 8, another dtype and a
  strided input are refused.
- The depth grid (vision/depth_map.py) built twice on the card: identical,
  and identical to the CPU's (each cell adds its points in point order).
- The batch engine on the card against the same engine on the CPU, the
  tolerances of the single engine's test.
- python -m vloam_tpu_torch run with no --device runs on the card.
- The host engine (run_sequence, VisualOdometry) with no device runs on the
  card, launches the kernels and agrees with its CPU run; lk_flow on the
  card agrees with the CPU on 99% of the keypoints.
- tools/timing.py::stage_clocks on a small LoamEngine polar frame
  (tools/profile_stages.py's split, on the state of two frames): the whole
  frame and each of its stages capture into a CUDA graph; the frame's
  replayed device time is positive and at most its wall; its kernel nodes
  are positive and equal the sum over its stages; its hand-written kernels
  are K1 once, ring_min1_packed 4 times, grid_probe once and row_gather
  twice, each in its stage.
- tools/profile_upload_overlap's four stagings of the polar chunk give
  identical rows on the card; tools/legacy_assoc's shortlist association
  gives the CPU's picks and distances.
"""

import numpy as np
import pytest
import torch

from vloam_tpu_torch import kernels
from vloam_tpu_torch.lidar import ring_assoc as ra
from vloam_tpu_torch.lidar import scan_registration as sr
from vloam_tpu_torch.tools import kernel_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(16833)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class _Sel:
    """The selection constants of ScanRegistrationConfig's defaults."""

    curvature_threshold = 0.1
    n_sectors = 6
    max_sharp_per_sector = 2
    max_less_sharp_per_sector = 20
    max_flat_per_sector = 4


def _rings(rng, S, R):
    curv = rng.exponential(0.3, (S, R)).astype(np.float32)
    curv[:, ::7] = np.float32(0.5)  # exact ties across the ring
    brk = rng.random((S, R)) < 0.05
    bf = np.concatenate([np.zeros((S, 1), np.int32),
                         np.cumsum(brk[:, 1:], 1, dtype=np.int32)], 1)
    counts = rng.integers(0, R + 1, S).astype(np.int32)
    counts[:4] = [0, 11, 17, R]  # empty, too short, shortest selectable, full
    return curv, bf, counts


@pytest.mark.parametrize("R", [2560, 4100])
def test_select_rings_kernel_matches_plain(cuda, rng, R):
    curv, bf, counts = (torch.from_numpy(a).to(cuda)
                        for a in _rings(rng, 64, R))
    n0 = kernels.LAUNCHES["select_rings"]
    got = sr.select_rings(curv, bf, counts, _Sel)
    want = sr.select_rings_plain(curv, bf, counts, _Sel)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["select_rings"] == n0 + 1
    assert (got != 0).sum() > 1000
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", kernel_cases.select_rings_cases(),
                         ids=lambda c: c.name)
def test_select_rings_kernel_crafted_cases(cuda, case):
    curv, bf, counts = (torch.from_numpy(a).to(cuda)
                        for a in (case.curv, case.bf, case.counts))
    got = sr.select_rings(curv, bf, counts, _Sel)
    want = sr.select_rings_plain(curv, bf, counts, _Sel)
    torch.cuda.synchronize()
    assert (want != 0).sum() > 100
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", kernel_cases.ring_min2_cases(),
                         ids=lambda c: c.name)
def test_ring_min2_kernel_crafted_cases(cuda, case):
    q = torch.from_numpy(case.queries).to(cuda)
    slab_t = torch.from_numpy(case.slab_t).to(cuda)
    got = ra.ring_min2(q, slab_t)
    want = ra.ring_min2_plain(q, slab_t)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("Q,C", [(768, 128), (1536, 512), (777, 5000)])
def test_ring_min2_kernel_matches_plain(cuda, rng, Q, C):
    S = 64
    slab = np.full((S, C, 3), ra.SENTINEL, np.float32)
    for s in range(1, S):
        n = int(rng.integers(1, C + 1))
        slab[s, :n] = rng.uniform(-40, 40, (n, 3))
    slab[3, 9] = slab[3, 2]  # duplicates: exact ties
    slab[3, C - 1] = slab[3, 2]
    q = rng.uniform(-40, 40, (Q, 3)).astype(np.float32)
    q[0] = slab[3, 2]
    q_t = torch.from_numpy(q).to(cuda)
    slab_t = torch.from_numpy(np.ascontiguousarray(
        slab.transpose(0, 2, 1))).to(cuda)
    n0 = kernels.LAUNCHES["ring_min2"]
    got = ra.ring_min2(q_t, slab_t)
    want = ra.ring_min2_plain(q_t, slab_t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ring_min2"] == n0 + 1
    for i in (1, 3):
        assert torch.equal(got[i], want[i])
    for i in (0, 2):
        torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=0)
    assert (got[1][0] == 0).all() and (got[3][0] == 1).all()  # all-SENTINEL
    assert int(got[1][3, 0]) == 2 and int(got[3][3, 0]) == 9


@pytest.mark.parametrize("Q,C", [(768, 128), (1536, 512), (777, 5000)])
def test_ring_min1_and_argmin2_kernels_match_plain_and_k2(cuda, rng, Q, C):
    S = 64
    slab = np.full((S, C, 3), ra.SENTINEL, np.float32)
    for s in range(1, S):
        n = int(rng.integers(1, C + 1))
        slab[s, :n] = rng.uniform(-40, 40, (n, 3))
    slab[3, 9] = slab[3, 2]  # duplicates: exact ties
    slab[3, C - 1] = slab[3, 2]
    q = rng.uniform(-40, 40, (Q, 3)).astype(np.float32)
    q[0] = slab[3, 2]
    q_t = torch.from_numpy(q).to(cuda)
    slab_t = torch.from_numpy(np.ascontiguousarray(
        slab.transpose(0, 2, 1))).to(cuda)
    n1, n2 = kernels.LAUNCHES["ring_min1"], kernels.LAUNCHES["ring_argmin2"]
    got1 = ra.ring_min1(q_t, slab_t)
    got2 = kernels.ring_argmin2(q_t, slab_t)
    k2 = ra.ring_min2(q_t, slab_t)
    want = ra.ring_min2_plain(q_t, slab_t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ring_min1"] == n1 + 1
    assert kernels.LAUNCHES["ring_argmin2"] == n2 + 1
    for g, w in zip(got1, ra.ring_min1_plain(q_t, slab_t)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for g, w, k in zip(got2, want, k2):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, k)
    assert int(got1[1][3, 0]) == 2 and int(got2[3][3, 0]) == 9


@pytest.mark.parametrize(
    "case", kernel_cases.ring_min2_cases() + kernel_cases.ring_min1_cases()
    + kernel_cases.ring_argmin2_cases(), ids=lambda c: c.name)
def test_ring_min1_and_argmin2_kernels_crafted_cases(cuda, case):
    q = torch.from_numpy(case.queries).to(cuda)
    slab_t = torch.from_numpy(case.slab_t).to(cuda)
    got1 = ra.ring_min1(q, slab_t)
    got2 = kernels.ring_argmin2(q, slab_t)
    k2 = ra.ring_min2(q, slab_t)
    torch.cuda.synchronize()
    for g, w, k in zip(got1, ra.ring_min1_plain(q, slab_t), k2):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, k)
    for g, w in zip(got2, ra.ring_min2_plain(q, slab_t)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("product", [True, False])
@pytest.mark.parametrize("Q,C", [(768, 128), (1536, 512), (777, 5000)])
def test_ring_min1_packed_kernel_matches_plain(cuda, rng, Q, C, product):
    S = 64
    slab = np.full((S, C, 3), ra.SENTINEL, np.float32)
    q = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    for s in range(1, S):  # candidates within a few metres of the queries
        n = int(rng.integers(1, C + 1))
        slab[s, :n] = q[rng.integers(0, Q, n)] + rng.normal(0, 2.0, (n, 3))
    slab[3, 9] = slab[3, 2]  # duplicates: exact ties
    q[0] = slab[3, 2]
    q_t = torch.from_numpy(q).to(cuda)
    slab_t = torch.from_numpy(np.ascontiguousarray(
        slab.transpose(0, 2, 1))).to(cuda)
    n0 = kernels.LAUNCHES["ring_min1_packed"]
    got = ra.ring_min1_packed(q_t, slab_t, product)
    plain = ra.ring_min1_mxu_plain if product else ra.ring_min1_packed_plain
    want = plain(q_t, slab_t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ring_min1_packed"] == n0 + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[1][3, 0]) == 2 and (got[1][0] == 0).all()


@pytest.mark.parametrize("product", [True, False])
@pytest.mark.parametrize(
    "case", kernel_cases.ring_packed_cases() + kernel_cases.ring_min2_cases()
    + kernel_cases.ring_min1_cases() + kernel_cases.ring_argmin2_cases(),
    ids=lambda c: c.name)
def test_ring_min1_packed_kernel_crafted_cases(cuda, case, product):
    q = torch.from_numpy(case.queries).to(cuda)
    slab_t = torch.from_numpy(case.slab_t).to(cuda)
    got = ra.ring_min1_packed(q, slab_t, product)
    plain = ra.ring_min1_mxu_plain if product else ra.ring_min1_packed_plain
    torch.cuda.synchronize()
    for g, w in zip(got, plain(q, slab_t)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("impl", ["mxu", "packed", "xla", "pallas"])
def test_ring_slab_assoc_on_card_equals_cpu(cuda, rng, impl):
    """Every impl's picks and distances on the card equal the CPU's: each
    kernel equals its plain version, and the rest is the same torch ops."""
    S, C = 64, 512
    q = rng.uniform(-20, 20, (1536, 3)).astype(np.float32)
    slab = np.full((S, C, 3), ra.SENTINEL, np.float32)
    for s in range(S):
        n = int(rng.integers(C // 2, C + 1))
        slab[s, :n] = q[rng.integers(0, len(q), n)] + rng.normal(
            0, 1.0, (n, 3))
    for mode in ("corner", "surf"):
        want = ra.ring_slab_assoc(torch.from_numpy(q),
                                  ra.RingSlab(torch.from_numpy(slab)), 2.5,
                                  mode, impl)
        got = ra.ring_slab_assoc(torch.from_numpy(q).to(cuda),
                                 ra.RingSlab(torch.from_numpy(slab).to(cuda)),
                                 2.5, mode, impl)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (mode, k)


@pytest.mark.parametrize("W,N", [(96, 16384), (48, 49152), (4, 1000),
                                 (128, 777), (260, 513), (48, 1), (96, 1),
                                 (48, 1001), (96, 2049), (48, 6143),
                                 (12, 4097), (4, 3)])
def test_row_gather_kernel_is_bit_identical(cuda, rng, W, N):
    from vloam_tpu_torch.lidar import gridmap

    nb = 1 << 12
    table = torch.from_numpy(
        rng.normal(size=(nb, W)).astype(np.float32)).to(cuda)
    table[5] = float("nan")  # payload bits travel untouched
    idx = rng.integers(0, nb, N)
    head = [nb - 1, 0, 5, 5, 7][:N]  # the last row first, repeats
    idx[:len(head)] = head
    idx = torch.from_numpy(idx).to(cuda)
    n0 = kernels.LAUNCHES["row_gather"]
    got = gridmap.row_gather(table, idx)
    want = gridmap.row_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["row_gather"] == n0 + 1
    assert got.shape == (N, W)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_row_gather_refuses_what_the_kernel_does_not_take(cuda):
    table = torch.zeros((64, 6), device=cuda)
    idx = torch.zeros((8,), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.row_gather(table, idx)
    with pytest.raises(ValueError, match="int64"):
        kernels.row_gather(torch.zeros((64, 8), device=cuda), idx.int())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.row_gather(torch.zeros((64, 16), device=cuda)[:, ::2], idx)
    assert kernels.row_gather(torch.zeros((64, 8), device=cuda),
                              idx[:0]).shape == (0, 8)


_PROBE_CASES = [c.name for c in kernel_cases.grid_probe_cases(n_buckets=16)]


def _probe(case, dev):
    """Both grids' candidates through the pair dispatcher on `dev`."""
    from vloam_tpu_torch.lidar import batch_mapping as bm
    from vloam_tpu_torch.lidar import gridmap

    S = case.n_streams
    args = []
    for table, q, cell in case.jobs:
        t = torch.from_numpy(table).to(dev)
        q = torch.from_numpy(q).to(dev)
        if S == 1:
            args += [gridmap.FeatureGrid(t, torch.zeros((), device=dev)), q,
                     cell]
        else:
            args += [bm.BatchFeatureGrid(t, torch.zeros((S,), device=dev)),
                     q.reshape(S, -1, 3), cell]
    if S == 1:
        return gridmap.grid_gather_pair(*args)
    return bm.batch_grid_gather_pair(*args, S)


def _plain(case, dev):
    from vloam_tpu_torch.lidar import batch_mapping as bm
    from vloam_tpu_torch.lidar import gridmap

    out = []
    for table, q, cell in case.jobs:
        t = torch.from_numpy(table).to(dev)
        q = torch.from_numpy(q).to(dev)
        if case.n_streams == 1:
            out.append(gridmap.grid_gather_plain(
                gridmap.FeatureGrid(t, None), q, cell))
        else:
            S = case.n_streams
            out.append(bm.batch_grid_gather_plain(
                bm.BatchFeatureGrid(t, None), q.reshape(S, -1, 3), cell, S))
    return out


@pytest.mark.parametrize("streams", [1, 4])
@pytest.mark.parametrize("name", _PROBE_CASES)
def test_grid_probe_kernel_matches_plain_pair(cuda, name, streams):
    """At the single engine's widths (2^17 buckets a stream, caps 32 and
    16, cells 2.0 and 2.4) and with the batch engine's 4 streams: the
    kernel's candidates equal the plain pair's on the card and on the CPU,
    bit for bit, in one launch for both grids."""
    case = next(c for c in kernel_cases.grid_probe_cases(
        n_buckets=1 << 17, n_streams=streams) if c.name == name)
    n0 = kernels.LAUNCHES["grid_probe"]
    got = _probe(case, cuda)
    want = _plain(case, cuda)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["grid_probe"] == n0 + 1
    cpu = _plain(case, "cpu")
    for g, w, c, (table, q, _) in zip(got, want, cpu, case.jobs):
        assert g.shape == (3, len(q), 8 * table.shape[1] // 3)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), c.view(torch.int32))


@pytest.mark.parametrize("caps", [(8, 12), (4, 20)])
def test_grid_probe_kernel_other_caps(cuda, caps):
    """Caps other than 32 and 16 take the kernel's generic path."""
    for case in kernel_cases.grid_probe_cases(caps=caps, n_streams=2):
        got = _probe(case, cuda)
        for g, w in zip(got, _plain(case, cuda)):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_grid_probe_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((8, 3), device=cuda)
    good = (torch.zeros((64, 48), device=cuda), q, 0.5, 64, 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.grid_probe([(torch.zeros((64, 30), device=cuda), q, 0.5, 64,
                             1)])
    with pytest.raises(ValueError, match="power of two"):
        kernels.grid_probe([(good[0], q, 0.5, 48, 1)])
    with pytest.raises(ValueError, match="do not fit"):
        kernels.grid_probe([(good[0], q, 0.5, 64, 3)])
    with pytest.raises(ValueError, match="do not fit"):
        kernels.grid_probe([(good[0], q, 0.5, 64, 2)])
    with pytest.raises(ValueError, match="1 or 2 jobs"):
        kernels.grid_probe([good] * 3)
    n0 = kernels.LAUNCHES["grid_probe"]
    outs = kernels.grid_probe([(good[0], q[:0], 0.5, 64, 1)] * 2)
    assert [o.shape for o in outs] == [(3, 0, 128)] * 2
    assert kernels.LAUNCHES["grid_probe"] == n0
    # one job alone
    from vloam_tpu_torch.lidar import gridmap

    table = torch.randn((64, 48), device=cuda)
    q = torch.randn((37, 3), device=cuda) * 3.0
    got, = kernels.grid_probe([(table, q, 0.5, 64, 1)])
    want = gridmap.grid_gather_plain(gridmap.FeatureGrid(table, None), q, 2.0)
    assert kernels.LAUNCHES["grid_probe"] == n0 + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_depth_grid_is_reproducible_on_card(cuda):
    """build_depth_grid twice on the card on one full-size frame (1242 x
    375): identical, and identical to the CPU's (no atomics; each cell adds
    its points in point order)."""
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.vision import depth_map

    cfg = kitti_hdl64().vo
    K, P_rect0, _, velo_T_cam = synthetic.default_cam_calib(
        cfg.img_width, cfg.img_height)
    P = torch.tensor(P_rect0 @ np.linalg.inv(velo_T_cam),
                     dtype=torch.float32)
    pts = torch.from_numpy(synthetic.simulate_scan(
        synthetic.urban_scene(2), np.eye(4), n_scans=64, n_azimuth=1800))
    mask = torch.ones(len(pts), dtype=torch.bool)
    mask[::7] = False
    grids = [depth_map.build_depth_grid(pts.to(cuda), mask.to(cuda),
                                        P.to(cuda), cfg) for _ in range(2)]
    cpu = depth_map.build_depth_grid(pts, mask, P, cfg)
    assert int(cpu.cnt.sum()) > 1000
    for a, b, c in zip(*grids, cpu):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), c)


def test_batch_engine_on_card_matches_cpu(cuda):
    from vloam_tpu_torch.config import tiny_test_profile
    from vloam_tpu_torch.lidar.loam_step import (BatchLoamEngine,
                                                 unpack_outputs)

    cfg = tiny_test_profile()
    scans = _xyz_drive(cfg)
    streams = [scans, scans[::-1]]

    def run(dev):
        eng = BatchLoamEngine(cfg, 2, chunk=2, device=dev)
        for k in range(len(scans)):
            for b in range(2):
                eng.push(b, streams[b][k])
        return eng.finish()

    kernels.reset_launches()
    gpu = run(cuda)
    n = 2 * len(scans)
    assert kernels.LAUNCHES["row_gather"] == 2 * len(scans)
    assert kernels.LAUNCHES["grid_probe"] == len(scans)
    assert kernels.LAUNCHES["ring_min1_packed"] == 4 * n
    assert kernels.LAUNCHES["ring_min1"] == kernels.LAUNCHES["ring_min2"] == 0
    assert kernels.LAUNCHES["select_rings"] == n
    cpu = run("cpu")
    for b in range(2):
        g, c = unpack_outputs(gpu[b]), unpack_outputs(cpu[b])
        np.testing.assert_allclose(g["t_w_lo"], c["t_w_lo"], atol=2e-2)
        np.testing.assert_allclose(g["t_w_mo"], c["t_w_mo"], atol=3e-2)


def _xyz_drive(cfg):
    from vloam_tpu_torch.data import synthetic

    scene = synthetic.urban_scene(42)
    poses = synthetic.drive_trajectory(4, speed=1.0, yaw_rate=0.015)
    return [synthetic.simulate_scan(scene, T, n_scans=cfg.lidar.n_scans,
                                    n_azimuth=500, seed=k)
            for k, T in enumerate(poses)]


def _run_engine(cfg, scans, dev):
    from vloam_tpu_torch.lidar.loam_step import LoamEngine

    eng = LoamEngine(cfg, chunk=2, device=dev)
    for s in scans:
        eng.push(s)
    return eng.finish()


def test_xyz_engine_on_card_matches_cpu(cuda):
    from vloam_tpu_torch.config import tiny_test_profile
    from vloam_tpu_torch.lidar.loam_step import unpack_outputs

    cfg = tiny_test_profile()
    scans = _xyz_drive(cfg)
    res = {}
    for dev in ("cpu", cuda):
        kernels.reset_launches()
        res[str(dev)] = (unpack_outputs(_run_engine(cfg, scans, dev)),
                         dict(kernels.LAUNCHES))
    (cpu, n_cpu), (gpu, n_gpu) = res["cpu"], res["cuda"]
    assert not any(n_cpu.values())
    # per frame: K1 once, 2 association rounds (the packed minimum, corner
    # and surf), both map probes in one grid_probe, 2 inserts through
    # row_gather
    assert n_gpu == {"select_rings": 4, "ring_min2": 0, "ring_min1": 0,
                     "row_gather": 8, "grid_probe": 4, "zncc_describe": 0,
                     "ring_argmin2": 0, "ring_min1_packed": 16,
                     "masked_knn": 0}
    np.testing.assert_allclose(gpu["t_w_lo"], cpu["t_w_lo"], atol=2e-2)
    np.testing.assert_allclose(gpu["t_w_mo"], cpu["t_w_mo"], atol=3e-2)


def _tf32_on_and_off(run):
    """run() with TF32 / "medium" matmul precision off, then on."""
    off = run()
    precision = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        on = run()
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return off, on


def test_engine_on_card_ignores_tf32_settings(cuda):
    """The CUDA path does its float32 products as broadcast multiplies and
    sums (no cuBLAS call), so a process that allows TF32 matmuls gets the
    same rows, bit for bit, as one that does not."""
    from vloam_tpu_torch.config import tiny_test_profile

    cfg = tiny_test_profile()
    scans = _xyz_drive(cfg)
    off, on = _tf32_on_and_off(lambda: _run_engine(cfg, scans, cuda))
    assert np.isfinite(off).all()
    np.testing.assert_array_equal(on, off)


def _vloam_drive(n=4, w=320, h=96, n_scans=16):
    """A small polar camera + LiDAR drive and its calibration."""
    from vloam_tpu_torch.data import synthetic

    scene = synthetic.urban_scene(2)
    K, P_rect0, _, velo_T_cam = synthetic.default_cam_calib(w, h)

    class Calib:
        pass

    calib = Calib()
    calib.K = K
    calib.P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    calib.imu_T_velo = np.eye(4)
    calib.imu_T_cam0 = velo_T_cam
    poses = synthetic.drive_trajectory(n, speed=1.0, yaw_rate=0.015)
    frames = [(synthetic.simulate_scan_polar(scene, T, n_scans=n_scans,
                                             n_azimuth=900, seed=k),
               synthetic.render_camera(scene, T @ velo_T_cam, K, w, h))
              for k, T in enumerate(poses)]
    return calib, frames


def test_vloam_engine_on_card_ignores_tf32_settings(cuda):
    """The combined engine's rows are bit-identical with TF32 allowed: its
    one cuBLAS product (the matcher's similarity) runs in float64."""
    from vloam_tpu_torch.config import tiny_test_profile
    from vloam_tpu_torch.vloam_step import VloamEngine

    cfg = tiny_test_profile().replace(detach_VO_LO=False)
    calib, frames = _vloam_drive()

    def run():
        eng = VloamEngine(cfg, calib, chunk=2, device=cuda)
        for r, img in frames:
            eng.push_polar(r, img)
        return eng.finish()

    kernels.reset_launches()
    off, on = _tf32_on_and_off(run)
    assert kernels.LAUNCHES == {"select_rings": 8, "ring_min2": 0,
                                "ring_min1": 0, "row_gather": 16,
                                "grid_probe": 8, "zncc_describe": 8,
                                "ring_argmin2": 0, "ring_min1_packed": 32,
                                "masked_knn": 0}
    assert np.isfinite(off).all() and (off[1:, 31] > 0).all()
    np.testing.assert_array_equal(on, off)


@pytest.mark.parametrize("p", [24, 16])
def test_zncc_describe_kernel_matches_plain(cuda, p):
    """K3 at the main path's shape: keypoints from detect_keypoints on a
    rendered 1242 x 375 frame, plus crafted rows at the corners (clipped
    patches) and on a constant patch (the floor)."""
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.vision import features as tf

    calib, frames = _vloam_drive(n=1, w=1242, h=375)
    img = torch.from_numpy(frames[0][1]).to(cuda)
    img[300:, :64] = 0.25  # a constant patch at the bottom-left
    vo = kitti_hdl64().vo
    xy, _, mask = tf.detect_keypoints(img, vo)
    assert int(mask.sum()) > 500
    crafted = torch.tensor([[0.0, 0.0], [1241.9, 0.0], [0.0, 374.9],
                            [1241.9, 374.9], [20.0, 350.0], [-3.5, 7.2],
                            [620.4, 187.6], [5.0, 200.0]], device=cuda)
    xy = torch.cat([xy[:-8], crafted]).contiguous()
    n0 = kernels.LAUNCHES["zncc_describe"]
    got = tf.zncc_describe(img, xy, p)
    want = tf.zncc_describe_plain(img, xy, p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["zncc_describe"] == n0 + 1
    assert got.shape == (2048, p * p)
    zero_g, zero_w = (got == 0).all(1), (want == 0).all(1)
    assert torch.equal(zero_g, zero_w) and bool(zero_g[-4])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", kernel_cases.zncc_cases(),
                         ids=lambda c: c.name)
def test_zncc_describe_kernel_crafted_cases(cuda, case):
    from vloam_tpu_torch.vision import features as tf

    H, W = case.img.shape
    flat = torch.zeros(H * W + 1, device=cuda)
    flat[1:] = torch.from_numpy(case.img.reshape(-1)).to(cuda)
    # the image as a tensor of its own, and 4 bytes into a larger buffer
    for img in (torch.from_numpy(case.img).to(cuda), flat[1:].view(H, W)):
        for K in (len(case.xy), len(case.xy) - 3):
            xy = torch.from_numpy(case.xy[:K]).to(cuda)
            n0 = kernels.LAUNCHES["zncc_describe"]
            got = tf.zncc_describe(img, xy, case.p)
            want = tf.zncc_describe_plain(img, xy, case.p)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["zncc_describe"] == n0 + 1
            assert torch.equal((got == 0).all(1), (want == 0).all(1))
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_cli_runs_on_the_card_by_default(cuda):
    """python -m vloam_tpu_torch with no --device runs on the card: the
    LiDAR path's kernels are launched (the CLI prints their counts)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "vloam_tpu_torch", "run", "--synthetic", "4",
         "--sensor", "tiny", "--mode", "lidar-only", "--chunk", "2"],
        cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "frames/s on cuda" in proc.stdout
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("kernel launches: ")]
    launches = json.loads(line[0][len("kernel launches: "):])
    assert launches["select_rings"] == 4 and launches["grid_probe"] == 4
    assert launches["ring_min1_packed"] == 16


def _host_drive(cfg, n=4):
    """A small xyz camera + LiDAR drive for the host engine, and its
    calibration."""
    from vloam_tpu_torch.data import synthetic

    calib, _ = _vloam_drive(n=0, w=cfg.vo.img_width, h=cfg.vo.img_height)
    scene = synthetic.urban_scene(2)
    velo_T_cam = calib.imu_T_cam0
    poses = synthetic.drive_trajectory(n, speed=1.0, yaw_rate=0.015)
    frames = [{"points": synthetic.simulate_scan(
                   scene, T, n_scans=cfg.lidar.n_scans, n_azimuth=900,
                   seed=k),
               "image": synthetic.render_camera(
                   scene, T @ velo_T_cam, calib.K, cfg.vo.img_width,
                   cfg.vo.img_height)}
              for k, T in enumerate(poses)]
    return calib, frames


def test_host_engine_runs_on_the_card_by_default(cuda):
    """run_sequence and VisualOdometry with no device run on the card: the
    host engine launches six of the kernels on every frame after the first
    (K3 on every frame), and its LO / MO trajectories agree with the same
    run on the CPU within the card-vs-CPU tolerances (LO 2e-2 m, MO 3e-2 m;
    the 16-ring drive's VO is too weakly constrained to compare, so it must
    be finite: chip_smoke.py compares VO at full width)."""
    from vloam_tpu_torch.config import tiny_test_profile
    from vloam_tpu_torch.pipeline import run_sequence
    from vloam_tpu_torch.vision.vo import VisualOdometry

    cfg = tiny_test_profile().replace(detach_VO_LO=False)
    calib, frames = _host_drive(cfg)
    vo = VisualOdometry(cfg.vo, calib.K, calib.P_velo_to_img)
    assert vo.device.type == "cuda" and vo.Kinv.device.type == "cuda"
    kernels.reset_launches()
    gpu = run_sequence(cfg, calib, frames)
    n = len(frames)
    # LO solves from frame 1 on: 2 association rounds (the packed minimum,
    # corner and surf); mapping's probe and 2 inserts, and K3, on every frame
    assert kernels.LAUNCHES == {"select_rings": n, "ring_min2": 0,
                                "ring_min1": 0, "row_gather": 2 * n,
                                "grid_probe": n, "zncc_describe": n,
                                "ring_argmin2": 0,
                                "ring_min1_packed": 4 * (n - 1),
                                "masked_knn": 0}
    cpu = run_sequence(cfg, calib, frames, device="cpu")
    assert np.isfinite(gpu["VO"]).all()
    for which, tol in (("LO", 2e-2), ("MO", 3e-2)):
        np.testing.assert_allclose(gpu[which], cpu[which], atol=tol,
                                   err_msg=which)


def test_lk_flow_on_card_matches_cpu(cuda):
    """lk_flow on the card against the CPU on a rendered frame pair (320 x
    96, the keypoints of the first): status agrees on at least 99% of the
    keypoints and xy1 within 0.01 px on at least 99% of those both track
    (the window sums add in another order on the card)."""
    from vloam_tpu_torch.config import tiny_test_profile
    from vloam_tpu_torch.vision.features import detect_keypoints
    from vloam_tpu_torch.vision.optical_flow import lk_flow

    cfg = tiny_test_profile()
    _, frames = _host_drive(cfg, n=2)
    imgs = [torch.from_numpy(f["image"]) for f in frames]
    xy0, _, mask = detect_keypoints(imgs[0], cfg.vo)
    cpu_xy, cpu_ok = lk_flow(imgs[0], imgs[1], xy0, cfg.vo)
    gpu_xy, gpu_ok = lk_flow(imgs[0].to(cuda), imgs[1].to(cuda),
                             xy0.to(cuda), cfg.vo)
    gpu_xy, gpu_ok = gpu_xy.cpu(), gpu_ok.cpu()
    assert cpu_ok[mask].sum() > 20
    assert (gpu_ok == cpu_ok)[mask].float().mean() >= 0.99
    both = mask & gpu_ok & cpu_ok
    close = (gpu_xy - cpu_xy).abs().amax(dim=1) <= 0.01
    assert close[both].float().mean() >= 0.99


# ---------------------------------------------------------------- masked_knn

def _knn_same(q, c, m, k, cuda):
    """The kernel (through lidar.knn.masked_knn) and masked_knn_plain on the
    same card tensors: indices and distance bits identical; one count a
    call; indices as the CPU's."""
    from vloam_tpu_torch.lidar import knn

    args = [torch.from_numpy(a).to(cuda) for a in (q, c, m)]
    n0 = kernels.LAUNCHES["masked_knn"]
    d, i = knn.masked_knn(*args, k=k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["masked_knn"] == n0 + 1
    d_p, i_p = knn.masked_knn_plain(*args, k=k)
    assert torch.equal(i, i_p)
    assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))
    _, i_c = knn.masked_knn_plain(*(a.cpu() for a in args), k=k)
    assert torch.equal(i.cpu(), i_c)


@pytest.mark.parametrize("case", kernel_cases.knn_cases(),
                         ids=lambda c: c.name)
def test_masked_knn_kernel_crafted_cases(cuda, case):
    _knn_same(case.queries, case.cands, case.mask, case.k, cuda)


@pytest.mark.parametrize(
    "case", [c for c in kernel_cases.knn_cases() if c.slices],
    ids=lambda c: c.name)
def test_masked_knn_kernel_at_the_cases_slices(cuda, case):
    """The cases laid out by slice, launched at the slices they are laid
    out for (not the wrapper's count): bit for bit with the plain version."""
    from vloam_tpu_torch.kernels import build
    from vloam_tpu_torch.lidar import knn
    from vloam_tpu_torch.tools.profile_knn import launcher

    q, c, m = (torch.from_numpy(a).to(cuda)
               for a in (case.queries, case.cands, case.mask))
    launch = launcher(str(build.build()), case.k)
    d, i = launch(q, c, m, knn._padding(c.shape[0], case.k), None,
                  slices=case.slices)
    d_p, i_p = knn.masked_knn_plain(q, c, m, k=case.k)
    assert torch.equal(i, i_p)
    assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))


@pytest.mark.parametrize("Q,C,k,live", [(777, 70001, 5, 0.4),
                                        (129, 4099, 1, 0.9),
                                        (2050, 33333, 8, 0.1),
                                        (5, 260, 5, 0.02)])
@pytest.mark.parametrize("blocks_per_sm", [4, 1, 16])
def test_masked_knn_kernel_matches_plain(cuda, rng, monkeypatch, Q, C, k,
                                         live, blocks_per_sm):
    """At 4, 1 and 16 slice blocks an SM."""
    monkeypatch.setattr(kernels, "KNN_BLOCKS_PER_SM", blocks_per_sm)
    q = rng.uniform(-80, 80, (Q, 3)).astype(np.float32)
    c = rng.uniform(-80, 80, (C, 3)).astype(np.float32)
    c[C // 2:C // 2 + 40] = c[7]  # equal distances across slices
    _knn_same(q, c, rng.random(C) < live, k, cuda)


def test_masked_knn_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((8, 3), device=cuda)
    c = torch.zeros((64, 3), device=cuda)
    m = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="k = 9"):
        kernels.masked_knn(q, c, m, 9, 0)
    with pytest.raises(ValueError, match="dtype"):
        kernels.masked_knn(q, c, m.to(torch.uint8), 5, 0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.masked_knn(q, torch.zeros((64, 6), device=cuda)[:, ::2], m,
                           5, 0)
    with pytest.raises(ValueError, match="candidates"):
        kernels.masked_knn(q, c[:3], m[:3], 5, 0)


def test_stage_clocks_capture_a_loam_frame(cuda):
    from vloam_tpu_torch.config import tiny_test_profile
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.geometry import so3
    from vloam_tpu_torch.lidar import loam_step as ls
    from vloam_tpu_torch.tools import profile_stages as ps
    from vloam_tpu_torch.tools.timing import stage_clocks

    cfg = tiny_test_profile()
    S, A = cfg.lidar.n_scans, 360
    scene = synthetic.urban_scene(0, extent=80.0)
    frames = [torch.from_numpy(synthetic.simulate_scan_polar(
        scene, T, n_scans=S, n_azimuth=A, seed=k).astype(np.int32)).to(cuda)
        for k, T in enumerate(synthetic.drive_trajectory(3, speed=1.1))]
    elev = torch.tensor(np.radians(synthetic.hdl64_elevations(S)),
                        dtype=torch.float32, device=cuda)
    dirs = sr.polar_directions(elev, A)
    pq, pt = so3.identity_quat(cuda), torch.zeros(3, device=cuda)
    up = torch.zeros((), dtype=torch.bool, device=cuda)

    def reg(r):
        return sr.register_scan_polar(r, dirs, cfg.lidar, cfg.scanreg)

    st = ls.LoamState.create(cfg, cuda)
    for r in frames[:2]:
        st = ls.loam_frame_step_feats(st, reg(r), pq, pt, up, cfg)[0]
    r = frames[2]
    whole = stage_clocks(lambda: ls.loam_frame_step_feats(
        st, reg(r), pq, pt, up, cfg), runs=2, device=cuda, replays=5)
    assert whole["capture_error"] is None
    assert whole["device_how"] == "graph replay"
    assert 0 < whole["device_ms"] <= whole["wall_ms"]
    assert whole["launches"] > 0
    assert whole["hand"] == {"select_rings": 1, "ring_min1_packed": 4,
                             "grid_probe": 1, "row_gather": 2}
    m = cfg.mapping
    feats = reg(r)
    lo = ps.lo_stage(st, feats, pq, pt, up, cfg)
    c = ps.voxel_stage(feats.less_sharp, m.line_resolution,
                       m.corner_stack_cap)
    s = ps.voxel_stage(feats.less_flat, m.plane_resolution, m.surf_stack_cap)
    mp = ps.mapping_stage(st, lo, (*c, *s), cfg)
    parts = [stage_clocks(fn, runs=1, device=cuda, replays=5) for fn in (
        lambda: reg(r), lambda: ps.lo_stage(st, feats, pq, pt, up, cfg),
        lambda: ps.voxel_stage(feats.less_sharp, m.line_resolution,
                               m.corner_stack_cap),
        lambda: ps.voxel_stage(feats.less_flat, m.plane_resolution,
                               m.surf_stack_cap),
        lambda: ps.mapping_stage(st, lo, (*c, *s), cfg),
        lambda: ps.tail_stage(st, feats, lo, mp))]
    assert all(p["capture_error"] is None for p in parts)
    assert sum(p["launches"] for p in parts) == whole["launches"]
    assert [p["hand"] for p in parts] == [
        {"select_rings": 1}, {"ring_min1_packed": 4}, {}, {},
        {"grid_probe": 1, "row_gather": 2}, {}]


def test_upload_modes_give_identical_rows_on_card(cuda, tmp_path,
                                                  monkeypatch):
    """tools/profile_upload_overlap's four stagings of the polar chunk on
    the card (one upload a chunk or a frame, with and without pack12) at
    the tiny profile over 2 timed chunks: rows bit for bit equal, each
    mode's copies timed by their events."""
    import tempfile

    from vloam_tpu_torch.tools import profile_upload_overlap as upo

    from vloam_tpu_torch.lidar.loam_step import LoamEngine, _polar_dirs
    from vloam_tpu_torch.tools.stages import profile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rec = upo.run(cuda, tiny=True, chunk=2, n_chunks=2, turns=1)
    assert rec["rows_equal"]
    assert [m["mode"] for m in rec["modes"]] == list(upo.MODES)
    for m in rec["modes"]:
        assert m["fps"] > 0 and m["copy_ms"] > 0
        # one copy a chunk (A, C) or a frame (B, D) over the timed chunks
        assert m["copies"] == (2 if m["mode"] in "AC" else 4)
    # mode A's uploads on the card are the engine's own
    cfg, n_az = profile(True)
    frames = upo.drive(6, cfg.lidar.n_scans, n_az, 1)
    rows = upo.run_mode("A", frames, cfg, cuda, 2, 2,
                        _polar_dirs(cfg, n_az, None, cuda))["rows"]
    eng = LoamEngine(cfg, chunk=2, device=cuda)
    for f in frames:
        eng.push_polar(f, range_scale=upo.RANGE_SCALE)
    np.testing.assert_array_equal(eng.finish().view(np.int32),
                                  rows.view(np.int32))


@pytest.mark.parametrize("mode", ["corner", "surf"])
def test_shortlist_assoc_on_card_equals_cpu(cuda, rng, mode):
    """tools/legacy_assoc.shortlist_ring_assoc: every pick and distance on
    the card equal to the CPU's (the distances' multiply-adds emulated in
    float64 on both)."""
    from vloam_tpu_torch.tools.legacy_assoc import shortlist_ring_assoc

    Q, C = 777, 9000
    q = rng.uniform(-40, 40, (Q, 3)).astype(np.float32)
    c = (q[rng.integers(0, Q, C)] + rng.normal(0, 0.5, (C, 3))).astype(
        np.float32)
    ring = rng.integers(0, 64, C).astype(np.int32)
    mask = rng.uniform(size=C) < 0.8
    args = [torch.from_numpy(a) for a in (q, c, ring, mask)]
    cpu = shortlist_ring_assoc(*args, 2.5, mode, 24)
    card = shortlist_ring_assoc(*(a.to(cuda) for a in args), 2.5, mode, 24)
    for k in cpu:
        assert torch.equal(card[k].cpu(), cpu[k]), k
    assert torch.isfinite(cpu["d2"]).float().mean() > 0.5
