"""Crafted inputs for the kernels whose rules are easiest to get wrong: K1
select_rings (strict sector selection), K2 ring_min2 (per-ring 2-smallest),
S1 ring_min1 (per-ring minimum) and ring_argmin2 (argmin, mask, argmin),
ring_min1_packed (the packed-key minimum of the quantized forms), K3
zncc_describe (patch descriptors), S2 grid_probe (the map's 8-cell probe)
and masked_knn (the mesh chunk's window sweep); and the 5-point covariances
of the mapping's line test (solver/eig3.py). Plain numpy from a seed; no
device logic.

The same cases are used three times: the CPU tests hold the plain PyTorch
versions to the JAX package on them (tests/test_torch_scan_registration.py,
tests/test_torch_ring_assoc.py, tests/test_torch_vision.py,
tests/test_torch_knn.py), the GPU tests
hold the kernels to the plain versions (tests/test_torch_kernels_cuda.py),
and so does chip_smoke.py.

K1 cases use the default selection constants (6 sectors, threshold 0.1,
2 sharp / 20 corner / 4 flat picks a sector, gap^2 0.05). Each carries the
points that produce its break prefix, since the JAX package's per-ring
selection and tests/np_loam.py derive the gaps from points.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..lidar.ring_assoc import SENTINEL

N_SECTORS = 6
THRESHOLD = np.float32(0.1)
_S = 8  # rings a case (the JAX Pallas reduction wants a multiple of 8)


class SelectCase(NamedTuple):
    name: str
    pts: np.ndarray  # [S, R, 3] f32: consecutive gaps give bf
    curv: np.ndarray  # [S, R] f32
    bf: np.ndarray  # [S, R] int32 break prefix
    counts: np.ndarray  # [S] int32
    # False where tests/np_loam.py::select_ring_np follows another rule: it
    # takes equal corner curvatures from the highest index down and picks NaN
    # as the largest curvature
    numpy_rule: bool = True


class Min2Case(NamedTuple):
    name: str
    queries: np.ndarray  # [Q, 3] f32
    slab: np.ndarray  # [S, C, 3] f32, dead slots at SENTINEL

    @property
    def slab_t(self) -> np.ndarray:
        """[S, 3, C], the layout the reductions take."""
        return np.ascontiguousarray(np.swapaxes(self.slab, 1, 2))


class ProbeCase(NamedTuple):
    name: str
    n_streams: int  # the queries are n_streams equal runs, one per table
    n_buckets: int  # per stream; table rows n_streams * n_buckets
    # (table [n_streams * n_buckets, 3*cap] f32, queries [Q, 3] f32, cell)
    # of the corner grid, then of the surf grid
    jobs: tuple


class KnnCase(NamedTuple):
    name: str
    queries: np.ndarray  # [Q, 3] f32
    cands: np.ndarray  # [C, 3] f32
    mask: np.ndarray  # [C] bool
    k: int
    # False for the mesh-window-sized case: held on the card only (2.7e8
    # pairs; the CPU tests hold the small cases against JAX)
    small: bool = True
    # the slices the mask is laid out for (0: none; slice s holds the
    # 256-slot tiles s, s + slices, ...): the card's tests launch the kernel
    # at that count too
    slices: int = 0


class ZnccCase(NamedTuple):
    name: str
    img: np.ndarray  # [H, W] f32
    xy: np.ndarray  # [K, 2] f32 pixel coordinates (x, y), K a multiple of 8
    p: int


def sector_bounds(count: int, j: int) -> tuple[int, int]:
    """First and last point of sector j of a ring of `count` points."""
    width = count - 11
    return (5 + width * j // N_SECTORS,
            5 + width * (j + 1) // N_SECTORS - 1)


def _select_case(name, curv, brk, counts, numpy_rule=True) -> SelectCase:
    """brk[s, i]: a gap break between points i-1 and i. Points run along x
    in steps of 0.1 (gap^2 0.01, connected) or 1.0 (gap^2 1, a break)."""
    brk = brk.copy()
    brk[:, 0] = False
    x = np.cumsum(np.where(brk, 1.0, 0.1), axis=1)
    pts = np.zeros(curv.shape + (3,), np.float32)
    pts[..., 0] = x
    return SelectCase(name, pts, curv.astype(np.float32),
                      np.cumsum(brk, axis=1).astype(np.int32),
                      np.asarray(counts, np.int32), numpy_rule)


def _random_ring(rng, R):
    return (rng.exponential(0.3, (_S, R)).astype(np.float32),
            rng.random((_S, R)) < 0.05)


def select_rings_cases(seed: int = 16833) -> list[SelectCase]:
    rng = np.random.default_rng(seed)
    R = 1800
    full = np.full(_S, R)
    cases = []

    # a pick at ep-4 .. ep whose window crosses into the next sector, whose
    # first points would otherwise be that sector's first picks
    curv, brk = _random_ring(rng, R)
    for s in range(_S):
        d = s % 5
        for j in range(N_SECTORS - 1):
            ep = sector_bounds(R, j)[1]
            curv[s, ep - d] = 50.0 + j
            curv[s, ep + 1:ep + 6] = 40.0 + np.arange(5)
            brk[s, ep - 6:ep + 8] = False
            if s == 5:
                brk[s, ep + 1] = True  # the gap at the boundary: no crossing
            if s == 6:
                brk[s, ep + 3] = True  # the window stops inside the next one
    brk[7] = False
    cases.append(_select_case("window_crosses_sector_end", curv, brk, full))

    # a chain of carries: curvature falls along the ring, so each sector picks
    # every 6th point from its first on, and where a window crosses a
    # sector's end the next sector's whole lattice shifts, and with it what
    # that sector hands on (sectors of 60 to 62 points)
    curv, brk = _random_ring(rng, R)
    curv[:] = 100.0 - 0.01 * np.arange(R, dtype=np.float32)
    brk[:4] = False
    cases.append(_select_case("carry_chain", curv, brk,
                              371 + np.arange(_S)))

    # equal curvatures: the lowest index wins, round after round
    curv, brk = _random_ring(rng, R)
    curv[0] = 0.5
    curv[1] = 0.01
    curv[2:] = rng.integers(0, 6, (_S - 2, R)) * np.float32(0.05)
    for j in range(N_SECTORS):
        sp, ep = sector_bounds(R, j)
        curv[3, sp:ep + 1] = 0.2 + j
    brk[0] = brk[1] = False
    cases.append(_select_case("equal_curvatures", curv, brk, full,
                              numpy_rule=False))

    # empty, too short, the shortest selectable (sectors of one point, so a
    # window crosses several sectors), narrow sectors, a full ring
    curv, brk = _random_ring(rng, R)
    brk[3] = brk[5] = False
    cases.append(_select_case("ring_lengths", curv, brk,
                              [0, 11, 16, 17, 18, 23, 40, R]))

    # sectors whose candidates run out before the rounds do
    curv, brk = _random_ring(rng, R)
    curv[0] = 0.05  # no corner anywhere
    curv[1] += 5.0  # no flat anywhere
    curv[2:5] = THRESHOLD  # neither, except:
    sp, ep = sector_bounds(R, 0)
    curv[2, [sp + 3, sp + 100, ep]] = [3.0, 2.0, 1.0]
    curv[3, [sp, sp + 50]] = [0.01, 0.02]
    curv[4, sp + 20:sp + 32] = 1.0 + np.arange(12)  # one window eats them
    brk[4] = False
    cases.append(_select_case("candidates_run_out", curv, brk, full))

    # curvature exactly at the threshold is neither corner nor flat
    curv, brk = _random_ring(rng, R)
    at = rng.random((_S, R))
    curv[at < 0.3] = THRESHOLD
    curv[(at >= 0.3) & (at < 0.35)] = np.nextafter(THRESHOLD, np.float32(1))
    curv[(at >= 0.35) & (at < 0.4)] = np.nextafter(THRESHOLD, np.float32(0))
    curv[0] = THRESHOLD
    cases.append(_select_case("at_the_threshold", curv, brk, full))

    # NaN is never a candidate; 0.0 and -0.0 tie
    curv, brk = _random_ring(rng, R)
    what = rng.random((_S, R))
    curv[what < 0.05] = np.nan
    curv[(what >= 0.05) & (what < 0.10)] = 0.0
    curv[(what >= 0.10) & (what < 0.12)] = -0.0
    curv[0] = np.nan
    curv[1, ::2] = 0.0
    curv[1, 1::2] = -0.0
    curv[2, ::3] = -0.0
    brk[1] = False
    cases.append(_select_case("nan_and_zero", curv, brk, full,
                              numpy_rule=False))

    # other ring widths: 2560 (the main path's capacity), 4100, and 7000,
    # whose sectors are longer than 32 x 32 points
    for R in (2560, 4100, 7000):
        curv, brk = _random_ring(rng, R)
        counts = rng.integers(0, R + 1, _S)
        counts[:4] = [0, 11, 17, R]
        cases.append(_select_case(f"width_{R}", curv, brk, counts))
    return cases


def _random_slab(rng, C, live=None):
    """Random points in [-40, 40]^3; ring s keeps a random live prefix (all
    of it when live is True), the rest is SENTINEL."""
    slab = np.full((_S, C, 3), SENTINEL, np.float32)
    for s in range(_S):
        n = C if live else int(rng.integers(1, C + 1))
        slab[s, :n] = rng.uniform(-40, 40, (n, 3))
    return slab


def ring_min2_cases(seed: int = 16833) -> list[Min2Case]:
    rng = np.random.default_rng(seed)

    def queries(Q):
        return rng.uniform(-40, 40, (Q, 3)).astype(np.float32)

    # query and slot counts that are no multiple of any block, tile or chunk
    cases = [Min2Case(f"shape_{Q}x{C}", queries(Q), _random_slab(rng, C))
             for Q, C in ((777, 130), (1, 5), (33, 2), (100, 5000))]

    # duplicate points inside a chunk and on both sides of chunk and tile
    # boundaries; query s sits on ring s's duplicated point
    slab = _random_slab(rng, 1100, live=True)
    q = queries(64)
    pairs = ((2, 6), (3, 4), (7, 8), (15, 16), (255, 256), (511, 512),
             (1023, 1024), (5, 1099))
    for s, (a, b) in enumerate(pairs):
        slab[s, b] = slab[s, a]
        q[s] = slab[s, a]
    slab[0, 700] = slab[0, 2]  # a third copy, later
    cases.append(Min2Case("duplicates_across_chunks", q, slab))

    # the second minimum in an earlier chunk than the first
    slab = _random_slab(rng, 130, live=True)
    q = queries(40)
    for s in range(_S):
        slab[s, 100] = q[s] + np.float32(0.01)
        slab[s, 3 + s] = q[s] + np.float32(0.02)
    cases.append(Min2Case("second_before_first", q, slab))

    # SENTINEL everywhere, around one live slot and between live slots
    slab = _random_slab(rng, 130, live=True)
    slab[0] = SENTINEL
    slab[1] = SENTINEL
    slab[1, 37] = [1.0, 2.0, 3.0]
    slab[2, ::2] = SENTINEL
    slab[3, :129] = SENTINEL
    slab[4, :8] = SENTINEL
    slab[4, 16:] = SENTINEL
    slab[5][rng.random(130) < 0.7] = SENTINEL
    cases.append(Min2Case("sentinel_slots", queries(50), slab))
    return cases


def ring_min1_cases(seed: int = 16834) -> list[Min2Case]:
    """Min-only slab shapes that ring_min1's block shape (queries a block,
    chunks split between groups, tiles of 512 slots) divides unevenly, ring 0
    all SENTINEL in each; and equal minima on both sides of chunk, group and
    tile boundaries."""
    rng = np.random.default_rng(seed)

    def queries(Q):
        return rng.uniform(-40, 40, (Q, 3)).astype(np.float32)

    cases = []
    for Q, C in ((1, 2), (255, 7), (257, 9), (769, 129), (769, 513),
                 (257, 513), (1, 129), (255, 9), (769, 2)):
        slab = _random_slab(rng, C)
        slab[0] = SENTINEL
        cases.append(Min2Case(f"min1_{Q}x{C}", queries(Q), slab))

    # query s sits on a point of ring s that a later slot repeats: across a
    # chunk, the halves of a 128- or 512-slot ring (2 groups), its quarters
    # (4 groups), a tile boundary and the first and the last tile
    slab = _random_slab(rng, 1100, live=True)
    q = queries(96)
    pairs = ((60, 64), (30, 100), (250, 260), (500, 515), (5, 1090),
             (700, 1030), (127, 128), (3, 4))
    for s, (a, b) in enumerate(pairs):
        slab[s, b] = slab[s, a]
        q[s] = slab[s, a]
    cases.append(Min2Case("min1_duplicates_across_groups", q, slab))
    return cases


def ring_argmin2_cases(seed: int = 16835) -> list[Min2Case]:
    """ring_argmin2's rules: the runner-up at the winner's distance (a
    duplicated point) and two runners-up at one distance, the winner in the
    last slot (of a ragged last chunk and of a full one), slot counts that
    are no multiple of a chunk or of ring_min1's 512-slot tile, and rings
    that are all SENTINEL but one."""
    rng = np.random.default_rng(seed)

    def queries(Q):
        return rng.uniform(-40, 40, (Q, 3)).astype(np.float32)

    # query s: its point at slot a, repeated at slot b > a (the runner-up
    # ties the winner), and ring s's point c, repeated at d > c, just off
    # the query (two runners-up at one distance when a == b is masked)
    slab = _random_slab(rng, 600, live=True)
    q = queries(40)
    ties = ((0, 1, 2, 3), (5, 300, 7, 8), (515, 2, 40, 599), (3, 4, 513, 514),
            (599, 511, 100, 101), (128, 129, 1, 0), (250, 251, 252, 253),
            (10, 590, 590, 591))
    for s, (a, b, c, d) in enumerate(ties):
        near = q[s] + np.float32(0.5)
        slab[s, c] = slab[s, d] = near
        slab[s, a] = slab[s, b] = q[s]
    cases = [Min2Case("argmin2_ties", q, slab)]

    # the winner in the last slot: C = 130 ends in a chunk of 2 slots, 512 in
    # a whole chunk and tile
    for C in (130, 512):
        slab = _random_slab(rng, C, live=True)
        q = queries(70)
        for s in range(_S):
            slab[s, C - 1] = q[s]
            slab[s, s] = q[s] + np.float32(0.25)  # the runner-up, early
        cases.append(Min2Case(f"argmin2_last_slot_{C}", q, slab))

    for Q, C in ((129, 7), (300, 129), (257, 513), (70, 1025)):
        cases.append(Min2Case(f"argmin2_{Q}x{C}", queries(Q),
                              _random_slab(rng, C)))

    slab = np.full((_S, 133, 3), SENTINEL, np.float32)
    slab[3, 77] = [1.0, 2.0, 3.0]
    cases.append(Min2Case("argmin2_all_sentinel", queries(65), slab))
    return cases


def ring_packed_cases(seed: int = 16836) -> list[Min2Case]:
    """The packed-key minimum's rules, on candidates near the queries (the
    random cases above put most minima past the 64 m^2 clip): quantized
    ties broken by the lower slot, whose exact distance is the larger
    (candidates 1e-6 to 1e-5 m^2 apart, steps of 3e-5 m^2 at C = 512),
    exact duplicates, a ring whose candidates all lie past the clip (slot
    0), an all-SENTINEL ring, and a dense 4 m cloud at counts no block or
    tile divides."""
    rng = np.random.default_rng(seed)
    cases = []
    for C in (512, 130):
        q = rng.uniform(-20, 20, (96, 3)).astype(np.float32)
        slab = np.full((_S, C, 3), SENTINEL, np.float32)
        for s in range(_S):
            slab[s] = q[rng.integers(0, len(q), C)] + rng.normal(
                0, 1.0, (C, 3)).astype(np.float32)
        for i in range(len(q)):  # query i: two near-equal candidates
            s, a = i % _S, int(rng.integers(0, C - 1))
            b = int(rng.integers(a + 1, C))
            off = rng.normal(0, 1, 3)
            off /= np.linalg.norm(off)
            slab[s, b] = q[i] + np.float32(0.5) * off.astype(np.float32)
            slab[s, a] = q[i] + np.float32(0.5 + 1e-5 * rng.random()) \
                * off.astype(np.float32)
        slab[5, 40] = slab[5, 7]  # exact duplicates
        slab[6] = 100.0  # all past the clip from every query
        slab[7] = SENTINEL
        cases.append(Min2Case(f"packed_quant_ties_{C}", q, slab))
    for Q, C in ((769, 513), (255, 9), (33, 2)):
        q = rng.uniform(0, 4, (Q, 3)).astype(np.float32)
        slab = rng.uniform(0, 4, (_S, C, 3)).astype(np.float32)
        slab[0, C // 2:] = SENTINEL
        cases.append(Min2Case(f"packed_dense_{Q}x{C}", q, slab))
    for C in (64, 65, 128, 512):
        cases.append(_packed_steps(rng, C))
    cases.append(_packed_negative(rng))
    # counts that ring_min1_packed's blocks (32 x 2 or 32 x 4 queries), warp
    # shares and unrolled steps do not divide, one over three tiles
    for Q, C in ((97, 67), (161, 509), (45, 1027)):
        q = rng.uniform(-3, 3, (Q, 3)).astype(np.float32)
        slab = rng.uniform(-4, 4, (_S, C, 3)).astype(np.float32)
        slab[1, ::3] = SENTINEL
        cases.append(Min2Case(f"packed_ragged_{Q}x{C}", q, slab))
    return cases


def _fma32(a, b, c):
    """a * b + c rounded once to float32 (a, b, c float32), or None where
    the float64 sum lies on a float32 rounding midpoint (double rounding
    could bite there)."""
    s = np.float64(a) * np.float64(b) + np.float64(c)
    if (int(np.array(s).view(np.int64)) & 0x1FFFFFFF) == 0x10000000:
        return None
    return np.float32(s)


def _point_at(d: np.float32, rng) -> tuple[np.float32, np.float32]:
    """(x, y) such that the point (x, y, 0) lies at squared distance d from
    the origin exactly as both packed forms round it there: fma(y, y, x*x)
    (the difference form's dz and the product form's |q|^2 and q.c are 0)."""
    for _ in range(1000):
        x = np.float32(np.sqrt(d) * rng.uniform(0.5, 0.99))
        a = x * x
        y = np.float32(np.sqrt(np.float64(d) - np.float64(a)))
        for _ in range(4):
            for cand in (y, np.nextafter(y, np.float32(np.inf)),
                         np.nextafter(y, np.float32(0))):
                if _fma32(cand, cand, a) == d:
                    return x, cand
            y = np.nextafter(y, np.float32(np.inf))
    raise ValueError(f"no point at squared distance {d}")


def _packed_steps(rng, C: int) -> Min2Case:
    """The fast truncation's boundaries, one ring each for the queries at
    the origin: d * scale exactly an integer n and one ulp below n + 1 (for
    two random n), d at the clip, one ulp below and one above it, and (ring
    7) the count just under the clip's (2^23 - 10 at C = 65 and 128) or, at
    C = 64 (6 slot bits: the conversion path), d * scale = 2^23, which the
    fast path's binade cannot hold (the clip's count is 2^24 - 17 there).
    The boundary point sits at slot 0, C - 1, C / 2 or 1; the ring's other
    slots lie farther from the origin, a fifth of them SENTINEL. Half the
    queries are at the origin, the rest near it."""
    bits = max(1, (C - 1).bit_length())
    scale = np.float32(2.0 ** (24 - bits))  # lidar.ring_assoc._quant's
    clip = np.float32(64.0 * 0.999999)
    top = int(clip * scale)  # the clip's count

    def at_count(n):
        return np.float32(n) / scale  # exact: scale is a power of two

    inf, zero = np.float32(np.inf), np.float32(0)
    # counts below 2^22, where d has units finer than a count
    n1, n2 = (int(v) for v in rng.integers(1, min(top, 1 << 22), 2))
    targets = [at_count(n1), np.nextafter(at_count(n1 + 1), zero),
               at_count(n2), np.nextafter(at_count(n2 + 1), zero),
               clip, np.nextafter(clip, zero), np.nextafter(clip, inf),
               at_count(1 << 23) if bits < 7 else at_count(top - 1)]
    q = np.zeros((64, 3), np.float32)
    q[32:] = rng.uniform(-3, 3, (32, 3))
    slab = np.full((_S, C, 3), SENTINEL, np.float32)
    for s, d in enumerate(targets):
        r = float(np.sqrt(d))
        far = rng.normal(0, 1, (C, 3))
        far *= (r + rng.uniform(0.5, 6, (C, 1))) / np.linalg.norm(
            far, axis=1, keepdims=True)
        slab[s] = far.astype(np.float32)
        slab[s, rng.random(C) < 0.2] = SENTINEL
        x, y = _point_at(d, rng)
        slab[s, (0, C - 1, C // 2, 1)[s % 4]] = [x, y, 0.0]
    return Min2Case(f"packed_steps_{C}", q, slab)


def _packed_negative(rng) -> Min2Case:
    """Candidates one ulp from their query in each coordinate, at 20-60 m:
    the product form's (|q|^2 + |c|^2) - 2 q.c comes out below 0 for some
    (cancellation) and is held at 0, so equal keys tie on the lower slot."""
    C = 128
    q = rng.uniform(20, 60, (96, 3)).astype(np.float32)
    q *= rng.choice([-1, 1], q.shape).astype(np.float32)
    slab = rng.uniform(-60, 60, (_S, C, 3)).astype(np.float32)
    inf = np.float32(np.inf)
    for i in range(len(q)):
        s = i % _S
        for _ in range(3):  # a few near twins, anywhere in the ring
            step = rng.choice([-1, 0, 1], 3)
            twin = np.where(step > 0, np.nextafter(q[i], inf),
                            np.where(step < 0, np.nextafter(q[i], -inf),
                                     q[i]))
            slab[s, int(rng.integers(0, C))] = twin
    return Min2Case("packed_negative", q, slab)


def _probe_table(rng, rows: int, cap: int, empty: float) -> np.ndarray:
    """Bucket rows [rows, 3*cap] x|y|z, each with a random number of live
    slots (a share `empty` of the rows none) in random places, the other
    slots SENTINEL."""
    live = rng.integers(1, cap + 1, rows)
    live[rng.random(rows) < empty] = 0
    live[:2] = [0, cap]  # an empty row and a full one
    mask = rng.random((rows, cap)).argsort(1) < live[:, None]
    xyz = rng.uniform(-90, 90, (3, rows, cap)).astype(np.float32)
    xyz[:, ~mask] = SENTINEL
    return np.ascontiguousarray(xyz.transpose(1, 0, 2).reshape(rows, 3 * cap))


def _on_borders(rng, n: int, cell: float) -> np.ndarray:
    """Queries whose coordinates each sit at a cell's midpoint (s - c ==
    0.5 exactly, for s = q * float32(1 / cell)), on a cell border, one ulp
    below one, or anywhere, negative ones included."""
    inv = np.float32(1.0) / np.float32(cell)
    c = rng.integers(-60, 60, (n, 3)).astype(np.float32)
    mids = (c + np.float32(0.5)) * np.float32(cell)
    # keep the candidates whose scaled value is exactly the midpoint
    for _ in range(8):
        bad = (mids * inv - c) != np.float32(0.5)
        mids[bad] = np.nextafter(mids[bad], np.float32(np.inf) * np.sign(
            (c[bad] + np.float32(0.5)) - mids[bad] * inv))
    mids = np.where((mids * inv - c) == np.float32(0.5), mids,
                    np.float32(cell) * c)
    border = c * np.float32(cell)
    below = np.nextafter(border, np.float32(-np.inf))
    anywhere = rng.uniform(-150, 150, (n, 3)).astype(np.float32)
    pick = rng.integers(0, 4, (n, 3))
    return np.choose(pick, [mids, border, below, anywhere]).astype(np.float32)


def grid_probe_cases(seed: int = 16836, n_buckets: int = 1 << 10,
                     caps=(32, 16), cells=(2.0, 2.4),
                     n_streams: int = 3) -> list[ProbeCase]:
    """The map probe's cases at the engines' bucket capacities (corner 32,
    surf 16) and cells (2.0, 2.4 m): coordinates of both signs; queries at
    cell midpoints (s - c == 0.5), on borders and one ulp below them; one
    job with no query (either grid); tables of mostly empty, all-SENTINEL
    rows; and n_streams streams in one flat table, whose last stream's rows
    the probe reaches."""
    rng = np.random.default_rng(seed)

    def jobs(qs, streams=1, empty=0.2):
        return tuple((_probe_table(rng, streams * n_buckets, cap, empty),
                      q, cell) for cap, q, cell in zip(caps, qs, cells))

    def uniform(n, lo=-150.0, hi=150.0):
        return rng.uniform(lo, hi, (n, 3)).astype(np.float32)

    return [
        ProbeCase("both_signs", 1, n_buckets, jobs((uniform(300),
                                                    uniform(700)))),
        ProbeCase("cell_borders", 1, n_buckets, jobs(
            tuple(_on_borders(rng, 512, c) for c in cells))),
        ProbeCase("no_corner_query", 1, n_buckets,
                  jobs((uniform(0), uniform(333)))),
        ProbeCase("no_surf_query", 1, n_buckets,
                  jobs((uniform(77), uniform(0)))),
        ProbeCase("sentinel_rows", 1, n_buckets,
                  jobs((uniform(200, -20, 20), uniform(200, -20, 20)),
                       empty=0.9)),
        ProbeCase("streams", n_streams, n_buckets, jobs(
            (uniform(n_streams * 64), _on_borders(rng, n_streams * 160,
                                                  cells[1])), n_streams)),
    ]


def _patch_at(x0: int, y0: int, p: int) -> list[float]:
    """A keypoint whose p x p patch starts at (y0, x0)."""
    return [x0 + p // 2 + 0.5, y0 + p // 2 + 0.5]


def zncc_cases(seed: int = 16833) -> list[ZnccCase]:
    """Images of uint8 grey levels (as the engines see them), 390 or 397
    columns (row starts at every 16-byte alignment), keypoints at the four
    corners, past every edge, at negative and .999 coordinates; flat
    patches, exactly constant and with a zero-mean checkerboard whose centred
    norm lies below or above the 1e-3 floor by 1.6x or more; p = 24, 16
    and 7."""
    rng = np.random.default_rng(seed)
    cases = []
    for p, W, H in ((24, 390, 80), (16, 390, 80), (7, 397, 41)):
        img = (rng.integers(0, 256, (H, W)) / 255.0).astype(np.float32)
        edge = [[0.0, 0.0], [W - 0.001, 0.0], [0.0, H - 0.001],
                [W - 0.001, H - 0.001], [-5.0, 40.0], [W + 7.0, 30.0],
                [100.0, -9.0], [120.0, H + 12.0], [-0.5, -0.5],
                [-30.2, 10.7], [50.999, 30.999], [123.999, 7.999],
                [W - 1.999, 20.5], [-1e4, 1e4]]
        rest = np.stack([rng.uniform(0, W, 40 - len(edge)),
                         rng.uniform(0, H, 40 - len(edge))], 1)
        xy = np.concatenate([np.asarray(edge), rest]).astype(np.float32)
        cases.append(ZnccCase(f"edges_p{p}", img, xy, p))

    # flat patches: 24 x 24 regions at (y0, x0) = (8, 40 + 32 j); a p = 24
    # or p = 16 patch centred there lies inside its region, and a zero-mean
    # checkerboard of amplitude a has centred norm a * p
    W, H = 390, 48
    img = (rng.integers(0, 256, (H, W)) / 255.0).astype(np.float32)
    board = np.where(np.add.outer(np.arange(24), np.arange(24)) % 2, 1.0,
                     -1.0)
    regions = (0.5 + 0 * board, 0.0 + 0 * board, 1.0 + 0 * board,
               0.5 + 1.25e-5 * board,  # norm 3e-4 at p = 24, 2e-4 at 16
               0.5 + 1.25e-4 * board,  # 3e-3 and 2e-3
               0.25 + 2.5e-5 * board,  # 6e-4 and 4e-4: below
               0.25 + 1e-4 * board)    # 2.4e-3 and 1.6e-3: above
    for j, r in enumerate(regions):
        img[8:32, 40 + 32 * j:64 + 32 * j] = r
    for p in (24, 16):
        o = (24 - p) // 2  # the p-patch centred in the 24 x 24 region
        xy = [_patch_at(40 + 32 * j + o, 8 + o, p)
              for j in range(len(regions))]
        # a patch half on a flat region and half on texture
        xy.append(_patch_at(40 + 32 * len(regions) - p // 2, 8, p))
        cases.append(ZnccCase(f"flat_patches_p{p}", img,
                              np.asarray(xy, np.float32), p))
    return cases


def _cloud(rng, n: int, scale: float = 80.0) -> np.ndarray:
    return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


def _near(rng, p: np.ndarray, n: int, sigma: float) -> np.ndarray:
    """n points around p [3] (sigma m apart), float32."""
    return (p + rng.normal(0.0, sigma, (n, 3))).astype(np.float32)


def knn_window(rng, Q: int = 2048, rows: int = 4096, cap: int = 32,
               active: int = 1400) -> KnnCase:
    """A mesh window as parallel/mesh_fused.py::_window_block lays it out:
    `rows` bucket rows of `cap` slots, the rows nearest the centre first;
    `active` rows hold 1-12 points of one 2 m cell, every other slot is
    empty (masked, at the map's SENTINEL 1e6); Q queries around live points
    of the window, within 0.5 m."""
    cells = rng.uniform(-60.0, 60.0, (active, 3)) * np.array([1, 1, 0.1])
    cells = cells[np.argsort(np.linalg.norm(cells, axis=1), kind="stable")]
    pts = np.full((rows, cap, 3), 1.0e6, np.float32)
    mask = np.zeros((rows, cap), bool)
    for r, c in enumerate(cells):
        n = rng.integers(1, 13)
        pts[r, :n] = c + rng.uniform(0.0, 2.0, (n, 3))
        mask[r, :n] = True
    pts, mask = pts.reshape(-1, 3), mask.reshape(-1)
    live = np.flatnonzero(mask)
    q = pts[rng.choice(live, Q)] + rng.normal(0.0, 0.5, (Q, 3))
    return KnnCase(f"mesh_window_{Q}x{rows * cap}", q.astype(np.float32),
                   pts, mask, 5, small=False)


def _on_grid(a: np.ndarray) -> np.ndarray:
    """a rounded to multiples of 1/16 m, float32."""
    return (np.round(a * 16.0) / 16.0).astype(np.float32)


def _set_tiles(mask: np.ndarray, t, live: bool) -> None:
    """Every slot of the kernel's 256-slot tiles t live, or masked."""
    mask.reshape(-1, 256)[t] = live


def _sliced_cases(rng) -> list[KnnCase]:
    """The kernel's masked-slot packing and shared bound, each laid out for
    its `slices` S (slice s holds tiles s, s + S, s + 2S, ...)."""
    cases = []

    # whole tiles masked between live ones: every slice's middle tile. On
    # a 1/16 m grid within 60 m every distance is exact in float32 in any
    # order of sums, so only exact ties (lower index first) decide between
    # candidates: at 80 m and 1024 queries x 101,376 slots, two distances
    # 3e-3 m^2 apart round to one float here and apart in the reference
    Q, S = 1024, 132
    C = 3 * 256 * S
    c, m = _on_grid(_cloud(rng, C, 60.0)), rng.random(C) < 0.6
    _set_tiles(m, np.arange(S, 2 * S), False)
    q = _on_grid(np.concatenate([c[rng.choice(np.flatnonzero(m), 512)]
                                 + rng.normal(0, 0.3, (512, 3)),
                                 _cloud(rng, Q - 512, 60.0)]))
    cases.append(KnnCase("masked_tiles_between_live", q, c, m, 5,
                         slices=S))

    # slices whose dealt tiles are all masked (one tile a slice here)
    Q, C = 300, 40 * 256
    c, m = _cloud(rng, C), rng.random(C) < 0.5
    _set_tiles(m, np.r_[3:10, 17, 25:32], False)
    cases.append(KnnCase("slices_all_masked", _cloud(rng, Q), c, m, 5,
                         slices=40))

    # a live slot at exactly the k-th distance another slice publishes,
    # with a lower index: slice 1's third tile holds one copy of p, slice
    # 2's third tile six; slice 2's first tiles are masked (it publishes
    # early), slice 1's live (it reads the bound before its third tile)
    Q, S = 1024, 132
    C = 3 * 256 * S
    c, m = _cloud(rng, C), rng.random(C) < 0.5
    _set_tiles(m, [1, 1 + S], True)
    _set_tiles(m, [2, 2 + S], False)
    p = _cloud(rng, 1)[0]
    tie = (1 + 2 * S) * 256 + 200
    copies = (2 + 2 * S) * 256 + np.arange(10, 16)
    c[tie], c[copies] = p, p
    m[tie], m[copies] = True, True
    # every query near p (its 5 nearest: the tie and 4 of the six), 24 on it
    q = np.concatenate([_near(rng, p, Q - 24, 0.01), np.tile(p, (24, 1))])
    cases.append(KnnCase("tie_at_the_published_bound", q, c, m, 5,
                         slices=S))

    # fewer live candidates than k: every slice fills its list from its own
    # masked slots, the merge keeps the lowest indices
    C = 5 * 256 + 3
    m = np.zeros(C, bool)
    m[[260, 1030, 1282]] = True
    cases.append(KnnCase("few_live_k8_across_slices", _cloud(rng, 130),
                         _cloud(rng, C), m, 8, slices=6))
    # and fewer candidates than k: the padding slots C, C + 1, ... after them
    cases.append(KnnCase("padding_k8", _cloud(rng, 130), _cloud(rng, 5),
                         np.array([False, True, False, False, True]), 8,
                         slices=1))
    return cases


def _untame_cases(rng) -> list[KnnCase]:
    """Coordinates beyond the kernel's 2^60 bound (finite; no product or sum
    meets inf - inf): masked slots there are swept like live ones, and such
    a query compares every masked slot with its distance. For the card only:
    the JAX package's product rounds such values otherwise."""
    c = _cloud(rng, 5000)
    m = rng.random(5000) < 0.4
    far = rng.choice(5000, 600, replace=False)
    c[far[:300]] = np.float32(1e20)   # masked, beyond the bound: d = +inf
    c[far[300:400], 1] = np.float32(-3e18)
    m[far[:400]] = False
    c[far[400:]] = np.float32(1e20)  # live and beyond: d = +inf
    m[far[400:]] = True
    cands = [KnnCase("untame_candidates", _cloud(rng, 300), c, m, 5,
                     small=False)]
    q = _cloud(rng, 300)
    q[:40, 0] = np.float32(1e19)
    q[40:60, 2] = np.float32(-2.0 ** 61)
    q[60:70] = np.float32(3e18)
    c = _cloud(rng, 6000)
    m = rng.random(6000) < 0.3
    m[:700] = False
    return cands + [KnnCase("untame_queries", q, c, m, 8, small=False)]


def knn_cases(seed: int = 16837) -> list[KnnCase]:
    """masked_knn's rules: equal distances (duplicated candidates) across
    the reference's 4096-slot tile and across every multiple of 256 slots
    (the kernel's tile; its slices are whole tiles), queries exactly on
    candidates (d = 0 after the clamp), fewer live candidates than k, all
    masked, fewer candidates than k (the reference's padding indices C,
    C + 1, ... in the result), candidate counts no tile divides, k = 1, 3,
    5 and 8 at 80 m coordinates; the kernel's slices (_sliced_cases: whole
    masked tiles, all-masked slices, a tie at a bound another slice
    publishes, lists filled from masked slots across slices, padding);
    coordinates beyond its 2^60 bound, for the card; and the mesh engine's
    corner and surf window shapes (2048 x 4096 * 32 and 6144 x 4096 * 16
    slots, mostly masked), for the card."""
    rng = np.random.default_rng(seed)
    cases = []

    # one point duplicated across the reference's 4096 boundary and across
    # multiples of 256; queries on it and near it; one copy masked
    c = _cloud(rng, 9000)
    for lo in (250, 1020, 2044, 4090, 6140, 8188):
        c[lo:lo + 12] = c[11]
    m = rng.random(9000) < 0.9
    m[c[:, 0] == c[11, 0]] = True
    m[4093] = False
    q = np.concatenate([_near(rng, c[11], 40, 0.01), c[11][None],
                        _cloud(rng, 259)])
    cases.append(KnnCase("ties_across_tiles", q, c, m, 5))

    # queries exactly on candidates, some of them duplicated twice
    c = _cloud(rng, 7000)
    c[3000:3100] = c[100:200]
    c[6990:7000] = c[150:160]
    q = np.concatenate([c[rng.choice(7000, 200)], c[100:200]])
    cases.append(KnnCase("queries_on_candidates", q, c,
                         np.ones(7000, bool), 5))

    c = _cloud(rng, 5000)
    m = np.zeros(5000, bool)
    m[[7, 4095, 4999]] = True
    cases.append(KnnCase("fewer_live_than_k", _cloud(rng, 130), c, m, 5))
    cases.append(KnnCase("all_masked", _cloud(rng, 130), _cloud(rng, 6000),
                         np.zeros(6000, bool), 5))
    cases.append(KnnCase("fewer_candidates_than_k", _cloud(rng, 130),
                         _cloud(rng, 3), np.array([True, False, True]), 5))
    cases.append(KnnCase("one_candidate_k8", _cloud(rng, 70),
                         _cloud(rng, 1), np.ones(1, bool), 8))
    for k, C, live in ((1, 9000, 0.7), (3, 4097, 0.5), (5, 12345, 0.6),
                       (8, 8191, 0.3)):
        cases.append(KnnCase(f"random_k{k}_C{C}", _cloud(rng, 300),
                             _cloud(rng, C), rng.random(C) < live, k))
    cases += _sliced_cases(rng) + _untame_cases(rng)
    cases.append(knn_window(rng))
    cases.append(knn_window(rng, Q=6144, cap=16))
    return cases


# the principal spreads (m) of each kind of 5-point neighbourhood whose
# covariance the mapping's line test takes to eig3
EIG3_KINDS = {"near_planar": (1.0, 1.0, 1e-3), "line_5m": (5.0, 0.1, 0.1),
              "line_0.5m": (0.5, 0.01, 0.01), "isotropic": (1.0, 1.0, 1.0)}


def eig3_covariances(kind: str, n: int, seed: int = 16838,
                     max_range: float = 80.0) -> np.ndarray:
    """n float32 covariances [n, 3, 3] of 5-point neighbourhoods of one of
    EIG3_KINDS, each turned at random and centred 0..max_range m from the
    origin, formed as mapping.corner_geometry forms them: float32 points,
    their mean removed, the Gram matrix times float32(1 / 5). Far from the
    origin the float32 points round the spread (the float32 trouble F5 found
    in the plane fit)."""
    rng = np.random.default_rng([seed, list(EIG3_KINDS).index(kind)])
    pts = rng.normal(size=(n, 5, 3)) * np.asarray(EIG3_KINDS[kind])
    rot, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    way = rng.normal(size=(n, 3))
    way *= rng.uniform(0.0, max_range, (n, 1)) / np.linalg.norm(
        way, axis=1, keepdims=True)
    near = (np.einsum("nij,nkj->nki", rot, pts)
            + way[:, None]).astype(np.float32)
    dm = near - near.mean(axis=1, keepdims=True, dtype=np.float32)
    gram = np.einsum("nki,nkj->nij", dm, dm).astype(np.float32)
    return gram * np.float32(1.0 / 5.0)
