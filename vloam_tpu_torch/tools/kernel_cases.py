"""Crafted inputs for the two kernels whose rules are easiest to get wrong:
K1 select_rings (strict sector selection) and K2 ring_min2 (per-ring
2-smallest). Plain numpy from a seed; no device logic.

The same cases are used three times: the CPU tests hold the plain PyTorch
versions to the JAX package on them (tests/test_torch_scan_registration.py,
tests/test_torch_ring_assoc.py), the GPU tests hold the kernels to the plain
versions (tests/test_torch_kernels_cuda.py), and so does chip_smoke.py.

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
