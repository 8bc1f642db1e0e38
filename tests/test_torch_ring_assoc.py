"""Parity of the port's per-ring association (vloam_tpu_torch.lidar.
ring_assoc) with the JAX reference.

- ring_min2_plain (the CPU version of kernel K2) against the reference's
  Pallas kernel ring_min2_pallas run in interpret mode, as
  tests/test_ring_assoc.py runs it: argmins identical, distances to 1e-6
  relative (both add (dx^2 + dy^2) + dz^2 in f32), including exact ties
  (duplicate points) and all-SENTINEL rings.
- ring_min2_plain on the crafted cases of vloam_tpu_torch/tools/
  kernel_cases.py (query and slot counts that fit no tile, duplicate points
  across chunk boundaries, the second minimum before the first, SENTINEL
  slots everywhere, alone and between live ones) against ring_min2_xla and
  the Pallas kernel in interpret mode: slots identical, distances to 1e-6
  relative.
- ring_min1_plain (the CPU version of S1's ring_min1) on the same crafted
  cases and on min-only slab shapes (query and slot counts that ring_min1's
  block shape divides unevenly, all-SENTINEL rings, equal minima across
  chunk, group and tile boundaries) against ring_min2_xla's first two
  outputs: slots identical, distances to 1e-6 relative.
- ring_min2_plain, which ring_argmin2 equals, on ring_argmin2's crafted
  cases against the argmin, mask, argmin formulation in numpy (bit for bit)
  and ring_min2_xla (slots exact, distances to 1e-6 relative).
- ring_slab_assoc against the reference's under each of its four impls and
  an unknown name (which both run as "packed"), corner and surf, on ring
  scans with duplicate points, an all-SENTINEL ring and queries on
  candidates: every pick p0 / p2 / p3 identical. Under "packed" and "mxu"
  every distance is identical too, and d3 under every impl: the reference's
  XLA code contracts its sums of products into fused multiply-adds, and the
  port's plain versions emulate each exactly (fma_f32), in XLA's order,
  |q|^2 + |c|^2 - 2 q.c's q.c as fma(qz, cz, fma(qy, cy, qx*cx)) included.
  Under "xla" and "pallas", d0 / d2 within 1e-6 relative: the exact
  kernels round (dx^2 + dy^2) + dz^2 without fusing.
- ring_min1_packed_plain and ring_min1_mxu_plain against the jitted
  reference on every ring case of kernel_cases.py (quantized ties broken by
  the lower slot, duplicates, clipped and all-SENTINEL rings, dense clouds):
  bit for bit.
- fma_f32 against exact rational arithmetic, a double-rounding case of the
  plain float64 emulation included; slab_from_flat against the reference:
  identical slabs.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.lidar import ring_assoc as jra
from vloam_tpu_torch.lidar import ring_assoc as tra
from vloam_tpu_torch.tools import kernel_cases

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)


def _slab(rng, S=8, C=128, live=0.7):
    xyz = np.full((S, C, 3), jra.SENTINEL, np.float32)
    for s in range(S):
        n = int(C * live * rng.uniform(0.3, 1.0))
        xyz[s, :n] = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    return xyz


def _tied_case(rng):
    """Duplicated points (exact distance ties), an all-SENTINEL ring and a
    ring whose only live point is duplicated at its last slot."""
    slab = _slab(rng, S=8, C=128)
    slab[1, 10] = slab[1, 3]
    slab[1, 40] = slab[1, 3]
    slab[2] = jra.SENTINEL
    slab[5, :] = jra.SENTINEL
    slab[5, 0] = slab[5, 127] = [1.0, 2.0, 3.0]
    q = rng.uniform(-40, 40, (96, 3)).astype(np.float32)
    q[:4] = slab[1, 3]  # queries sitting on the duplicated point
    q[4] = [1.0, 2.0, 3.0]
    return q, slab


@pytest.mark.parametrize("case", ["random", "ties"])
def test_ring_min2_plain_matches_pallas_interpret(rng, case):
    if case == "random":
        slab = _slab(rng, S=8, C=128)
        q = rng.uniform(-40, 40, (100, 3)).astype(np.float32)
    else:
        q, slab = _tied_case(rng)
    slab_t = np.ascontiguousarray(np.swapaxes(slab, 1, 2))
    want = jra.ring_min2_pallas(jnp.asarray(q), jnp.asarray(slab_t),
                                q_tile=32, interpret=True)
    got = tra.ring_min2_plain(torch.from_numpy(q), torch.from_numpy(slab_t))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
    if case == "ties":
        amin, a2 = got[1].numpy(), got[3].numpy()
        assert (amin[1, :4] == 3).all() and (a2[1, :4] == 10).all()
        assert (amin[2] == 0).all() and (a2[2] == 1).all()  # all-SENTINEL
        assert amin[5, 4] == 0 and a2[5, 4] == 127


@pytest.mark.parametrize("case", kernel_cases.ring_min2_cases(),
                         ids=lambda c: c.name)
def test_ring_min2_plain_crafted_cases(case):
    q, slab_t = case.queries, case.slab_t
    got = [g.numpy() for g in tra.ring_min2_plain(torch.from_numpy(q),
                                                  torch.from_numpy(slab_t))]
    refs = (jra.ring_min2_xla(jnp.asarray(q), jnp.asarray(slab_t)),
            jra.ring_min2_pallas(jnp.asarray(q), jnp.asarray(slab_t),
                                 q_tile=32, interpret=True))
    for want in refs:
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype
            if w.dtype == np.int32:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6)
    dmin, amin, d2, a2 = got
    if case.name == "duplicates_across_chunks":
        pairs = [(2, 6), (3, 4), (7, 8), (15, 16), (255, 256), (511, 512),
                 (1023, 1024), (5, 1099)]
        for s, (a, b) in enumerate(pairs):  # query s sits on ring s's pair
            assert (amin[s, s], a2[s, s]) == (a, b)
            assert dmin[s, s] == 0 and d2[s, s] == 0
    elif case.name == "second_before_first":
        for s in range(8):
            assert (amin[s, s], a2[s, s]) == (100, 3 + s)
    elif case.name == "sentinel_slots":
        assert (amin[0] == 0).all() and (a2[0] == 1).all()
        assert (amin[1] == 37).all() and (a2[1] == 0).all()
        assert (amin[2] % 2 == 1).all() and (a2[2] % 2 == 1).all()
        assert (amin[3] == 129).all() and (a2[3] == 0).all()
        assert ((amin[4] >= 8) & (amin[4] < 16)).all()


@pytest.mark.parametrize(
    "case", kernel_cases.ring_min2_cases() + kernel_cases.ring_min1_cases(),
    ids=lambda c: c.name)
def test_ring_min1_plain_crafted_cases(case):
    """ring_min1_plain (what S1's ring_min1 computes) against the first two
    outputs of ring_min2_xla, on K2's crafted cases and on the min-only slab
    shapes that ring_min1's block shape divides unevenly."""
    q, slab_t = case.queries, case.slab_t
    dmin, amin = (g.numpy() for g in tra.ring_min1_plain(
        torch.from_numpy(q), torch.from_numpy(slab_t)))
    want = jra.ring_min2_xla(jnp.asarray(q), jnp.asarray(slab_t))
    w_d, w_a = np.asarray(want[0]), np.asarray(want[1])
    assert amin.dtype == w_a.dtype and amin.shape == w_a.shape
    np.testing.assert_array_equal(amin, w_a)
    np.testing.assert_allclose(dmin, w_d, rtol=1e-6)
    if case.name.startswith("min1_") and "x" in case.name:
        assert (amin[0] == 0).all()  # the all-SENTINEL ring: slot 0
    if case.name == "min1_duplicates_across_groups":
        pairs = [(60, 64), (30, 100), (250, 260), (500, 515), (5, 1090),
                 (700, 1030), (127, 128), (3, 4)]
        for s, (a, _) in enumerate(pairs):  # ties keep the lower slot
            assert amin[s, s] == a and dmin[s, s] == 0


def _argmin_mask_argmin(q, slab_t):
    """The measurement kernel _kern_argmin (scripts/profile_ring_variants.py)
    restated in numpy: (dx^2 + dy^2) + dz^2 in float32, argmin, the winner's
    slot set to 3.9e12, argmin again."""
    diff = q[None, :, :, None] - slab_t[:, None, :, :]  # [S, Q, 3, C]
    sq = diff * diff
    d = (sq[:, :, 0] + sq[:, :, 1]) + sq[:, :, 2]
    a1 = d.argmin(-1)
    d_wo = d.copy()
    np.put_along_axis(d_wo, a1[..., None], np.float32(3.9e12), -1)
    a2 = d_wo.argmin(-1)
    return (d.min(-1), a1.astype(np.int32), d_wo.min(-1),
            a2.astype(np.int32))


@pytest.mark.parametrize("case", kernel_cases.ring_argmin2_cases(),
                         ids=lambda c: c.name)
def test_ring_argmin2_plain_crafted_cases(case):
    """ring_argmin2's plain version (ring_min2_plain: ring_argmin2 computes
    K2's four outputs) against the argmin, mask, argmin formulation in
    numpy (bit for bit) and ring_min2_xla (slots exact, distances to 1e-6
    relative) on ring_argmin2's crafted cases: a runner-up at the winner's
    distance, the winner in the last slot, ragged slot counts, rings all
    SENTINEL."""
    q, slab_t = case.queries, case.slab_t
    got = [g.numpy() for g in tra.ring_min2_plain(torch.from_numpy(q),
                                                  torch.from_numpy(slab_t))]
    for g, w in zip(got, _argmin_mask_argmin(q, slab_t)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ref = jra.ring_min2_xla(jnp.asarray(q), jnp.asarray(slab_t))
    for g, w in zip(got, ref):
        w = np.asarray(w)
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6)
    dmin, amin, d2, a2 = got
    C = slab_t.shape[2]
    if case.name == "argmin2_ties":
        ties = ((0, 1), (5, 300), (515, 2), (3, 4), (599, 511), (128, 129),
                (250, 251), (10, 590))
        for s, (a, b) in enumerate(ties):  # query s sits on both slots
            assert (amin[s, s], a2[s, s]) == (min(a, b), max(a, b))
            assert dmin[s, s] == d2[s, s] == 0
    elif case.name.startswith("argmin2_last_slot"):
        for s in range(8):
            assert (amin[s, s], a2[s, s]) == (C - 1, s)
    elif case.name == "argmin2_all_sentinel":
        for s in (0, 1, 2, 4, 5, 6, 7):
            assert (amin[s] == 0).all() and (a2[s] == 1).all()
        assert (amin[3] == 77).all() and (a2[3] == 0).all()


def test_ring_min2_dispatch_has_no_fallback():
    """Only CPU tensors take the plain version; anything else goes to the
    kernel wrapper, which refuses non-CUDA tensors instead of falling back."""
    q = torch.zeros((4, 3), device="meta")
    s = torch.zeros((8, 3, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor required"):
        tra.ring_min2(q, s)


def _ring_scan(rng, S=16, C=64, n_q=200):
    """Rings as noisy circles (a scan's structure), tails SENTINEL-padded,
    queries near real candidates, so gated picks are realistic."""
    slab = np.full((S, C, 3), jra.SENTINEL, np.float32)
    for s in range(S):
        n = int(rng.integers(C // 2, C))
        th = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = 10.0 + 0.5 * s
        slab[s, :n] = np.stack([r * np.cos(th), r * np.sin(th),
                                np.full(n, 0.2 * s)], 1)
        slab[s, :n] += rng.normal(0, 0.05, (n, 3))
    live = slab[slab[..., 0] < jra.SENTINEL * 0.5]
    q = (live[rng.integers(0, len(live), n_q)]
         + rng.normal(0, 0.5, (n_q, 3))).astype(np.float32)
    return q, slab


def _assoc(q, slab, mode, impl):
    want = jra.ring_slab_assoc(jnp.asarray(q), jra.RingSlab(jnp.asarray(slab)),
                               nearby_scan=2.5, mode=mode, impl=impl)
    got = tra.ring_slab_assoc(torch.from_numpy(q),
                              tra.RingSlab(torch.from_numpy(slab)),
                              nearby_scan=2.5, mode=mode, impl=impl)
    assert set(got) == set(want)
    return {k: got[k].numpy() for k in got}, {k: np.asarray(want[k])
                                               for k in want}


@pytest.mark.parametrize("mode", ["corner", "surf"])
def test_ring_slab_assoc_matches_jax_exact_impl(rng, mode):
    q, slab = _ring_scan(rng)
    got, want = _assoc(q, slab, mode, "xla")
    for k in ("d0", "d2"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    for k in ("p0", "p2"):
        np.testing.assert_array_equal(got[k], want[k])
    if mode == "surf":  # the quantized ring0 pick, as the reference's
        np.testing.assert_array_equal(got["p3"], want["p3"])
        np.testing.assert_array_equal(got["d3"], want["d3"])
        assert (got["d3"] < 25.0).sum() > 100


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The reference's impl="pallas" runs its Pallas kernel, which the CPU
    backend takes in interpret mode only (as tests/test_ring_assoc.py runs
    it)."""
    kernel = jra.ring_min2_pallas
    monkeypatch.setattr(jra, "ring_min2_pallas", lambda q, s: kernel(
        q, s, q_tile=64, interpret=True))


@pytest.mark.parametrize("mode", ["corner", "surf"])
@pytest.mark.parametrize("impl", ["mxu", "packed", "xla", "pallas",
                                  "unknown"])
def test_ring_slab_assoc_matches_jax_every_impl(rng, pallas_interpret, impl,
                                                mode):
    q, slab = _ring_scan(rng, n_q=400)
    slab[3, 5] = slab[3, 9]  # duplicates: exact ties
    slab[4, 20] = slab[4, 2]
    slab[7] = jra.SENTINEL  # an all-SENTINEL ring
    q[:8] = slab[3, 9]  # queries on the duplicated points
    q[8:16] = slab[4, 2]
    got, want = _assoc(q, slab, mode, impl)
    exact = impl in ("xla", "pallas")
    for k in got:
        if k.startswith("p") or not exact or k == "d3":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)
    assert (got["d0"][:16] == 0).all()
    if mode == "surf":
        assert (got["d3"][:16] == 0).all()  # the duplicate, on ring0
        assert (got["d3"] < 25.0).sum() > 300


@pytest.mark.parametrize("product", [True, False])
@pytest.mark.parametrize(
    "case", kernel_cases.ring_packed_cases() + kernel_cases.ring_min2_cases()
    + kernel_cases.ring_min1_cases() + kernel_cases.ring_argmin2_cases(),
    ids=lambda c: c.name)
def test_ring_min1_packed_plain_crafted_cases(case, product):
    """The packed forms' plain versions against the jitted reference (the
    compiled code whose fused multiply-adds they emulate), bit for bit."""
    q, slab_t = case.queries, case.slab_t
    ref = jra.ring_min1_mxu if product else jra.ring_min1_packed
    plain = tra.ring_min1_mxu_plain if product else tra.ring_min1_packed_plain
    want = jax.jit(ref)(jnp.asarray(q), jnp.asarray(slab_t))
    got = plain(torch.from_numpy(q), torch.from_numpy(slab_t))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32 or g.dtype == torch.float32
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    d, slot = (g.numpy() for g in got)
    if case.name.startswith("packed_quant_ties"):
        # ring 6 lies past the clip: the clip, slot 0; ring 7 likewise
        clip = np.float32(64.0 * 0.999999)
        assert (slot[6:] == 0).all() and (d[6:] <= clip).all()
        assert (d[6:] > clip - 1e-4).all()
        assert (d[:6] < clip).mean() > 0.9


def test_ring_min1_packed_dispatch_has_no_fallback():
    q = torch.zeros((4, 3), device="meta")
    s = torch.zeros((8, 3, 16), device="meta")
    for product in (True, False):
        with pytest.raises(ValueError, match="CUDA tensor required"):
            tra.ring_min1_packed(q, s, product)


def _f32_round(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even, exactly."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    err = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(err)
    ties = [c for c, e in zip(cands, err) if e == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma_f32_rounds_once(rng):
    # exact sum just below a float32 midpoint that the float64 sum rounds
    # onto: float64 then float32 rounding (ties to even) would go up
    a = np.float32(1 + 2.0**-23)
    b = np.float32(2.0**-24 * (1 - 2.0**-23))
    c = np.float32(1 + 2.0**-23)
    naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert naive == np.float32(1 + 2.0**-22)
    a_, b_, c_ = (torch.tensor([v]) for v in (a, b, c))
    assert tra.fma_f32(a_, b_, c_).item() == c
    x = rng.normal(0, 1, (3, 2000)) * 10.0 ** rng.integers(-6, 6, (3, 2000))
    x = x.astype(np.float32)
    got = tra.fma_f32(*(torch.from_numpy(v) for v in x)).numpy()
    want = [_f32_round(Fraction(float(p)) * Fraction(float(r))
                       + Fraction(float(t))) for p, r, t in x.T]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def _rz_sat_f32(x: Fraction) -> np.float32:
    """x rounded toward zero to float32 and held to [0, 1], exactly: PTX's
    fma.rz.sat.f32 rounding of an exact sum."""
    if x <= 0:
        return np.float32(0)
    if x >= 1:
        return np.float32(1)
    f = np.float32(float(x))
    while Fraction(float(f)) > x:
        f = np.nextafter(f, np.float32(0))
    while Fraction(float(np.nextafter(f, np.float32(1)))) <= x:
        f = np.nextafter(f, np.float32(1))
    return f


@pytest.mark.parametrize("C", [65, 128, 512, 1 << 16, 1 << 29])
def test_packed_fast_truncation_is_exact(rng, C):
    """ring_min1_packed's fast path (kernels/csrc/ring_min1.cu, 7 or more
    slot bits): x = fma.rz.sat(d, scale / 2^24, base), base = 1 - M / 2^24
    and M = 2^min(23, 30 - bits), carries bits(base) + min(trunc(d * scale),
    M), and the wrapping key bits(x) * 2^bits + (slot - bits(base) * 2^bits)
    is (that count << bits) | slot, below 2^31. Exact rational arithmetic
    at counts 0, 1, 2, the clip's, M and random ones, one ulp either side of
    each, at the clip and far past it."""
    bits, scale, clip = tra._quant(C)
    M = 1 << min(23, 30 - bits)
    assert bits >= 7 and clip * scale <= M
    base_bits = 0x3F800000 - M
    base = Fraction(float(np.array(base_bits, np.int32).view(np.float32)))
    assert base == 1 - Fraction(M, 2**24) and base >= Fraction(1, 2)
    k = Fraction(scale) / 2**24
    key0 = -(base_bits << bits) & 0xFFFFFFFF
    top = int(np.float32(clip) * np.float32(scale))
    counts = [0, 1, 2, top - 1, top, top + 1, M - 1, M]
    counts += [int(n) for n in rng.integers(0, top + 1, 40)]
    ds = [np.float32(clip), np.float32(1e3), np.float32(3e12),
          np.float32(1e-30)]
    for n in counts:
        d = np.float32(n) / np.float32(scale)  # exact: a power of two
        ds += [d, np.nextafter(d, np.float32(0)),
               np.nextafter(d, np.float32(np.inf))]
    for d in ds:
        x = _rz_sat_f32(Fraction(float(d)) * k + base)
        want = min(int(Fraction(float(d)) * Fraction(scale)), M)
        assert int(np.array(x).view(np.int32)) - base_bits == want, d
        slot = int(rng.integers(0, min(C, 1 << 20)))
        key = (int(np.array(x).view(np.int32)) * (1 << bits) + key0
               + slot) & 0xFFFFFFFF
        assert key < 2**31 and key == (want << bits) | slot, d


def _raw_dist(q: torch.Tensor, slab_t: torch.Tensor, product: bool):
    """Every (ring, query, slot) distance [S, Q, C] as the reference's
    compiled code rounds it, the product form before its clamp at 0."""
    qb = q.T[:, None, :, None]  # [3, 1, Q, 1]
    cb = slab_t.permute(1, 0, 2)[:, :, None, :]  # [3, S, 1, C]
    if not product:
        return tra._fused_dist(qb, cb, False)

    def norm(a, b):
        return tra.fma_f32(a[2], b[2], tra.fma_f32(a[1], b[1], a[0] * b[0]))
    return (norm(qb, qb) + norm(cb, cb)) - 2.0 * norm(qb, cb)


_BOUNDARY_CASES = [c for c in kernel_cases.ring_packed_cases()
                   if c.name.startswith(("packed_steps", "packed_negative",
                                         "packed_ragged"))]


@pytest.mark.parametrize("product", [True, False])
@pytest.mark.parametrize("case", _BOUNDARY_CASES, ids=lambda c: c.name)
def test_packed_boundary_cases(case, product):
    """The packed forms' plain versions against the jitted reference, bit
    for bit, on the cases of the fast truncation's boundaries; each case
    reaches the boundary its name gives; and the kernel's fast-path rule
    (counts capped at M, the minimum started at the clip's key at slot 0,
    no clip a pair) gives the same outputs over the same distances."""
    q, slab_t = (torch.from_numpy(a) for a in (case.queries, case.slab_t))
    S, _, C = slab_t.shape
    ref = jra.ring_min1_mxu if product else jra.ring_min1_packed
    plain = tra.ring_min1_mxu_plain if product else tra.ring_min1_packed_plain
    want = jax.jit(ref)(jnp.asarray(case.queries), jnp.asarray(case.slab_t))
    got = plain(q, slab_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    bits, scale, clip = tra._quant(C)
    top = int(np.float32(clip) * np.float32(scale))  # the clip's count
    raw = _raw_dist(q, slab_t, product)
    d = torch.clamp(raw, min=0.0)
    if bits >= 7:
        M = 1 << min(23, 30 - bits)
        keys = (torch.clamp(torch.floor(d.double() * scale), max=M).long()
                << bits) | torch.arange(C)
        m = torch.clamp(keys.amin(-1), max=top << bits)
        assert torch.equal(m & ((1 << bits) - 1), got[1].long())
        assert torch.equal((m >> bits).float() / scale, got[0])

    dmin = d.amin(-1).double()  # [S, Q]
    if case.name.startswith("packed_steps"):
        o = dmin[:, 0]  # the first query sits at the origin
        ulp_up = torch.from_numpy(np.nextafter(
            o.float().numpy(), np.float32(np.inf))).double()
        for s in (0, 2):  # d * scale an integer below the clip's count
            assert o[s] * scale == torch.floor(o[s] * scale) < top
        for s in (1, 3):  # one ulp below an integer
            assert o[s] * scale != torch.floor(o[s] * scale)
            assert ulp_up[s] * scale == torch.floor(ulp_up[s] * scale)
        assert o[4] == clip and o[5] < clip < o[6]
        assert ulp_up[5] == clip and o[6] == float(np.nextafter(
            np.float32(clip), np.float32(np.inf)))
        if bits < 7:  # the conversion path: counts past the fast binade
            assert o[7] * scale == 1 << 23 and top >= 1 << 23
            assert int((got[0] * scale).max()) == top
        else:  # the largest counts just under 2^23 (at 7 bits)
            assert o[7] * scale == top - 1
            assert int((got[0] * scale).max()) == top <= 1 << (30 - bits)
            assert bits > 7 or top > (1 << 23) - 16
    elif case.name == "packed_negative":
        assert (got[0] == 0).sum() > len(case.queries) // 2
        if product:  # below 0 before the clamp, among the ring minima
            assert ((raw < 0) & (d == d.amin(-1, keepdim=True))).any()
    else:  # counts that the kernel's blocks and steps do not divide
        assert len(case.queries) % 64 and C % 16


def test_slab_from_flat_matches_jax(rng):
    n, S, cap = 3000, 16, 128
    xyz = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    ring = rng.integers(0, S, n).astype(np.int32)
    ring[:400] = 5  # one ring past its capacity
    mask = rng.random(n) < 0.8
    want = jra.slab_from_flat(jnp.asarray(xyz), jnp.asarray(ring),
                              jnp.asarray(mask), S, cap)
    got = tra.slab_from_flat(torch.from_numpy(xyz), torch.from_numpy(ring),
                             torch.from_numpy(mask), S, cap)
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    assert (got.xyz[5] < jra.SENTINEL).all()  # ring 5 full
