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
- ring_slab_assoc against the reference's exact impl="xla": d0/p0/d2/p2
  equal to 1e-6. The surf pick p3 is K2's exact second minimum on ring0;
  the reference computes it on a quantized grid (~3e-5 m^2 steps), so p3
  agrees except where two candidates' exact distances lie within 1e-4 m^2,
  checked for the picks that can pass LO's 25 m^2 gate.
"""

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


def test_ring_min2_dispatch_has_no_fallback():
    """Only CPU tensors take the plain version; anything else goes to the
    kernel wrapper, which refuses non-CUDA tensors instead of falling back."""
    q = torch.zeros((4, 3), device="meta")
    s = torch.zeros((8, 3, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor required"):
        tra.ring_min2(q, s)


@pytest.mark.parametrize("mode", ["corner", "surf"])
def test_ring_slab_assoc_matches_jax_exact_impl(rng, mode):
    S, C = 16, 64
    # rings as noisy circles (a scan's structure), tails SENTINEL-padded
    slab = np.full((S, C, 3), jra.SENTINEL, np.float32)
    for s in range(S):
        n = int(rng.integers(C // 2, C))
        th = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = 10.0 + 0.5 * s
        slab[s, :n] = np.stack([r * np.cos(th), r * np.sin(th),
                                np.full(n, 0.2 * s)], 1)
        slab[s, :n] += rng.normal(0, 0.05, (n, 3))
    # queries near real candidates, so gated picks are realistic
    live = slab[slab[..., 0] < jra.SENTINEL * 0.5]
    q = (live[rng.integers(0, len(live), 200)]
         + rng.normal(0, 0.5, (200, 3))).astype(np.float32)
    want = jra.ring_slab_assoc(jnp.asarray(q), jra.RingSlab(jnp.asarray(slab)),
                               nearby_scan=2.5, mode=mode, impl="xla")
    got = tra.ring_slab_assoc(torch.from_numpy(q),
                              tra.RingSlab(torch.from_numpy(slab)),
                              nearby_scan=2.5, mode=mode)
    for k in ("d0", "d2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    for k in ("p0", "p2"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if mode == "surf":
        p3_t, p3_j = got["p3"].numpy(), np.asarray(want["p3"])
        d3_t = np.sum((q - p3_t) ** 2, axis=1)
        d3_j = np.sum((q - p3_j) ** 2, axis=1)
        np.testing.assert_allclose(got["d3"].numpy(), d3_t, rtol=1e-5)
        gated = d3_t < 25.0
        differ = gated & np.any(p3_t != p3_j, axis=1)
        assert np.all(np.abs(d3_t - d3_j)[differ] < 1e-4)
        assert gated.sum() > 100
