"""The shortlist LO association and the pipeline-shape k-NN benchmark of
the port (vloam_tpu_torch/tools/legacy_assoc.py, profile_lo2.py,
bench_knn.py) against the JAX package, on the CPU at small shapes:

- shortlist_ring_assoc against scripts/legacy_assoc.py's jitted function
  (loaded by its path: the script imports only vloam_tpu.lidar.knn) on a
  clustered cloud whose picks land on other rings and on the nearest's own
  ring: every pick exact, distances within 1e-6 (the port rounds the
  distance matrix as XLA's CPU code does under jit), corner and surf, at
  shortlists of 8 and 24;
- profile_lo2's distance product: float32 against the exact form within
  its float32 cancellation; the TF32 block restores the flag it found; the
  bf16 product on the CPU is the float32 product of bf16-rounded inputs;
- bench_knn: the script's inputs (scaled down) through masked_knn, indices
  exact against JAX's masked_knn and distances within the k-NN tests'
  D_TOL; its main on the CPU finds every shape identical to the plain
  version.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.lidar.knn import masked_knn as j_masked_knn
from vloam_tpu_torch.tools import bench_knn, legacy_assoc, profile_lo2

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
D_TOL = 1e-2  # m^2: tests/test_torch_knn.py's bound on JAX's distances
NEARBY_SCAN = 2.5  # LaserOdometryConfig.nearby_scan


@pytest.fixture(scope="module")
def j_shortlist():
    spec = importlib.util.spec_from_file_location(
        "legacy_assoc_script", REPO / "scripts" / "legacy_assoc.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.shortlist_ring_assoc


def _cloud(rng, Q=400, C=3000, rings=16):
    """Candidates clustered around the queries (so the shortlist holds
    several rings), a fifth of them masked."""
    q = rng.uniform(-30, 30, (Q, 3)).astype(np.float32)
    c = (q[rng.integers(0, Q, C)] + rng.normal(0, 0.4, (C, 3))).astype(
        np.float32)
    ring = rng.integers(0, rings, C).astype(np.int32)
    mask = rng.uniform(size=C) < 0.8
    return q, c, ring, mask


@pytest.mark.parametrize("mode", ["corner", "surf"])
@pytest.mark.parametrize("shortlist", [8, 24])
def test_shortlist_matches_the_script(j_shortlist, rng, mode, shortlist):
    q, c, ring, mask = _cloud(rng)
    want = j_shortlist(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ring),
                       jnp.asarray(mask), NEARBY_SCAN, mode, shortlist)
    got = legacy_assoc.shortlist_ring_assoc(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(ring),
        torch.from_numpy(mask), NEARBY_SCAN, mode, shortlist)
    assert set(got) == set(want)
    for k in ("i0", "i2", "i3"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("d0", "d2", "d3"):
        w, g = np.asarray(want[k]), got[k].numpy()
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=1e-6,
                                   err_msg=k)
    # the picks are not vacuous: other rings found, and, for surfaces, the
    # nearest's own ring
    assert np.isfinite(got["d2"].numpy()).mean() > 0.5
    if mode == "surf":
        assert np.isfinite(got["d3"].numpy()).mean() > 0.2


def test_dist_sq_rounds_as_the_jitted_reference(rng):
    import jax

    from vloam_tpu.lidar.knn import _dist_sq

    q = rng.uniform(-80, 80, (200, 3)).astype(np.float32)
    c = rng.uniform(-80, 80, (900, 3)).astype(np.float32)
    want = np.asarray(jax.jit(_dist_sq)(q, c))
    got = legacy_assoc.dist_sq(torch.from_numpy(q), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)


def test_profile_lo2_products(rng):
    q = torch.from_numpy(rng.uniform(-40, 40, (64, 3)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(-40, 40, (300, 3)).astype(np.float32))
    exact = ((q.double()[:, None] - c.double()[None]) ** 2).sum(-1)
    d32 = profile_lo2.dist_by_product(q, c, "float32")
    # float32 cancellation of |q|^2 + |c|^2 - 2 q.c at 70 m: ~1e-3 m^2
    np.testing.assert_allclose(d32.double().numpy(), exact.numpy(),
                               rtol=0, atol=2e-2)
    bf = profile_lo2.bf16_product(q, c)
    want = q.to(torch.bfloat16).float() @ c.to(torch.bfloat16).float().T
    np.testing.assert_array_equal(bf.numpy(), want.numpy())
    before = torch.backends.cuda.matmul.allow_tf32
    with profile_lo2._TF32():
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_bench_knn_matches_jax():
    for name, Q, C, q, c, m in bench_knn.inputs(bench_knn.SHAPES, 128):
        dj, ij = j_masked_knn(jnp.asarray(q), jnp.asarray(c),
                              jnp.asarray(m), k=bench_knn.K)
        dt, it = bench_knn.masked_knn(torch.from_numpy(q),
                                      torch.from_numpy(c),
                                      torch.from_numpy(m), k=bench_knn.K)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij),
                                      err_msg=name)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                                   atol=D_TOL, err_msg=name)


def test_bench_knn_main_on_the_cpu(capsys):
    assert bench_knn.main(["--device", "cpu", "--scale", "256", "--runs",
                           "1", "--plain-runs", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert rec["device"] == "cpu"
    assert [r["shape"] for r in rec["shapes"]] == [
        s for s, _, _ in bench_knn.SHAPES]
    for r in rec["shapes"]:
        assert r["identical"] and r["clock"] == "host" and r["ms"] > 0
        assert r["live"] > 0 and r["bound_ms"] > 0
