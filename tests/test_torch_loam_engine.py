"""The port's LiDAR-only LOAM engine against the JAX reference, on the
CPU at the small test profile (tests/test_pipeline.py::small_cfg).

- solve_lo, solve_mapping and one whole frame step, run on recurrent state
  carried over from a JAX LoamEngine through convert.py and on the same
  JAX-extracted features. LO poses to 1e-4 (quaternion / m): the port
  associates with exact distances, the JAX engine's default association
  quantizes them, so only near-tied candidates and the rounding of the LM
  sums differ. MO poses to 3e-4 (quaternion) and 5e-3 m: the mapping plane
  fit solves A n = -1 by adjugate, which is ill-conditioned on near-collinear
  5-point neighbourhoods, and those noise-driven planes pass the fit test.
  The reference itself moves its MO translation by 2.1e-3 m on this frame
  when only the order of the 5 neighbours is reversed (rounding alone), so
  1e-4 m is not a meaningful bound there.
- The golden drive (tests/golden/short_drive_lo_mo.npy) within
  test_golden_regression.py's tolerances: LO 2e-2 m, MO 3e-2 m, and MO
  within 0.15 m of ground truth.
- push_polar against the JAX LoamEngine.push_polar on the frames
  tests/test_loam_engine.py uses: LO 1e-3 m, MO 1e-2 m per frame.
- convert.py round trip: bit-exact, dtypes kept.
- solve_lo with deskew (distortion=True) against the reference, poses to
  1e-4 as on the default path.
- importing the port (the batch mapping and the measurement tools included)
  leaves jax and the JAX package out of sys.modules, and neither
  chip_smoke.py nor any module of the port imports them; the port's config
  and synthetic data equal the JAX package's (fields equal, scans
  bit-identical); the kernel build
  raises a clear error without nvcc instead of falling back; chip_smoke.py
  exits nonzero without a GPU.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.data import synthetic
from vloam_tpu.lidar import loam_step as jls
from vloam_tpu.lidar import mapping as jmap
from vloam_tpu.lidar import odometry as jodo
from vloam_tpu.lidar import scan_registration as jsr
from vloam_tpu.lidar import voxel as jvox
from vloam_tpu_torch import convert
from vloam_tpu_torch.kernels import build
from vloam_tpu_torch.lidar import loam_step as tls
from vloam_tpu_torch.lidar import mapping as tmap
from vloam_tpu_torch.lidar import odometry as todo
from vloam_tpu_torch.lidar.ring_assoc import RingSlab
from vloam_tpu_torch.lidar.types import FeatureCloud, ScanFeatures

from test_pipeline import small_cfg

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "short_drive_lo_mo.npy"
CFG = small_cfg()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _feats_to_torch(f) -> ScanFeatures:
    def cloud(c):
        return FeatureCloud(*(_t(x) for x in c))

    return ScanFeatures(
        *(cloud(getattr(f, n)) for n in ("sharp", "less_sharp", "flat",
                                          "less_flat", "full")),
        less_sharp_slab=RingSlab(_t(f.less_sharp_slab.xyz)),
        less_flat_slab=RingSlab(_t(f.less_flat_slab.xyz)))


@pytest.fixture(scope="module")
def polar_drive():
    """The JAX engine over 4 polar frames (chunk 2), with its state after
    frame 2 copied out before the next chunk donates it."""
    scene = synthetic.urban_scene(21)
    poses = synthetic.drive_trajectory(4, speed=1.0, yaw_rate=0.02)
    imgs = [synthetic.simulate_scan_polar(scene, T, n_scans=64,
                                          n_azimuth=900, seed=k)
            for k, T in enumerate(poses)]
    eng = jls.LoamEngine(CFG, chunk=2)
    eng.push_polar(imgs[0])
    eng.push_polar(imgs[1])
    st2 = jax.tree.map(np.asarray, eng.state)
    eng.push_polar(imgs[2])
    eng.push_polar(imgs[3])
    outs = eng.finish()
    elev = np.radians(synthetic.hdl64_elevations(64)).astype(np.float32)
    feats2 = jsr.register_scan_polar(jnp.asarray(imgs[2]), jnp.asarray(elev),
                                     CFG.lidar, CFG.scanreg)
    return imgs, poses, st2, outs, feats2


def test_solve_lo_matches_jax_on_carried_state(polar_drive):
    _, _, st2, _, f2 = polar_drive
    qj, tj, ncj, nsj = jodo.solve_lo(
        f2.sharp, f2.flat, jls.RingSlab(jnp.asarray(st2.corner_last.xyz)),
        jls.RingSlab(jnp.asarray(st2.surf_last.xyz)),
        jnp.asarray(st2.q_f2f), jnp.asarray(st2.t_f2f), CFG.lo)
    st = convert.loam_state_from_numpy(st2, "cpu")
    ft = _feats_to_torch(f2)
    qt, tt, nct, nst = todo.solve_lo(ft.sharp, ft.flat, st.corner_last,
                                     st.surf_last, st.q_f2f, st.t_f2f, CFG.lo)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    assert int(ncj) > 100 and int(nsj) > 100
    assert abs(int(nct) - int(ncj)) <= 2 and abs(int(nst) - int(nsj)) <= 2


def test_solve_lo_deskew_matches_jax_on_carried_state(polar_drive):
    """distortion=True: per-point slerp by relative time, linearized in
    closed form by the port and by jacfwd in the reference."""
    _, _, st2, _, f2 = polar_drive
    lo = dataclasses.replace(CFG.lo, distortion=True)
    qj, tj, ncj, nsj = jodo.solve_lo(
        f2.sharp, f2.flat, jls.RingSlab(jnp.asarray(st2.corner_last.xyz)),
        jls.RingSlab(jnp.asarray(st2.surf_last.xyz)),
        jnp.asarray(st2.q_f2f), jnp.asarray(st2.t_f2f), lo)
    q0, t0, _, _ = jodo.solve_lo(
        f2.sharp, f2.flat, jls.RingSlab(jnp.asarray(st2.corner_last.xyz)),
        jls.RingSlab(jnp.asarray(st2.surf_last.xyz)),
        jnp.asarray(st2.q_f2f), jnp.asarray(st2.t_f2f), CFG.lo)
    st = convert.loam_state_from_numpy(st2, "cpu")
    ft = _feats_to_torch(f2)
    qt, tt, nct, nst = todo.solve_lo(ft.sharp, ft.flat, st.corner_last,
                                     st.surf_last, st.q_f2f, st.t_f2f, lo)
    # the deskew moves the solution (so this is not the default path)
    assert np.abs(np.asarray(tj) - np.asarray(t0)).max() > 1e-3
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    assert int(ncj) > 100 and int(nsj) > 100
    assert abs(int(nct) - int(ncj)) <= 2 and abs(int(nst) - int(nsj)) <= 2


def test_solve_mapping_matches_jax_on_carried_map(polar_drive):
    _, _, st2, outs_j, f2 = polar_drive
    m = CFG.mapping
    stacks = []
    for cloud, res, cap in ((f2.less_sharp, m.line_resolution,
                             m.corner_stack_cap),
                            (f2.less_flat, m.plane_resolution,
                             m.surf_stack_cap)):
        xyz, _, _, mask = jax.jit(jvox.voxel_downsample,
                                  static_argnums=(2, 3))(
            cloud.xyz, cloud.mask, res, cap)
        stacks += [np.asarray(xyz), np.asarray(mask)]
    q_pred = outs_j[2, 14:18]  # the engine's own solution: a prediction
    t_pred = outs_j[2, 18:21]  # that is already converged
    cube_j = jax.tree.map(jnp.asarray, st2.cube)
    _, qj, tj, sj = jmap.solve_mapping(cube_j, *map(jnp.asarray, stacks),
                                       jnp.asarray(q_pred),
                                       jnp.asarray(t_pred), m)
    assert bool(sj["solved"])
    cube_t = convert.loam_state_from_numpy(st2, "cpu").cube
    new_t, qt, tt, st = tmap.solve_mapping(cube_t, *map(_t, stacks),
                                           _t(q_pred), _t(t_pred), m)
    assert bool(st["solved"])
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=3e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=5e-3)
    assert int(new_t.corner.n_live) > int(cube_t.corner.n_live)


def test_frame_step_on_carried_state_matches_jax_engine(polar_drive):
    _, _, st2, outs_j, f2 = polar_drive
    st = convert.loam_state_from_numpy(st2, "cpu")
    pq = torch.tensor([0.0, 0.0, 0.0, 1.0])
    new, out = tls.loam_frame_step_feats(
        st, _feats_to_torch(f2), pq, torch.zeros(3), torch.tensor(False),
        CFG)
    np.testing.assert_allclose(out.numpy()[:14], outs_j[2, :14], atol=1e-4)
    np.testing.assert_allclose(out.numpy()[14:18], outs_j[2, 14:18],
                               atol=3e-4)
    np.testing.assert_allclose(out.numpy()[18:21], outs_j[2, 18:21],
                               atol=5e-3)
    assert abs(out[21].item() - outs_j[2, 21]) <= 2  # correspondences
    assert abs(out[22].item() - outs_j[2, 22]) <= 2
    assert int(new.frame_idx) == 3


def test_push_polar_matches_jax_engine(polar_drive):
    imgs, poses, _, outs_j, _ = polar_drive
    eng = tls.LoamEngine(CFG, chunk=2, device="cpu")
    for img in imgs:
        eng.push_polar(img)
    o_t = tls.unpack_outputs(eng.finish())
    o_j = jls.unpack_outputs(outs_j)
    np.testing.assert_allclose(o_t["t_w_lo"], o_j["t_w_lo"], atol=1e-3)
    np.testing.assert_allclose(o_t["t_w_mo"], o_j["t_w_mo"], atol=1e-2)
    gt = np.stack([T[:3, 3] for T in poses])
    assert np.linalg.norm(o_t["t_w_mo"] - gt, axis=1).max() < 0.3


def test_port_engine_reproduces_golden_drive():
    scene = synthetic.urban_scene(42)
    poses = synthetic.drive_trajectory(6, speed=1.0, yaw_rate=0.015)
    eng = tls.LoamEngine(CFG, chunk=3, device="cpu")
    for k, T in enumerate(poses):
        eng.push(synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=700,
                                         seed=k))
    res = tls.unpack_outputs(eng.finish())
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(res["t_w_lo"], golden[0], atol=2e-2)
    np.testing.assert_allclose(res["t_w_mo"], golden[1], atol=3e-2)
    gt = np.stack([T[:3, 3] for T in poses])
    assert np.linalg.norm(res["t_w_mo"] - gt, axis=1).max() < 0.15


def test_convert_round_trip_is_exact(polar_drive):
    st2 = polar_drive[2]
    back = convert.loam_state_to_numpy(
        convert.loam_state_from_numpy(st2, "cpu"))
    a, b = jax.tree.leaves(st2), jax.tree.leaves(tuple(back))
    assert len(a) == len(b) == 14
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_pack12_round_trip(rng):
    img = rng.integers(0, 4096, (64, 900)).astype(np.uint16)
    packed = tls.pack12(img)
    np.testing.assert_array_equal(packed, jls.pack12(img))
    np.testing.assert_array_equal(tls.unpack12(_t(packed)).numpy(), img)


def test_engine_pack12_matches_uint16():
    """pack12 staging is exact, so a pack12 engine gives identical rows."""
    scale = 0.03  # 122.8 m reach in 12 bits
    scene = synthetic.urban_scene(5)
    poses = synthetic.drive_trajectory(2, speed=1.0, yaw_rate=0.02)
    imgs = [synthetic.simulate_scan_polar(scene, T, n_scans=64, n_azimuth=900,
                                          seed=k, range_scale=scale)
            for k, T in enumerate(poses)]

    def run(packed):
        eng = tls.LoamEngine(CFG, chunk=2, device="cpu", pack12=packed)
        for img in imgs:
            eng.push_polar(img, range_scale=scale)
        return eng.finish()

    np.testing.assert_array_equal(run(True), run(False))


def test_polar_to_xyz_matches_jax(rng):
    img = rng.integers(0, 20000, (8, 96)).astype(np.uint16)
    img[:, ::5] = 0  # no return: decodes to the origin
    elev = np.radians(rng.uniform(-24.0, 2.0, 8)).astype(np.float32)
    want = np.asarray(jls.polar_to_xyz(jnp.asarray(img), jnp.asarray(elev),
                                       0.005))
    got = tls.polar_to_xyz(_t(img.astype(np.int32)), _t(elev), 0.005)
    assert got.shape == want.shape == (8 * 96, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert (got.numpy().reshape(8, 96, 3)[:, ::5] == 0).all()


def test_port_never_imports_jax():
    """Neither jax nor the JAX package: the port runs without them."""
    code = ("import sys, vloam_tpu_torch, vloam_tpu_torch.lidar.loam_step, "
            "vloam_tpu_torch.convert, vloam_tpu_torch.kernels.build, "
            "vloam_tpu_torch.config, vloam_tpu_torch.data.synthetic, "
            "vloam_tpu_torch.lidar.batch_mapping, "
            "vloam_tpu_torch.tools.timing, "
            "vloam_tpu_torch.tools.profile_row_gather, "
            "vloam_tpu_torch.tools.profile_ring_variants; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vloam_tpu')); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_only_the_port():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert "vloam_tpu_torch.config" in mods
    assert "vloam_tpu_torch.lidar.loam_step" in mods  # the batch engine's
    assert "vloam_tpu_torch.tools" in mods  # the measurement entry points
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "vloam_tpu")]
    # and no module of the port imports them either, the new ones included
    for path in (REPO / "vloam_tpu_torch").rglob("*.py"):
        sub = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(sub) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module for n in ast.walk(sub)
                  if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert not [m for m in names if m and m.split(".")[0] in
                    ("jax", "jaxlib", "vloam_tpu")], path
    assert (REPO / "vloam_tpu_torch/lidar/batch_mapping.py").exists()
    assert (REPO / "vloam_tpu_torch/tools/profile_row_gather.py").exists()


@pytest.mark.parametrize("profile", ["kitti_hdl64", "tiny_test_profile"])
def test_port_config_equals_jax_config(profile):
    """Every field of the port's own config.py equals the JAX package's
    field of the same name."""
    from vloam_tpu import config as jcfg
    from vloam_tpu_torch import config as tcfg

    want, got = getattr(jcfg, profile)(), getattr(tcfg, profile)()
    for section in ("lidar", "scanreg", "lo", "mapping"):
        g, w = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), f.name


def test_port_synthetic_equals_jax_synthetic():
    """The port's scene generator and raycaster give bit-identical scenes,
    poses and scans for the same seeds."""
    from vloam_tpu_torch.data import synthetic as tsyn

    for seed, extent, scatter in ((0, 80.0, 0), (7, 60.0, 5)):
        sj = synthetic.urban_scene(seed, extent=extent, scatter=scatter)
        st = tsyn.urban_scene(seed, extent=extent, scatter=scatter)
        np.testing.assert_array_equal(st.boxes, sj.boxes)
        np.testing.assert_array_equal(st.poles, sj.poles)
    yaw = np.linspace(-0.02, 0.02, 5)
    pj = synthetic.drive_trajectory(5, speed=1.1, yaw_rate=yaw)
    pt = tsyn.drive_trajectory(5, speed=1.1, yaw_rate=yaw)
    np.testing.assert_array_equal(np.stack(pt), np.stack(pj))
    for n in (16, 32, 64):
        np.testing.assert_array_equal(tsyn.hdl64_elevations(n),
                                      synthetic.hdl64_elevations(n))
    for k, T in enumerate(pj[::2]):
        np.testing.assert_array_equal(
            tsyn.simulate_scan_polar(st, T, n_scans=64, n_azimuth=360,
                                     seed=k),
            synthetic.simulate_scan_polar(sj, T, n_scans=64, n_azimuth=360,
                                          seed=k))
        np.testing.assert_array_equal(
            tsyn.simulate_scan(st, T, n_scans=16, n_azimuth=300, seed=k),
            synthetic.simulate_scan(sj, T, n_scans=16, n_azimuth=300,
                                    seed=k))
    pts = np.ones((10, 3), np.float32)
    for cap in (4, 16):
        a, b = tsyn.pad_scan(pts, cap), synthetic.pad_scan(pts, cap)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py has no CPU fallback: without a GPU it exits nonzero
    and prints no result line."""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    assert not (tmp_path / "build").exists()


def test_kernel_library_hash_covers_headers(monkeypatch, tmp_path):
    """An edited header (csrc/*.cuh) must change the library's name, or a
    stale library would be loaded."""
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n')
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path()
    (tmp_path / "b.cuh").write_text("// one\n")
    with_header = build.library_path()
    (tmp_path / "b.cuh").write_text("// two\n")
    assert len({before, with_header, build.library_path()}) == 3


def test_kernel_resource_usage_reads_the_ptxas_report(monkeypatch, tmp_path):
    lib = tmp_path / "libvloam_kernels_0.so"
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__afb5848a_"
        "12_ring_min2_cu_c45ff21016ring_min2_kernelEPKfS1_PfPiS2_S3_ii' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN45_GLOBAL__N__afb5848a\n"
        "    8 bytes stack frame, 16 bytes spill stores, 24 bytes spill "
        "loads\n"
        "ptxas info    : Used 62 registers, used 1 barriers, 16384 bytes "
        "smem\n"
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__c5974a73_"
        "15_select_rings_cu_6f67219c19select_rings_kernelILi10EEEvPKfPKiS4_"
        "PiNS_6ParamsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 54 registers, used 1 barriers\n")
    monkeypatch.setattr(build, "library_path", lambda: lib)
    assert build.resource_usage("ring_min2") == {"ring_min2_kernel": {
        "registers": 62, "stack": 8, "spill_stores": 16, "spill_loads": 24,
        "smem": 16384}}
    assert build.resource_usage()["select_rings_kernel<10>"] == {
        "registers": 54, "stack": 0, "spill_stores": 0, "spill_loads": 0,
        "smem": 0}
