"""The mesh measurement tools of the port (vloam_tpu_torch/tools/
model_mesh_scaling.py, bench_mesh.py) on the CPU, in this process (a
one-rank gloo group), against the JAX package and its scripts:

- model_mesh_scaling's counts() and model() equal scripts/
  model_mesh_scaling.py's arithmetic (its lines 135-160, written out here)
  for given stage times and link;
- the D = 1 mesh mapping chunk's stages (parallel/mesh_fused.py's
  MeshFrameStages with sharded_mapping's rounds_setup, round_knn, round_lm,
  as the tool times them), run in order, give the chunk's rows and map bit
  for bit, frame after frame, on the map a mesh LoamEngine leaves after the
  tiny drive;
- bench_mesh's mesh_cfg equals tests/test_mesh_pipeline.py's field by
  field (the fields the port carries), and its frame at D = 1 in process:
  the pose within the port's bounds against the JAX engines
  (tests/test_torch_mesh.py: MO 1e-2 m; 5e-3 rad) of the JAX
  mesh_solve_mapping on a one-device mesh over the script's frame, and
  within that file's 0.01 m of the port's own single-device solve_mapping
  (the flat map's exact 5-NN against the 8-cell probe).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from vloam_tpu_torch.parallel import sharded as tsh
from vloam_tpu_torch.tools import bench_mesh
from vloam_tpu_torch.tools import model_mesh_scaling as mms

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return tsh.data_mesh(device="cpu")


def _script_model(t_frame_d1, t_lm, t_insert, window_rows, mcfg, gbps,
                  hop_latency_us):
    """scripts/model_mesh_scaling.py:135-160 as the script computes them."""
    W = window_rows
    cap_c, cap_s = mcfg.corner_bucket_cap, mcfg.surf_bucket_cap
    Qc, Qs = mcfg.corner_stack_cap, mcfg.surf_stack_cap
    rounds = mcfg.outer_rounds
    knn_macs = rounds * (Qc * W * cap_c + Qs * W * cap_s) * 4
    hop_bytes_total = (W * cap_c + W * cap_s) * 3 * 4
    t_sharded_d1 = max(t_frame_d1 - t_lm - t_insert, 0.1)
    rows = []
    for D in (1, 2, 4, 8):
        t_shard = t_sharded_d1 / D
        hop_ms = ((hop_bytes_total / D) / (gbps * 1e9) * 1e3
                  + hop_latency_us / 1e3)
        t_comm = rounds * (D - 1) * hop_ms
        t_d = t_shard + t_lm + t_insert + t_comm
        eff = t_frame_d1 / (D * t_d)
        rows.append((D, t_d, t_shard, t_comm, eff))
    return knn_macs, hop_bytes_total, rows


@pytest.mark.parametrize("times", [(6.21, 2.6, 0.9), (2.0, 1.5, 0.45)])
def test_counts_and_model_are_the_scripts(times):
    from vloam_tpu_torch.config import kitti_hdl64

    cfg = kitti_hdl64()
    link = {"gbps": 45.0, "hop_latency_us": 1.0}
    knn, hop, want = _script_model(*times, 4096, cfg.mapping, link["gbps"],
                                   link["hop_latency_us"])
    cnt = mms.counts(cfg, 4096)
    assert (cnt["knn_macs"], cnt["per_hop_bytes"]) == (knn, hop)
    assert cnt["rounds"] == cfg.mapping.outer_rounds
    got = mms.model(dict(zip(("mesh_d1", "lm", "insert"), times)), cnt, link)
    assert [r["D"] for r in got] == [1, 2, 4, 8]
    for r, (D, t_d, t_shard, t_comm, eff) in zip(got, want):
        assert (r["t_ms"], r["t_shard"], r["t_comm"], r["efficiency"]) == (
            t_d, t_shard, t_comm, eff)
    assert mms.LINK["measured"] is False and mms.LINK["gbps"] == 450.0


def test_mesh_chunk_stages_compose_the_chunk(mesh, tmp_path, monkeypatch):
    """Two frames through the stages, the second on the first's state,
    against make_mesh_mapping_chunk over the same two frames."""
    import tempfile

    from vloam_tpu_torch.config import tiny_test_profile
    from vloam_tpu_torch.lidar import scan_registration as sr
    from vloam_tpu_torch.lidar.loam_step import LoamEngine
    from vloam_tpu_torch.lidar.voxel import voxel_downsample
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.parallel.mesh_fused import (MeshFrameStages,
                                                     make_mesh_mapping_chunk)

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg = tiny_test_profile()
    S, W = cfg.lidar.n_scans, 256
    frames = mms.drive(S, 360, 1)
    eng = LoamEngine(cfg, chunk=2, mesh=mesh, mesh_window_rows=W,
                     device="cpu")
    for f in frames[:3]:
        eng.push_polar(f)
    eng.finish()
    elev = torch.tensor(np.radians(synthetic.hdl64_elevations(S)),
                        dtype=torch.float32)
    dirs = sr.polar_directions(elev, 360)
    m = cfg.mapping
    stacks, poses = [], []
    for k in (2, 3):
        feats = sr.register_scan_polar(
            torch.from_numpy(frames[k].astype(np.int32)), dirs, cfg.lidar,
            cfg.scanreg)
        stacks.append(
            voxel_downsample(feats.less_sharp.xyz, feats.less_sharp.mask,
                             m.line_resolution, m.corner_stack_cap)[::3]
            + voxel_downsample(feats.less_flat.xyz, feats.less_flat.mask,
                               m.plane_resolution, m.surf_stack_cap)[::3])
        poses.append((torch.tensor([0.0, 0.02 * k, 0.0, 1.0]),
                      torch.tensor([1.1 * k, 0.0, 0.0])))
    mstate = eng.state[1]
    chunk = make_mesh_mapping_chunk(mesh, cfg, W)
    c_xyz, c_m, s_xyz, s_m = (torch.stack([s[i] for s in stacks])
                              for i in range(4))
    q_w = torch.stack([p[0] for p in poses])
    q_w = q_w / q_w.norm(dim=1, keepdim=True)
    t_w = torch.stack([p[1] for p in poses])
    want_state, want = chunk(mstate, c_xyz, c_m, s_xyz, s_m, q_w, t_w)
    st = MeshFrameStages(mesh, cfg, W)
    state, rows = mstate, []
    for f in range(2):
        stages = mms.frame_stages(st, state, c_xyz[f], c_m[f], s_xyz[f],
                                  s_m[f], q_w[f], t_w[f], m)
        assert [k for k, _, _ in stages] == (
            ["window", "setup"]
            + [f"{p}{r}" for r in range(m.outer_rounds) for p in ("knn",
                                                                  "lm")]
            + ["update", "tail"])
        state, out = mms.run_stages(stages)["tail"]
        rows.append(out)
    assert torch.equal(torch.cat(rows)[:, :8], want[:, :8])
    assert torch.equal(torch.cat(rows)[:, 8:], want[:, 8:])
    for a, b in zip(jax.tree_util.tree_leaves(tuple(state)),
                    jax.tree_util.tree_leaves(tuple(want_state))):
        assert torch.equal(a, b)
    assert torch.isfinite(want).all() and (want[:, 7] == 1).all()


def test_bench_mesh_config_is_the_tests():
    from test_mesh_pipeline import mesh_cfg

    want, got = mesh_cfg(), bench_mesh.mesh_cfg()
    for part in ("lidar", "scanreg", "mapping", "lo"):
        w = dataclasses.asdict(getattr(want, part))
        g = dataclasses.asdict(getattr(got, part))
        # every field the port's configuration carries
        assert g == {k: w[k] for k in g}, part


def test_bench_mesh_at_one_rank_matches_jax(mesh):
    from test_mesh_pipeline import _run_single_device, _scan_frames, mesh_cfg

    from vloam_tpu.data import synthetic
    from vloam_tpu.lidar.odometry import LaserOdometry
    from vloam_tpu.lidar.scan_registration import register_scan
    from vloam_tpu.lidar.voxel import voxel_downsample
    from vloam_tpu.parallel.mesh_pipeline import mesh_solve_mapping
    from vloam_tpu.parallel.sharded import data_mesh

    # the script's frame, as scripts/bench_mesh.py builds it
    cfg = mesh_cfg()
    scans = _scan_frames(cfg, bench_mesh.N_FRAMES, seed=bench_mesh.SEED)
    _, mo = _run_single_device(cfg, scans[:-1])
    lo = LaserOdometry(cfg.lo)
    for pts in scans:
        padded, n = synthetic.pad_scan(pts, cfg.lidar.max_points)
        feats = register_scan(jnp.asarray(padded), jnp.int32(n), cfg.lidar,
                              cfg.scanreg)
        lo_out = lo.step(feats)
    q_pred = (R.from_quat(mo.q_wmap_wodom)
              * R.from_quat(np.asarray(lo_out["q_w"]))).as_quat()
    t_pred = mo.t_wmap_wodom + R.from_quat(mo.q_wmap_wodom).apply(
        np.asarray(lo_out["t_w"]))
    c_xyz, _, _, c_m = voxel_downsample(
        feats.less_sharp.xyz, feats.less_sharp.mask,
        cfg.mapping.line_resolution, cfg.mapping.corner_stack_cap)
    s_xyz, _, _, s_m = voxel_downsample(
        feats.less_flat.xyz, feats.less_flat.mask,
        cfg.mapping.plane_resolution, cfg.mapping.surf_stack_cap)
    _, qj, tj, _ = mesh_solve_mapping(
        data_mesh(jax.devices()[:1]), mo.map, c_xyz, c_m, s_xyz, s_m,
        jnp.asarray(q_pred, jnp.float32), jnp.asarray(t_pred, jnp.float32),
        cfg.mapping)

    tcfg = bench_mesh.mesh_cfg()
    frame = bench_mesh.build_frame(tcfg, "cpu")
    q_ref, t_ref = bench_mesh.single_solve(frame, tcfg)
    res = bench_mesh.mesh_solve(mesh, frame, tcfg, reps=1)
    assert np.isfinite(res["t"]).all() and res["ms"] > 0
    assert res["counts"].shape == (1,) and res["counts"][0] > 100
    np.testing.assert_allclose(res["t"], np.asarray(tj), atol=1e-2)
    assert (R.from_quat(res["q"]).inv()
            * R.from_quat(np.asarray(qj))).magnitude() < 5e-3
    np.testing.assert_allclose(res["t"], t_ref, atol=1e-2)
    # the frame moved the pose: the comparison is not vacuous
    assert np.linalg.norm(t_ref - frame["t_pred"].numpy()) > 1e-4
