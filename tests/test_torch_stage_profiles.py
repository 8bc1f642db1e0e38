"""The stage profilers' splits of a frame (vloam_tpu_torch/tools/
profile_stages.py, profile_vision_stages.py, profile_batch_stages.py) on
the CPU at the tiny profile (16 rings x 360 columns, 320 x 96 images).

- Each split, its stages run in order, gives the engine's rows and state
  bit for bit: the LoamEngine polar and xyz frames against
  loam_run_chunk_polar / loam_run_chunk and LoamEngine's push_polar /
  push over 3 frames; the combined frame against vision_lo_run_chunk_polar
  + mapping_run_chunk and VloamEngine.push_polar; the lockstep frame of a
  B = 2 batch (two different drives) against loam_run_chunk_batch_polar.
  The tools' "whole frame" calls (engine functions) give the same.
- The LoamEngine split over 3 xyz frames against the JAX package's jitted
  loam_frame_step from its own state: LO position 1e-3 m and MO position
  1e-2 m per frame, the drive tolerances of
  tests/test_torch_loam_engine.py::test_push_polar_matches_jax_engine.
- The sub-stages that are compositions, not functions of the port, against
  the JAX scripts' same compositions: register_scan's front half
  (scripts/profile_scanreg.py's upto_layout) and the strict selection
  (its vmapped _select_ring): counts, layout and labels exact. The LMs on
  fixed terms (profile_lo.py's lm_only, profile_mapping.py's lm_once,
  profile_batch_flat.py's batched round) from the same terms: poses to
  1e-4 (quaternion / m), the carried-state LO tolerance of
  tests/test_torch_loam_engine.py; their inputs' discrete parts (the
  association and plane masks) are the same tensors.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.config import tiny_test_profile as jax_tiny
from vloam_tpu.geometry import so3 as jso3
from vloam_tpu.lidar import batch_mapping as jbm
from vloam_tpu.lidar import loam_step as jls
from vloam_tpu.lidar import mapping as jmap
from vloam_tpu.lidar import odometry as jodo
from vloam_tpu.lidar import scan_registration as jsr
from vloam_tpu.solver.lm import ResidualFamily, lm_solve
from vloam_tpu_torch.config import tiny_test_profile
from vloam_tpu_torch.data import synthetic
from vloam_tpu_torch.geometry import so3
from vloam_tpu_torch.lidar import batch_mapping as tbm
from vloam_tpu_torch.lidar import loam_step as tls
from vloam_tpu_torch.lidar import scan_registration as tsr
from vloam_tpu_torch.lidar.gridmap import grid_gather_pair
from vloam_tpu_torch.lidar.mapping import _corner_terms, _surf_terms
from vloam_tpu_torch.lidar.odometry import associate_corners, associate_surfs
from vloam_tpu_torch.tools import profile_batch_stages as pb
from vloam_tpu_torch.tools import profile_stages as ps
from vloam_tpu_torch.tools import profile_vision_stages as pv
from vloam_tpu_torch.vloam_step import (MapState, VisionLoState, VloamEngine,
                                        mapping_run_chunk,
                                        vision_lo_run_chunk_polar)

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

CFG = tiny_test_profile()
S, A = CFG.lidar.n_scans, 360
N = 3


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _poses(n=N, speed=1.1, yaw=0.01):
    return synthetic.drive_trajectory(n, speed=speed, yaw_rate=yaw)


def _polar(poses, scene=0):
    sc = synthetic.urban_scene(scene, extent=80.0)
    return [synthetic.simulate_scan_polar(sc, T, n_scans=S, n_azimuth=A,
                                          seed=k)
            for k, T in enumerate(poses)]


def _xyz(poses):
    sc = synthetic.urban_scene(0, extent=80.0)
    return [synthetic.pad_scan(synthetic.simulate_scan(
        sc, T, n_scans=S, n_azimuth=A, seed=k), CFG.lidar.max_points)
        for k, T in enumerate(poses)]


def _dirs():
    elev = torch.tensor(np.radians(synthetic.hdl64_elevations(S)),
                        dtype=torch.float32)
    return tsr.polar_directions(elev, A)


def _priors(n=None):
    pq = so3.identity_quat("cpu")
    pt = torch.zeros(3)
    up = torch.zeros((), dtype=torch.bool)
    if n is None:
        return pq, pt, up
    return pq.expand(n, 4), pt.expand(n, 3), up.expand(n)


@pytest.fixture(scope="module")
def polar():
    return [torch.from_numpy(f.astype(np.int32)) for f in _polar(_poses())]


@pytest.fixture(scope="module")
def xyz():
    return _xyz(_poses())


def test_loam_polar_stages_equal_the_engine(polar):
    dirs = _dirs()
    pq, pt, up = _priors()
    st, rows = tls.LoamState.create(CFG, "cpu"), []
    st_w = st
    for r in polar:
        feats = tsr.register_scan_polar(r, dirs, CFG.lidar, CFG.scanreg)
        st, out = ps.frame_by_stages(st, feats, pq, pt, up, CFG)
        st_w, out_w = tls.loam_frame_step_feats(st_w, feats, pq, pt, up, CFG)
        assert torch.equal(out, out_w)
        rows.append(out)
    st_e, outs_e = tls.loam_run_chunk_polar(
        tls.LoamState.create(CFG, "cpu"), torch.stack(polar), dirs,
        *_priors(N), CFG)
    assert torch.equal(torch.stack(rows), outs_e)
    _assert_same(st, st_e)
    eng = tls.LoamEngine(CFG, chunk=N, device="cpu")
    for r in polar:
        eng.push_polar(r.numpy().astype(np.uint16))
    np.testing.assert_array_equal(eng.finish(), outs_e.numpy())


def test_loam_xyz_stages_equal_the_engine(xyz):
    pq, pt, up = _priors()
    st, rows = tls.LoamState.create(CFG, "cpu"), []
    for scan, n in xyz:
        feats = tsr.register_scan(torch.from_numpy(scan), torch.tensor(n),
                                  CFG.lidar, CFG.scanreg)
        st, out = ps.frame_by_stages(st, feats, pq, pt, up, CFG)
        rows.append(out)
    scans = torch.from_numpy(np.stack([s for s, _ in xyz]))
    ns = torch.tensor([n for _, n in xyz])
    st_e, outs_e = tls.loam_run_chunk(tls.LoamState.create(CFG, "cpu"),
                                      scans, ns, *_priors(N), CFG)
    assert torch.equal(torch.stack(rows), outs_e)
    _assert_same(st, st_e)
    eng = tls.LoamEngine(CFG, chunk=N, device="cpu")
    for scan, n in xyz:
        eng.push(scan[:n])
    np.testing.assert_array_equal(eng.finish(), outs_e.numpy())


def test_vloam_stages_equal_the_engine(polar):
    cfg = CFG.replace(detach_VO_LO=False)
    vo = cfg.vo
    calib, ext, geom = pv.engine_parts(cfg, A, "cpu")
    sc = synthetic.urban_scene(0, extent=80.0)
    imgs = [np.clip(synthetic.render_camera(
        sc, T @ calib.imu_T_cam0, calib.K, vo.img_width, vo.img_height)
        * 255.0, 0, 255).astype(np.uint8) for T in _poses()]
    im = [torch.from_numpy(i) for i in imgs]
    st, mst = VisionLoState.create(cfg, "cpu"), MapState.create(cfg, "cpu")
    st_w, mst_w = st, mst
    outs, mos = [], []
    for r, i in zip(polar, im):
        st, out, mst, mo = pv.frame_by_stages(st, mst, r, i, geom, ext, cfg)
        st_w, out_w, mst_w, mo_w = pv.whole_frame(st_w, mst_w, r, i, geom,
                                                  ext, cfg)
        assert torch.equal(out, out_w) and torch.equal(mo, mo_w)
        outs.append(out)
        mos.append(mo[0])
    st_e, vl_e, stacks = vision_lo_run_chunk_polar(
        VisionLoState.create(cfg, "cpu"), torch.stack(polar), geom,
        torch.stack(im), ext, cfg)
    mst_e, mo_e = mapping_run_chunk(MapState.create(cfg, "cpu"), *stacks,
                                    vl_e[:, 7:11], vl_e[:, 11:14], cfg)
    assert torch.equal(torch.stack(outs), vl_e)
    assert torch.equal(torch.stack(mos), mo_e)
    _assert_same(st, st_e)
    _assert_same(mst, mst_e)
    _assert_same(st_w, st_e)
    eng = VloamEngine(cfg, calib, chunk=N, device="cpu")
    for r, i in zip(polar, imgs):
        eng.push_polar(r.numpy().astype(np.uint16), i)
    vl, mo = torch.stack(outs).numpy(), mo_e.numpy()
    rows = np.concatenate([vl[:, :14], mo[:, :7], vl[:, 14:16], mo[:, 7:8],
                           vl[:, 16:]], axis=1)
    np.testing.assert_array_equal(eng.finish(), rows)
    with pytest.raises(ValueError, match="default VO path"):
        pv.frame_by_stages(st, mst, polar[0], im[0], geom, ext, cfg.replace(
            vo=dataclasses.replace(vo, clahe=True)))


def test_batch_stages_equal_the_engine(polar):
    B = 2
    dirs = _dirs()
    other = [torch.from_numpy(f.astype(np.int32))
             for f in _polar(_poses(yaw=-0.02), scene=1)]
    ranges = torch.stack([torch.stack(polar), torch.stack(other)])  # [B, F]
    st = tls.BatchLoamState.create(CFG, B, "cpu")
    st_w = st
    rows = []
    for f in range(N):
        feats = pb.register_stage(ranges[:, f], dirs, CFG, B)
        st, out = pb.frame_by_stages(st, feats, CFG, B)
        st_w, out_w = tls.batch_frame_step_feats(st_w, feats, CFG, B)
        assert torch.equal(out, out_w)
        rows.append(out)
    st = tls._batch_chunk_epilogue(st, CFG, B)
    st_e, outs_e = tls.loam_run_chunk_batch_polar(
        tls.BatchLoamState.create(CFG, B, "cpu"), ranges, dirs, CFG)
    assert torch.equal(torch.stack(rows, dim=1), outs_e)
    _assert_same(st, st_e)
    assert not torch.equal(outs_e[0], outs_e[1])


def _jax_cfg():
    return jax_tiny()


def test_loam_stages_match_jax_loam_frame_step(xyz):
    jcfg = _jax_cfg()
    step = jax.jit(partial(jls.loam_frame_step, cfg=jcfg))
    js = jls.LoamState.create(jcfg)
    q0, t0 = jnp.asarray([0, 0, 0, 1.0], jnp.float32), jnp.zeros(3)
    pq, pt, up = _priors()
    st = tls.LoamState.create(CFG, "cpu")
    for scan, n in xyz:
        js, out_j = step(js, jnp.asarray(scan), jnp.int32(n), q0, t0,
                         jnp.asarray(False))
        feats = tsr.register_scan(torch.from_numpy(scan), torch.tensor(n),
                                  CFG.lidar, CFG.scanreg)
        st, out = ps.frame_by_stages(st, feats, pq, pt, up, CFG)
        out, out_j = out.numpy(), np.asarray(out_j)
        np.testing.assert_allclose(out[11:14], out_j[11:14], atol=1e-3)
        np.testing.assert_allclose(out[18:21], out_j[18:21], atol=1e-2)
    assert int(st.frame_idx) == N
    assert int(np.asarray(js.frame_idx)) == N


def _jax_upto_layout(s, n, prof):
    """scripts/profile_scanreg.py's upto_layout."""
    nn = s.shape[0]
    in_range = jnp.arange(nn) < n
    finite = jnp.all(jnp.isfinite(s), axis=-1)
    s = jnp.where(finite[:, None], s, 0.0)
    rng_sq = jnp.sum(s * s, axis=-1)
    valid_range = in_range & finite & (rng_sq >= prof.minimum_range**2)
    ring, valid = jsr.assign_rings(s, valid_range, prof)
    rel = jsr._relative_time(s, valid_range, valid)
    return jsr._ring_layout(s, ring, rel, valid, prof.n_scans,
                            prof.ring_capacity)


def test_scanreg_sub_stages_match_the_jax_scripts(xyz):
    jcfg = _jax_cfg()
    scan, n = xyz[1]
    pts_j, rt_j, cnt_j = jax.jit(partial(_jax_upto_layout,
                                         prof=jcfg.lidar))(
        jnp.asarray(scan), jnp.int32(n))
    pts, rt, cnt = ps.xyz_layout(torch.from_numpy(scan), torch.tensor(n),
                                 CFG.lidar)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(pts_j))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rt_j))
    curv_j = jax.jit(jsr._curvature)(pts_j)
    label_j = jax.jit(jax.vmap(partial(jsr._select_ring,
                                       cfg=jcfg.scanreg)))(
        pts_j, curv_j, cnt_j)[0]
    label = ps.select_stage(torch.from_numpy(np.array(pts_j)),
                            torch.from_numpy(np.array(curv_j)),
                            torch.from_numpy(np.array(cnt_j)), CFG.scanreg)
    np.testing.assert_array_equal(label.numpy(), np.asarray(label_j))
    assert (label.numpy() == 2).any() and (label.numpy() == -1).any()


def _np(x):
    return jnp.asarray(x.numpy())


def _jax_x(x):
    return jnp.asarray(x.numpy())


def test_lo_lm_on_fixed_terms_matches_profile_lo(xyz):
    lo = CFG.lo
    f0, f1 = (tsr.register_scan(torch.from_numpy(s), torch.tensor(n),
                                CFG.lidar, CFG.scanreg) for s, n in xyz[:2])
    x = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    corner = associate_corners(f1.sharp, f0.less_sharp_slab, x, lo)
    surf = associate_surfs(f1.flat, f0.less_flat_slab, x, lo)
    assert int(corner[3].sum()) > 10 and int(surf[2].sum()) > 10
    got = ps.lo_lm_on_fixed_terms(f1.sharp, f1.flat, corner, surf, x, lo)
    a, b, de, v_c = (_np(t) for t in corner)
    pj, n_hat, v_s = (_np(t) for t in surf)
    sharp, flat = _np(f1.sharp.xyz), _np(f1.flat.xyz)

    def make_families(xx):  # profile_lo.py's lm_only
        qq, tt = xx[:4], xx[4:]

        def edge_fn(delta):
            qd = jso3.quat_multiply(qq, jso3.quat_from_axis_angle(delta[:3]))
            lp = jso3.quat_rotate(qd, sharp) + tt + delta[3:]
            nu = jnp.cross(lp - a, lp - b)
            return nu / jnp.maximum(de, 1e-9)[:, None]

        def plane_fn(delta):
            qd = jso3.quat_multiply(qq, jso3.quat_from_axis_angle(delta[:3]))
            lp = jso3.quat_rotate(qd, flat) + tt + delta[3:]
            return jnp.sum((lp - pj) * n_hat, axis=-1, keepdims=True)

        return [ResidualFamily(edge_fn, v_c.astype(jnp.float32)),
                ResidualFamily(plane_fn, v_s.astype(jnp.float32))]

    want = jax.jit(lambda xx: lm_solve(make_families, jodo._retract, xx,
                                       dim=6, iterations=lo.gn_iterations,
                                       huber_delta=lo.huber_delta))(_jax_x(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert not np.allclose(got.numpy(), x.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def map_frame(polar):
    """The state two polar frames leave, frame 2's stacks and its
    prediction (the MO section's inputs)."""
    dirs = _dirs()
    pq, pt, up = _priors()
    st = tls.LoamState.create(CFG, "cpu")
    for r in polar[:2]:
        st = tls.loam_frame_step_feats(st, tsr.register_scan_polar(
            r, dirs, CFG.lidar, CFG.scanreg), pq, pt, up, CFG)[0]
    feats = tsr.register_scan_polar(polar[2], dirs, CFG.lidar, CFG.scanreg)
    lo = ps.lo_stage(st, feats, pq, pt, up, CFG)
    m = CFG.mapping
    stacks = (*ps.voxel_stage(feats.less_sharp, m.line_resolution,
                              m.corner_stack_cap),
              *ps.voxel_stage(feats.less_flat, m.plane_resolution,
                              m.surf_stack_cap))
    q = so3.quat_normalize(so3.quat_multiply(st.q_wmap_wodom, lo[4]))
    t = st.t_wmap_wodom + so3.quat_rotate(st.q_wmap_wodom, lo[5])
    return st, stacks, torch.cat([q, t])


def _jax_mo_lm(c_xyz, s_xyz, corner, surf, x, m):
    """profile_mapping.py's lm_once on the given terms."""
    a, b, de, v_c = (_np(t) for t in corner)
    n_hat, nood, v_s = (_np(t) for t in surf)
    cx, sx = _np(c_xyz), _np(s_xyz)

    def make_families(xx):
        def edge_fn(delta):
            qd = jso3.quat_multiply(xx[:4],
                                    jso3.quat_from_axis_angle(delta[:3]))
            pw = jso3.quat_rotate(qd, cx) + xx[4:] + delta[3:]
            nu = jnp.cross(pw - a, pw - b)
            return nu / jnp.maximum(de, 1e-9)[:, None]

        def plane_fn(delta):
            qd = jso3.quat_multiply(xx[:4],
                                    jso3.quat_from_axis_angle(delta[:3]))
            pw = jso3.quat_rotate(qd, sx) + xx[4:] + delta[3:]
            return (jnp.sum(pw * n_hat, axis=-1) + nood)[:, None]

        return [ResidualFamily(edge_fn, v_c.astype(jnp.float32)),
                ResidualFamily(plane_fn, v_s.astype(jnp.float32))]

    return np.asarray(jax.jit(lambda xx: lm_solve(
        make_families, jmap._retract, xx, dim=6, iterations=m.gn_iterations,
        huber_delta=m.huber_delta))(_jax_x(x)))


def test_mo_lm_on_fixed_terms_matches_profile_mapping(map_frame):
    st, (c_xyz, c_m, s_xyz, s_m), x = map_frame
    m = CFG.mapping
    pc = so3.quat_rotate(x[:4], c_xyz) + x[4:]
    ps_ = so3.quat_rotate(x[:4], s_xyz) + x[4:]
    cand_c, cand_s = grid_gather_pair(st.cube.corner, pc, m.corner_cell,
                                      st.cube.surf, ps_, m.surf_cell)
    corner = _corner_terms(c_xyz, c_m, cand_c, x, m)
    surf = _surf_terms(s_xyz, s_m, cand_s, x, m)
    assert int(corner[3].sum()) > 10 and int(surf[2].sum()) > 10
    got = ps.mo_lm_on_fixed_terms(c_xyz, s_xyz, corner, surf, x, m)
    np.testing.assert_allclose(
        got.numpy(), _jax_mo_lm(c_xyz, s_xyz, corner, surf, x, m),
        atol=1e-4)


def test_batch_round_matches_profile_batch_flat(map_frame):
    """pb.batch_terms_lm_round at B = 2 (two poses over one map's frame)
    against profile_batch_flat.py's `lm` on the same terms."""
    st, stacks, x = map_frame
    m = CFG.mapping
    B = 2
    gm = tbm.BatchGridMap(*(tbm.BatchFeatureGrid(
        torch.cat([g.pts, g.pts]), torch.stack([g.n_live, g.n_live]))
        for g in (st.cube.corner, st.cube.surf)),
        torch.stack([st.cube.center] * B))
    c_xyz, c_m, s_xyz, s_m = (torch.stack([t, t]) for t in stacks)
    xB = torch.stack([x, x + torch.tensor([0, 0, 0, 0, 0.05, -0.03, 0.0])])
    cand_c, cand_s = tbm.batch_grid_gather_pair(
        gm.corner, tbm._world(xB, c_xyz), m.corner_cell, gm.surf,
        tbm._world(xB, s_xyz), m.surf_cell, B)
    got = pb.batch_terms_lm_round((c_xyz, c_m, s_xyz, s_m), cand_c, cand_s,
                                  xB, m)
    a, b, de, v_c = tbm._batch_corner_terms(c_xyz, c_m, cand_c, xB, m)
    nh, nd, v_s = tbm._batch_surf_terms(s_xyz, s_m, cand_s, xB, m)
    assert int(v_c.sum()) > 10 and int(v_s.sum()) > 10
    Qc, Qs = c_xyz.shape[1], s_xyz.shape[1]
    a, b, de, nh, nd = (_np(t) for t in (a, b, de, nh, nd))
    is_edge = (jnp.arange(Qc + Qs) < Qc)[:, None]
    cp = jnp.concatenate([_np(c_xyz), _np(s_xyz)], axis=1)
    A_ = jnp.concatenate([a, jnp.zeros_like(nh)], axis=1)
    Bp = jnp.concatenate([b, jnp.zeros_like(nh)], axis=1)
    DE = jnp.concatenate([de, jnp.ones((B, Qs), de.dtype)], axis=1)
    NH = jnp.concatenate([jnp.zeros_like(a), nh], axis=1)
    NOOD = jnp.concatenate([jnp.zeros((B, Qc), nd.dtype), nd], axis=1)
    w = jnp.concatenate([_np(v_c), _np(v_s)], axis=1).astype(jnp.float32)
    want = jax.jit(partial(jbm._lm_solve_batched, iterations=m.gn_iterations,
                           huber_delta=m.huber_delta))(
        _jax_x(xB), cp, A_, Bp, DE, NH, NOOD, is_edge, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
