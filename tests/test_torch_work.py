"""vloam_tpu_torch.tools.work, the count of a LoamEngine frame's operations
and bytes, on the CPU over test_torch_loam_engine.py's polar drive (small_cfg,
64 x 900 range images):

- (a) the live counts work.frame_counts reads from the port's frame stages
  equal, exactly, the counts it reads from the JAX package's jitted frame
  step, each frame's stages run from the JAX frame's own inputs; the
  counting pass (work.count_frames) over the drive against the JAX drive:
  the counts of the stages that agree bit for bit equal, the rest within
  1 % (the less-flat centroids and the MO poses round apart);
- (b) each stage's bytes_in / bytes_out equal the summed nbytes of the live
  rows of that stage's actual input and output tensors in a CPU run of the
  frame's stages, a count from tensors, independent of the formulas;
- (c) the LO association's count depends on the queries and the slab alone:
  ring_slab_assoc under each of its four forms (mxu, packed, xla, pallas; the
  plain versions here) on one frame's queries and slabs picks the same
  points for at least 99 % of the queries LO's gate passes, and work's count
  of the call is the same under every form;
- (d) the roofline arithmetic (tools/timing.roofline, tools/bench.roofline)
  on given counts against timing.py's peaks, and no utilisation keys for a
  device that is not an H100;
- the per-kernel bounds of tools/timing.py, which now go through work.py,
  hold their values at PERF.md section 6's shapes.
"""

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.data import synthetic
from vloam_tpu.lidar import loam_step as jls
from vloam_tpu.lidar import scan_registration as jsr
from vloam_tpu.lidar import voxel as jvox
from vloam_tpu_torch import convert
from vloam_tpu_torch.config import kitti_hdl64
from vloam_tpu_torch.geometry import so3
from vloam_tpu_torch.lidar import gridmap
from vloam_tpu_torch.lidar import loam_step as tls
from vloam_tpu_torch.lidar import mapping as tmap
from vloam_tpu_torch.lidar import odometry as todo
from vloam_tpu_torch.lidar import ring_assoc as ra
from vloam_tpu_torch.lidar import scan_registration as tsr
from vloam_tpu_torch.lidar.ring_assoc import RingSlab
from vloam_tpu_torch.lidar.types import FeatureCloud, ScanFeatures
from vloam_tpu_torch.lidar.voxel import voxel_downsample
from vloam_tpu_torch.tools import bench, timing, work

from test_pipeline import small_cfg

torch.set_num_threads(1)

CFG = small_cfg()
N_FRAMES = 3


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def frames():
    """The first frames of test_torch_loam_engine.py's polar_drive."""
    scene = synthetic.urban_scene(21)
    poses = synthetic.drive_trajectory(4, speed=1.0, yaw_rate=0.02)
    return [synthetic.simulate_scan_polar(scene, T, n_scans=64,
                                          n_azimuth=900, seed=k)
            for k, T in enumerate(poses)][:N_FRAMES]


@pytest.fixture(scope="module")
def port_counts(frames):
    return work.count_frames(CFG, frames, "cpu")


@partial(jax.jit, static_argnames=("cfg",))
def _jax_frame(st, img, elev, cfg):
    """The JAX package's frame step as loam_run_chunk_polar's scan body runs
    it (identity priors), with the mapping stacks it makes."""
    feats = jsr.register_scan_polar(img, elev, cfg.lidar, cfg.scanreg)
    new, out = jls.loam_frame_step_feats(
        st, feats, jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32),
        jnp.zeros(3, jnp.float32), jnp.bool_(False), cfg)
    mc = cfg.mapping
    c_xyz, _, _, c_m = jvox.voxel_downsample(
        feats.less_sharp.xyz, feats.less_sharp.mask, mc.line_resolution,
        mc.corner_stack_cap)
    s_xyz, _, _, s_m = jvox.voxel_downsample(
        feats.less_flat.xyz, feats.less_flat.mask, mc.plane_resolution,
        mc.surf_stack_cap)
    return feats, (c_xyz, c_m, s_xyz, s_m), new, out


def _feats_to_torch(f) -> ScanFeatures:
    def cloud(c):
        return FeatureCloud(*(_t(x) for x in c))

    return ScanFeatures(
        *(cloud(getattr(f, n)) for n in ("sharp", "less_sharp", "flat",
                                          "less_flat", "full")),
        less_sharp_slab=RingSlab(_t(f.less_sharp_slab.xyz)),
        less_flat_slab=RingSlab(_t(f.less_flat_slab.xyz)))


def _jax_drive(frames):
    """Per frame of the JAX package's drive: (state before as numpy, feats,
    stacks, state after as numpy, out)."""
    elev = jnp.asarray(np.radians(synthetic.hdl64_elevations(64)),
                       jnp.float32)
    st = jls.LoamState.create(CFG)
    steps = []
    for img in frames:
        before = jax.tree.map(np.asarray, st)
        feats, stacks, st, out = _jax_frame(st, jnp.asarray(img), elev,
                                            cfg=CFG)
        steps.append((before, feats, stacks, jax.tree.map(np.asarray, st),
                      out))
    return steps


@pytest.fixture(scope="module")
def jax_drive(frames):
    return _jax_drive(frames)


def _jax_counts(img, step):
    before, feats, stacks, after, out = step
    return work.frame_counts(
        CFG, img, convert.loam_state_from_numpy(before, "cpu"),
        _feats_to_torch(feats), tuple(_t(x) for x in stacks), _t(out),
        convert.loam_state_from_numpy(after, "cpu"))


# the counts of the stages that agree bit for bit across the packages on
# their own runs: the range image, the layout, the feature classes and the
# slabs LO reads
_SCANREG = ("n_rings", "n_azimuth", "pixel_bytes", "valid", "selectable",
            "sharp", "less_sharp", "flat", "less_flat", "corner_last",
            "surf_last")


def test_live_counts_equal_the_jax_frame_steps(frames, port_counts,
                                               jax_drive):
    """Each frame's stages from the JAX frame's own inputs: its state
    before, its features and, for the map update, its MO pose. Every count
    the port's stages give equals the JAX frame's, exactly."""
    mc = CFG.mapping
    for k, (img, step) in enumerate(zip(frames, jax_drive)):
        before_np, feats, _, _, out_j = step
        want = _jax_counts(img, step)
        before = convert.loam_state_from_numpy(before_np, "cpu")
        ft = _feats_to_torch(feats)
        _, out = tls.loam_frame_step_feats(
            before, ft, so3.identity_quat("cpu"), torch.zeros(3),
            torch.tensor(False), CFG)
        c_xyz, _, _, c_m = voxel_downsample(
            ft.less_sharp.xyz, ft.less_sharp.mask, mc.line_resolution,
            mc.corner_stack_cap)
        s_xyz, _, _, s_m = voxel_downsample(
            ft.less_flat.xyz, ft.less_flat.mask, mc.plane_resolution,
            mc.surf_stack_cap)
        # LO and the probe from the port's own poses; the map update at the
        # JAX frame's MO pose (the port's lies ~2 mm away, which moves a few
        # inserted points across a bucket's cell)
        out = torch.cat([out[:14], _t(out_j)[14:21], out[21:]])
        q_m, t_m = out[14:18], out[18:21]
        after = before._replace(cube=tmap.map_update(
            before.cube, c_xyz, c_m, s_xyz, s_m, q_m, t_m, mc))
        got = work.frame_counts(CFG, img, before, ft, (c_xyz, c_m, s_xyz,
                                                       s_m), out, after)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), k
    last = port_counts[-1]
    # the counts are live ones, well inside the capacities
    assert 0 < last.lo_corner <= last.sharp < CFG.scanreg.sharp_cap
    assert 0 < last.corner_last < CFG.scanreg.less_sharp_cap
    assert 0 < last.fit_s <= last.surf_stack < CFG.mapping.surf_stack_cap
    assert 0 < last.cand_c and 0 < last.written_rows_s
    assert port_counts[0].corner_last == port_counts[0].cand_c == 0


def test_counting_pass_against_the_jax_drive(frames, port_counts,
                                             jax_drive):
    """The counting pass over the drive against the JAX package's drive,
    each on its own: the counts of the stages that agree bit for bit are
    equal; the rest within 1 %: the less-flat centroids round differently
    in the last bits (up to 6.1e-5 m on these frames), which moves a point
    of a mapping stack into another voxel, and the MO poses lie ~2 mm
    apart."""
    for k, (img, step) in enumerate(zip(frames, jax_drive)):
        got = dataclasses.asdict(port_counts[k])
        want = dataclasses.asdict(_jax_counts(img, step))
        assert {n: got[n] for n in _SCANREG} == {n: want[n]
                                                 for n in _SCANREG}, k
        for n in got:
            assert abs(got[n] - want[n]) <= 0.01 * want[n], (k, n, got[n],
                                                              want[n])


def _live_nbytes(*pairs) -> int:
    """Summed nbytes of the rows of each tensor where its mask is set."""
    return sum(int(t[m].nbytes) for t, m in pairs)


def _cloud_nbytes(c: FeatureCloud) -> int:
    return _live_nbytes(*((x, c.mask) for x in c))


def _slab_nbytes(slab: RingSlab) -> int:
    return _live_nbytes((slab.xyz, slab.xyz[..., 0] < ra.SENTINEL / 2))


def _rows_nbytes(pts: torch.Tensor, rows: torch.Tensor) -> int:
    return int(pts[torch.unique(rows)].nbytes)


def test_stage_bytes_equal_the_stage_tensors(frames, port_counts):
    """The last frame's stages run one by one from the state the counting
    pass leaves before it; each stage's bytes against its tensors."""
    state = tls.LoamState.create(CFG, "cpu")
    dirs = tls._polar_dirs(CFG, 900, None, "cpu")
    for img in frames[:-1]:
        state, _ = work.count_frame(CFG, state, img, dirs)
    img = frames[-1]
    work_ = work.frame_work(CFG, port_counts[-1])["stages"]
    r = _t(img.astype(np.int32))
    mc, lc = CFG.mapping, CFG.lo

    pts, rt, counts = tsr.polar_layout(r, dirs, CFG.lidar)
    live = torch.arange(900)[None, :] < counts[:, None]
    valid = r.to(torch.float32) * 0.005 >= CFG.lidar.minimum_range
    layout = _live_nbytes((pts, live), (rt, live)) + counts.nbytes
    assert work_["ingest"]["bytes_in"] == img.nbytes + _live_nbytes(
        (dirs, valid))
    assert work_["ingest"]["bytes_out"] == layout

    feats = tsr.register_scan_polar(r, dirs, CFG.lidar, CFG.scanreg)
    assert work_["scanreg"]["bytes_in"] == layout
    assert work_["scanreg"]["bytes_out"] == sum(
        _cloud_nbytes(c) for c in (feats.sharp, feats.less_sharp, feats.flat,
                                   feats.less_flat)) + sum(
        _slab_nbytes(s) for s in (feats.less_sharp_slab,
                                  feats.less_flat_slab))

    q0, t0 = state.q_f2f, state.t_f2f
    lo_out = todo.solve_lo(feats.sharp, feats.flat, state.corner_last,
                           state.surf_last, q0, t0, lc)
    assert work_["lo"]["bytes_in"] == (
        _live_nbytes((feats.sharp.xyz, feats.sharp.mask),
                     (feats.flat.xyz, feats.flat.mask))
        + _slab_nbytes(state.corner_last) + _slab_nbytes(state.surf_last)
        + q0.nbytes + t0.nbytes)
    assert work_["lo"]["bytes_out"] == sum(x.nbytes for x in lo_out)

    c_xyz, _, _, c_m = voxel_downsample(
        feats.less_sharp.xyz, feats.less_sharp.mask, mc.line_resolution,
        mc.corner_stack_cap)
    s_xyz, _, _, s_m = voxel_downsample(
        feats.less_flat.xyz, feats.less_flat.mask, mc.plane_resolution,
        mc.surf_stack_cap)
    stacks = _live_nbytes((c_xyz, c_m), (c_m, c_m), (s_xyz, s_m), (s_m, s_m))
    assert work_["voxel"]["bytes_in"] == sum(
        _live_nbytes((c.xyz, c.mask), (c.mask, c.mask))
        for c in (feats.less_sharp, feats.less_flat))
    assert work_["voxel"]["bytes_out"] == stacks

    # the mapping stage at the frame step's prediction
    new, out = tls.loam_frame_step_feats(
        state, feats, so3.identity_quat("cpu"), torch.zeros(3),
        torch.tensor(False), CFG)
    q_w, t_w = out[7:11], out[11:14]
    q_pred = so3.quat_normalize(so3.quat_multiply(state.q_wmap_wodom, q_w))
    t_pred = state.t_wmap_wodom + so3.quat_rotate(state.q_wmap_wodom, t_w)
    grids = ((state.cube.corner, new.cube.corner, c_xyz[c_m], mc.corner_cell),
             (state.cube.surf, new.cube.surf, s_xyz[s_m], mc.surf_cell))
    _, q_m, t_m, _ = tmap.solve_mapping(state.cube, c_xyz, c_m, s_xyz, s_m,
                                        q_pred, t_pred, mc)
    assert torch.equal(torch.cat([q_m, t_m]), out[14:21])
    assert work_["mo"]["bytes_in"] == stacks + q_pred.nbytes + t_pred.nbytes \
        + sum(_rows_nbytes(g.pts, gridmap.probe_buckets(
            so3.quat_rotate(q_pred, p) + t_pred, cell, g.pts.shape[0]))
            for g, _, p, cell in grids)
    assert work_["mo"]["bytes_out"] == q_m.nbytes + t_m.nbytes

    assert not bool(torch.any(new.cube.center != state.cube.center))
    assert work_["map_update"]["bytes_in"] == stacks + q_m.nbytes \
        + t_m.nbytes + sum(_rows_nbytes(g.pts, gridmap._bucket_of(
            so3.quat_rotate(q_m, p) + t_m, cell, g.pts.shape[0]))
            for g, _, p, cell in grids)
    assert work_["map_update"]["bytes_out"] == sum(
        int(g1.pts[torch.any(g1.pts != g0.pts, dim=1)].nbytes)
        for g0, g1, _, _ in grids)
    assert work_["output"]["bytes_out"] == out.nbytes


def test_association_count_reads_no_implementation(frames, port_counts):
    """ring_slab_assoc under each form on frame 2's sharp and flat queries
    against frame 1's slabs (each form picks as the reference's same form,
    tests/test_torch_ring_assoc.py): the same count of the call."""
    dirs = tls._polar_dirs(CFG, 900, None, "cpu")
    f1, f2 = (tsr.register_scan_polar(_t(img.astype(np.int32)), dirs,
                                      CFG.lidar, CFG.scanreg)
              for img in frames[1:3])
    counts = {}
    for mode, cloud, slab in (("corner", f2.sharp, f1.less_sharp_slab),
                              ("surf", f2.flat, f1.less_flat_slab)):
        q = cloud.xyz[cloud.mask]
        for impl in ("mxu", "packed", "xla", "pallas"):
            res = ra.ring_slab_assoc(q, slab, CFG.lo.nearby_scan, mode, impl)
            if impl == "mxu":
                want = res
            # the same keys; the picks LO's 25 m^2 gate passes alike for
            # nearly every query (the quantized forms saturate at 64 m^2 and
            # part from the exact ones where two candidates lie within a
            # quantization step)
            assert res.keys() == want.keys()
            gated = (want["d0"] < CFG.lo.distance_sq_threshold) & (
                want["d2"] < CFG.lo.distance_sq_threshold)
            for k in ("p0", "p2"):
                same = torch.all(res[k] == want[k], dim=1)[gated]
                assert same.float().mean() >= 0.99, (mode, impl, k)
            # the call's queries, the slab's live slots, the picks it made
            counts[mode, impl] = work.association(
                q.shape[0], _slab_live(slab), slab.xyz.shape[0], "d3" in res)
        assert len({counts[mode, i] for i in ("mxu", "packed", "xla",
                                               "pallas")}) == 1, counts
    # the frame's LO stage counts these pairs each round
    c = port_counts[2]
    assert (c.sharp, c.corner_last, c.flat, c.surf_last) == (
        f2.sharp.mask.sum(), _slab_live(f1.less_sharp_slab),
        f2.flat.mask.sum(), _slab_live(f1.less_flat_slab))


def _slab_live(slab) -> int:
    return int((slab.xyz[..., 0] < ra.SENTINEL / 2).sum())


def test_roofline_arithmetic():
    ops, ops64, n_bytes, fps = 1.2e9, 3.0e6, 2.5e7, 15.0
    r = timing.roofline(ops, ops64, n_bytes, fps)
    assert r["hbm_util"] == pytest.approx(n_bytes * fps / 3.35e12, rel=1e-12)
    assert r["flop_util"] == pytest.approx(
        (ops / 67e12 + ops64 / 34e12) * fps, rel=1e-12)
    assert r["roofline_bound"] == "operations"
    assert r["bound_ms"] == pytest.approx(r["flop_util"] / fps * 1e3)
    r2 = timing.roofline(1e6, 0, 1e9, fps)
    assert r2["roofline_bound"] == "bytes"
    assert r2["bound_ms"] == pytest.approx(1e9 / 3.35e12 * 1e3)

    work_ = {"ops": ops, "ops_f64": ops64, "bytes": n_bytes}
    line = bench.roofline(work_, fps, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert line == {"flops_per_frame": ops + ops64,
                    "hbm_bytes_per_frame": n_bytes,
                    "device_kind": "NVIDIA H100 80GB HBM3",
                    "power_limit_w": 700.0,
                    "hbm_util": r["hbm_util"], "flop_util": r["flop_util"],
                    "roofline_bound": "operations"}
    # no peaks for other devices: the counts and the device alone
    for dev, kind in (("cpu", "cpu"), ("NVIDIA A100-SXM4-80GB, 400.00 W",
                                       "NVIDIA A100-SXM4-80GB")):
        line = bench.roofline(work_, fps, dev)
        assert line["device_kind"] == kind
        assert not {"hbm_util", "flop_util", "roofline_bound"} & set(line)
    assert "power_limit_w" not in bench.roofline(work_, fps, "cpu")


def test_frame_work_sums_its_stages(port_counts):
    w = work.frame_work(CFG, port_counts[-1])
    assert w["ops"] == sum(s["ops"] for s in w["stages"].values())
    assert w["ops_f64"] == w["stages"]["mo"]["ops_f64"] > 0
    # the frame moves less than its stages' inputs and outputs together:
    # the tensors between stages stay out of its bytes
    assert 0 < w["bytes"] < sum(s["bytes_in"] + s["bytes_out"]
                                for s in w["stages"].values())
    m = work.mean_work([w, work.frame_work(CFG, port_counts[-2])])
    assert m["ops"] == (w["ops"] + work.frame_work(
        CFG, port_counts[-2])["ops"]) / 2


# PERF.md section 6's shapes: each bound as tools/timing.py computed it
# before the bounds went through work.py
_BOUNDS = [
    (timing.row_gather_bound, (24576, 48, 10000), 0.002040358208955224,
     "bytes"),
    (timing.row_gather_bound, (6144, 48, 3000), 0.0005387462686567164,
     "bytes"),
    (timing.row_gather_bound, (2048, 96, 1500), 0.0004115868656716418,
     "bytes"),
    (timing.row_gather_bound, (4096, 48, 4096), 0.0004792931343283582,
     "bytes"),
    (timing.row_gather_bound, (4096, 96, 4096), 0.0009488047761194029,
     "bytes"),
    (timing.grid_probe_bound, ([(8192, 32, 5000), (24576, 16, 12000)],),
     0.020158739104477612, "bytes"),
    (timing.grid_probe_bound, ([(2048, 32, 1800), (6144, 16, 4000)],),
     0.005160042985074627, "bytes"),
    (timing.ring_reduce_bound, (1536, 64, 512, 4), 0.007512186268656716,
     "operations"),
    (timing.ring_reduce_bound, (768, 64, 128, 4), 0.0009390232835820895,
     "operations"),
    (timing.ring_reduce_bound, (768, 64, 128, 2), 0.0008451209552238807,
     "operations"),
    (timing.ring_reduce_bound, (1536, 64, 512, 2), 0.006760967641791045,
     "operations"),
    (timing.ring_reduce_bound, (2048, 64, 512, 4), 0.010016248358208954,
     "operations"),
    (timing.zncc_bound, (2048, 24, 375, 1242), 0.0019695450746268655,
     "bytes"),
    (timing.zncc_bound, (2048, 16, 375, 1242), 0.001187025671641791,
     "bytes"),
    (timing.knn_bound, (2048, 131072, 5), 0.02403899605970149, "operations"),
    (timing.knn_bound, (6144, 65536, 5), 0.03605849408955224, "operations"),
    # M1's live slots: 16,887 corner and 19,917 surf (PERF.md section 6)
    (timing.knn_bound, (2048, 131072, 5, 16887), 0.0030971262089552237,
     "operations"),
    (timing.knn_bound, (6144, 65536, 5, 19917), 0.01095851176119403,
     "operations"),
    (timing.select_rings_bound, (64 * 1800, 64, kitti_hdl64().scanreg),
     0.0004127331343283582, "bytes"),
]


@pytest.mark.parametrize("fn,args,ms,by", _BOUNDS)
def test_kernel_bounds_keep_their_values(fn, args, ms, by):
    got_ms, got_by = fn(*args)
    assert got_by == by
    assert math.isclose(got_ms, ms, rel_tol=1e-12), (got_ms, ms)


@pytest.mark.parametrize("Q,C,live,every,over_live", [
    (2048, 131072, 16887, 0.07927709580655036, 0.010213869605142334),
    (6144, 65536, 19917, 0.11891564370982552, 0.036139570247933885)])
def test_knn_issue_floor_over_live_pairs(Q, C, live, every, over_live):
    """masked_knn's issue floor at M1's windows and 9.88 instructions a
    pair, over every slot and over the live pairs: Q x slots x 9.88 over
    132 x 4 x 32 lanes at 1.98 GHz, in ms."""
    assert math.isclose(timing.knn_issue_floor(Q, C, 9.88), every,
                        rel_tol=1e-12)
    assert math.isclose(timing.knn_issue_floor(Q, C, 9.88, live=live),
                        over_live, rel_tol=1e-12)


def _scan_cost(n: int) -> dict:
    """XLA's compiled cost analysis of an n-step scan of a 64 x 64
    float32 matmul."""
    def g(x, w):
        return jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=n)[0]

    ca = jax.jit(g).lower(jnp.ones((64, 64)), jnp.ones((64, 64))).compile()
    ca = ca.cost_analysis()
    return ca[0] if isinstance(ca, list) else ca


def test_xla_counts_a_loop_body_once():
    """Why bench.py's _roofline does not compare with work.py (PERF.md
    section 2): XLA's cost analysis counts a scan's body once, so its
    flops over a 16-frame chunk, which _roofline divides by 16, are about
    one step's, not sixteen."""
    one, sixteen = _scan_cost(1)["flops"], _scan_cost(16)["flops"]
    assert one == 2 * 64 ** 3
    assert sixteen < 1.01 * one
