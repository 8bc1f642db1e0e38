"""The lockstep batch engine (BatchLoamEngine) split into its stages at B = 4
beside a single stream, each with its host enqueue, its wall, the device
time of its kernels replayed from a CUDA graph and its launches: the port of
the JAX package's stage profilers of the batch frame.

    python -m vloam_tpu_torch.tools.profile_batch_stages [--device cpu]
        [--tiny] [--runs N] [--replays N] [--chunk F]

Sections, each headed by the scripts it ports:
  scripts/profile_batch_stages.py: B = 1 against B = 4 for registration,
    LO, the voxel stacks, the mapping solve and the whole polar frame, each
    frame as its stages beside the whole frame with their launches summed
    against it. Where the reference vmaps registration, LO and the voxel
    filters over the streams, the port runs them stream by stream
    (lidar/loam_step.py's batch_frame_step_feats): B times the launches.
    The mapping stage is flat-batched: one probe, one insert a grid.
  scripts/profile_batch_mapping.py, profile_batch_flat.py: the
    flat-batched mapping's sub-stages at B = 4 beside a single stream's:
    the probe, the terms of one round, terms + LM of one round, the inserts
    (_merged_row_insert, which copies its table, alone too) and the evict.
  scripts/profile_batch.py: a chunk of F lockstep frames at B = 1, 2, 4 and
    8 on range images already on the card (B = 1: the single engine's
    chunk), after a warm chunk; beside it the push_polar path (host staging
    and upload included) over the same frames.

Every stream drives the same frames (the scripts broadcast one drive over
the streams). Runs on the card unless --device cpu, where only the host
clocks are taken.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..geometry import so3
from ..lidar import batch_mapping as bm
from ..lidar.gridmap import grid_evict, grid_gather_pair, grid_insert
from ..lidar.loam_step import (BatchLoamEngine, BatchLoamState, LoamEngine,
                               LoamState, _batch_chunk_epilogue, _select_tree,
                               _stack_tree, _stream_of, batch_frame_step_feats,
                               engine_device, loam_frame_step_feats,
                               loam_run_chunk_batch_polar,
                               loam_run_chunk_polar)
from ..lidar.mapping import (_corner_terms, _surf_terms, map_update,
                             mo_families, solve_mapping, window_half_extent)
from ..lidar.mapping import _retract as mo_retract
from ..lidar.odometry import solve_lo
from ..lidar.scan_registration import polar_directions, register_scan_polar
from ..solver.lm import lm_solve
from . import profile_stages as single
from .stages import StageTable, drive_frames, emit, parse, profile, workers

SCRIPTS = ("scripts/profile_batch_stages.py",
           "scripts/profile_batch_mapping.py", "scripts/profile_batch_flat.py",
           "scripts/profile_batch.py")
BATCH = 4  # the scripts' B
SWEEP = (1, 2, 4, 8)  # profile_batch.py's B


def hand(batch: int) -> dict:
    """The hand-written kernels' launches of a lockstep frame by stage."""
    return {"scanreg": {"select_rings": batch},
            "lo": {"ring_min1_packed": 4 * batch}, "voxel": {}, "pose": {},
            "mapping": {"grid_probe": 1, "row_gather": 2}, "tail": {}}


def frame_hand(batch: int) -> dict:
    return {k: v for stage in hand(batch).values() for k, v in stage.items()}


# ---- the lockstep frame by stages: batch_frame_step_feats cut at its
# stage ends (registration as loam_run_chunk_batch_polar's loop body) ----

def register_stage(r_b, dirs, cfg, batch: int, scale: float = 0.005):
    """Stream by stream registration, stacked to [B, ...] features."""
    return _stack_tree([register_scan_polar(r_b[b], dirs, cfg.lidar,
                                            cfg.scanreg, scale)
                        for b in range(batch)])


def lo_stage(state: BatchLoamState, feats, cfg, batch: int):
    """solve_lo stream by stream, stacked: (q_s, t_s, n_c, n_s) [B, ...]."""
    lo = [solve_lo(f.sharp, f.flat, _stream_of(state.corner_last, b),
                   _stream_of(state.surf_last, b), state.q_f2f[b],
                   state.t_f2f[b], cfg.lo)
          for b, f in ((b, _stream_of(feats, b)) for b in range(batch))]
    return tuple(torch.stack(x) for x in zip(*lo))


def voxel_stage(feats, cfg, batch: int):
    """Both mapping stacks stream by stream, stacked: (c_xyz, c_m, s_xyz,
    s_m) [B, ...]."""
    m = cfg.mapping
    stacks = []
    for b in range(batch):
        f = _stream_of(feats, b)
        stacks.append((*single.voxel_stage(f.less_sharp, m.line_resolution,
                                           m.corner_stack_cap),
                       *single.voxel_stage(f.less_flat, m.plane_resolution,
                                           m.surf_stack_cap)))
    c_xyz, c_m, s_xyz, s_m = (torch.stack(x) for x in zip(*stacks))
    return c_xyz, c_m, s_xyz, s_m


def pose_stage(state: BatchLoamState, lo):
    """The frame-0 selects, the LO world poses and the map predictions:
    (q, t, n_c, n_s, q_w, t_w, q_pred, t_pred)."""
    dev = state.q_w.device
    q_s, t_s, n_c, n_s = lo
    initialized = state.frame_idx > 0
    q = torch.where(initialized, q_s, so3.identity_quat(dev))
    t = torch.where(initialized, t_s, 0.0)
    n_c = torch.where(initialized, n_c, 0)
    n_s = torch.where(initialized, n_s, 0)
    q_w = torch.where(initialized,
                      so3.quat_normalize(so3.quat_multiply(state.q_w, q)),
                      state.q_w)
    t_w = torch.where(initialized, state.t_w + so3.quat_rotate(state.q_w, t),
                      state.t_w)
    q_pred = so3.quat_normalize(so3.quat_multiply(state.q_wmap_wodom, q_w))
    t_pred = state.t_wmap_wodom + so3.quat_rotate(state.q_wmap_wodom, t_w)
    return q, t, n_c, n_s, q_w, t_w, q_pred, t_pred


def mapping_stage(state: BatchLoamState, pose, stacks, cfg, batch: int):
    """batch_solve_mapping and the skip-frame select: (gm, q_m, t_m,
    mapped)."""
    dev = state.q_w.device
    q_pred, t_pred = pose[6], pose[7]
    gm, q_m, t_m = bm.batch_solve_mapping(state.gm, *stacks, q_pred, t_pred,
                                          cfg.mapping, batch)
    if cfg.lo.mapping_skip_frame == 1:
        mapped = torch.ones((), dtype=torch.bool, device=dev)
    else:
        mapped = (state.frame_idx % cfg.lo.mapping_skip_frame) == 0
        gm = _select_tree(mapped, gm, state.gm)
        q_m = torch.where(mapped, q_m, q_pred)
        t_m = torch.where(mapped, t_m, t_pred)
    return gm, q_m, t_m, mapped


def tail_stage(state: BatchLoamState, feats, pose, mapping, batch: int):
    """The map offsets, the new state and the [B, 24] rows."""
    q, t, n_c, n_s, q_w, t_w = pose[:6]
    gm, q_m, t_m, mapped = mapping
    q_off = so3.quat_normalize(
        so3.quat_multiply(q_m, so3.quat_conjugate(q_w)))
    t_off = t_m - so3.quat_rotate(q_off, t_w)
    new_state = BatchLoamState(
        corner_last=feats.less_sharp_slab, surf_last=feats.less_flat_slab,
        q_f2f=q, t_f2f=t, q_w=q_w, t_w=t_w, gm=gm,
        q_wmap_wodom=torch.where(mapped, q_off, state.q_wmap_wodom),
        t_wmap_wodom=torch.where(mapped, t_off, state.t_wmap_wodom),
        frame_idx=state.frame_idx + 1)
    counts = torch.stack([n_c, n_s, mapped.to(n_c.dtype).expand(batch)],
                         dim=1).to(torch.float32)
    return new_state, torch.cat([q, t, q_w, t_w, q_m, t_m, counts],
                                dim=1).to(torch.float32)


def frame_by_stages(state: BatchLoamState, feats, cfg, batch: int):
    """batch_frame_step_feats as its stages, in order: (new_state, out)."""
    lo = lo_stage(state, feats, cfg, batch)
    stacks = voxel_stage(feats, cfg, batch)
    pose = pose_stage(state, lo)
    return tail_stage(state, feats, pose,
                      mapping_stage(state, pose, stacks, cfg, batch), batch)


def batch_terms_lm_round(stacks, cand_c, cand_s, x, cfg):
    """One flat-batched mapping round at poses x [B, 7] on pre-gathered
    candidates: the terms of every stream and one LM (cfg.gn_iterations
    iterations) with a stream axis (batch_solve_mapping's round). cfg: the
    mapping config."""
    c_xyz, c_m, s_xyz, s_m = stacks
    a, b, de, v_c = bm._batch_corner_terms(c_xyz, c_m, cand_c, x, cfg)
    n_hat, nood, v_s = bm._batch_surf_terms(s_xyz, s_m, cand_s, x, cfg)
    Qc, Qs = c_xyz.shape[1], s_xyz.shape[1]
    is_edge = (torch.arange(Qc + Qs, device=x.device) < Qc)[:, None]
    cp = torch.cat([c_xyz, s_xyz], dim=1)
    A = torch.cat([a, torch.zeros_like(n_hat)], dim=1)
    Bp = torch.cat([b, torch.zeros_like(n_hat)], dim=1)
    DE = torch.cat([de, torch.ones_like(nood)], dim=1)
    NH = torch.cat([torch.zeros_like(a), n_hat], dim=1)
    NOOD = torch.cat([torch.zeros_like(de), nood], dim=1)
    w = torch.cat([v_c, v_s], dim=1).to(torch.float32)
    return lm_solve(mo_families(cp, is_edge, A, Bp, DE, NH, NOOD, w),
                    mo_retract, x, iterations=cfg.gn_iterations,
                    huber_delta=cfg.huber_delta)


# ---- the sections ----

def _frames_section(table, cfg, dev, r, dirs):
    """B = 1 and B = 4: frame 2 by stages on the state of frames 0-1."""
    pq, pt, up = single._priors(dev)
    m = cfg.mapping
    st1 = LoamState.create(cfg, dev)
    stB = BatchLoamState.create(cfg, BATCH, dev)
    for k in range(2):
        st1 = loam_frame_step_feats(st1, register_scan_polar(
            r[k], dirs, cfg.lidar, cfg.scanreg), pq, pt, up, cfg)[0]
        stB = batch_frame_step_feats(stB, register_stage(
            r[k].expand(BATCH, *r[k].shape), dirs, cfg, BATCH), cfg,
            BATCH)[0]
    r2, rB = r[2], r[2].expand(BATCH, *r[2].shape)
    table.section(("scripts/profile_batch_stages.py",),
                  f"B = 1 against B = {BATCH}: frame 2 by stages on the "
                  "state of frames 0-1, beside the whole frame")
    # B = 1: the single engine's frame
    f1 = table.stage("B=1 register_scan_polar [K1]", lambda: (
        register_scan_polar(r2, dirs, cfg.lidar, cfg.scanreg)),
        jax="scanreg_polar B=1", expect={"select_rings": 1}, key="1:scanreg")
    lo1 = table.stage("B=1 solve_lo + LO world pose [ring_min1_packed x4]",
                      lambda: single.lo_stage(st1, f1, pq, pt, up, cfg),
                      jax="solve_lo B=1", expect={"ring_min1_packed": 4},
                      key="1:lo")
    c1 = table.stage("B=1 voxel corner stack", lambda: single.voxel_stage(
        f1.less_sharp, m.line_resolution, m.corner_stack_cap),
        jax="voxel stacks B=1", expect={}, key="1:voxel_corner")
    s1 = table.stage("B=1 voxel surf stack", lambda: single.voxel_stage(
        f1.less_flat, m.plane_resolution, m.surf_stack_cap),
        jax="voxel stacks B=1", expect={}, key="1:voxel_surf")
    mp1 = table.stage("B=1 solve_mapping [grid_probe, row_gather x2]",
                      lambda: single.mapping_stage(st1, lo1, (*c1, *s1), cfg),
                      jax="solve_mapping B=1",
                      expect={"grid_probe": 1, "row_gather": 2},
                      key="1:mapping")
    table.stage("B=1 frame tail", lambda: single.tail_stage(st1, f1, lo1,
                                                            mp1),
                expect={}, key="1:tail")
    table.stage("B=1 whole polar frame", lambda: loam_frame_step_feats(
        st1, register_scan_polar(r2, dirs, cfg.lidar, cfg.scanreg), pq, pt,
        up, cfg), jax="full polar frame B=1 (the single engine)",
        expect=single.FRAME_HAND, key="1:frame")
    table.sum_check("single-stream polar frame",
                    ["1:" + k for k in single.TOP], "1:frame")

    B = BATCH
    hB = hand(B)

    def stage(key, label, fn, jax=""):
        return table.stage(f"B={B} {label}", fn, jax=jax, expect=hB[key],
                           key=f"{B}:{key}")

    fB = stage("scanreg", f"register_scan_polar x {B}, stacked [K1 x {B}]",
               lambda: register_stage(rB, dirs, cfg, B),
               jax=f"scanreg_polar B={B}")
    loB = stage("lo", f"solve_lo x {B}, stacked [ring_min1_packed x {4 * B}]",
                lambda: lo_stage(stB, fB, cfg, B), jax=f"solve_lo B={B}")
    vB = stage("voxel", f"voxel stacks x {B}, stacked",
               lambda: voxel_stage(fB, cfg, B), jax=f"voxel stacks B={B}")
    pB = stage("pose", "LO selects, world poses, map predictions",
               lambda: pose_stage(stB, loB))
    mB = stage("mapping", "batch_solve_mapping, flat [grid_probe, "
               "row_gather x2]", lambda: mapping_stage(stB, pB, vB, cfg, B),
               jax=f"solve_mapping B={B} / flat batch_solve_mapping")
    stage("tail", "frame tail", lambda: tail_stage(stB, fB, pB, mB, B))
    table.stage(f"B={B} whole lockstep frame", lambda: batch_frame_step_feats(
        stB, register_stage(rB, dirs, cfg, B), cfg, B),
        jax=f"full polar frame B={B} / full batched frame B={B}",
        expect=frame_hand(B), key=f"{B}:frame")
    table.sum_check(f"BatchLoamEngine lockstep frame (B={B})",
                    [f"{B}:{k}" for k in hand(B)], f"{B}:frame")
    table.stage(f"B={B} chunk epilogue: batch_map_evict",
                lambda: _batch_chunk_epilogue(stB, cfg, B),
                jax=f"flat batch_map_evict B={B}", expect={})
    return (st1, (*c1, *s1), lo1), (stB, vB, pB)


def _mapping_section(table, cfg, single_in, batch_in):
    m = cfg.mapping
    B = BATCH
    st1, stacks1, lo1 = single_in
    stB, stacksB, poseB = batch_in
    q_pred = so3.quat_normalize(so3.quat_multiply(st1.q_wmap_wodom, lo1[4]))
    t_pred = st1.t_wmap_wodom + so3.quat_rotate(st1.q_wmap_wodom, lo1[5])
    x1 = torch.cat([q_pred, t_pred])
    xB = torch.cat([poseB[6], poseB[7]], dim=-1)
    c1, cm1, s1, sm1 = stacks1
    cB, cmB, sB, smB = stacksB
    pc1 = so3.quat_rotate(x1[:4], c1) + x1[4:]
    ps1 = so3.quat_rotate(x1[:4], s1) + x1[4:]
    cube, gm = st1.cube, stB.gm
    table.section(("scripts/profile_batch_mapping.py",
                   "scripts/profile_batch_flat.py"),
                  f"the flat-batched mapping's sub-stages at B = {B} beside "
                  "a single stream's (frame 2, at its prediction)")
    table.stage("B=1 probe of both grids [grid_probe]",
                lambda: grid_gather_pair(cube.corner, pc1, m.corner_cell,
                                         cube.surf, ps1, m.surf_cell),
                jax="grid_gather B=1", expect={"grid_probe": 1})
    candB = table.stage(
        f"B={B} probe of both grids, flat [grid_probe]",
        lambda: bm.batch_grid_gather_pair(
            gm.corner, bm._world(xB, cB), m.corner_cell, gm.surf,
            bm._world(xB, sB), m.surf_cell, B),
        jax=f"grid_gather B={B} / flat gather B={B}",
        expect={"grid_probe": 1})
    cand1 = grid_gather_pair(cube.corner, pc1, m.corner_cell, cube.surf, ps1,
                             m.surf_cell)
    table.stage("B=1 corner + surf terms (1 round)", lambda: (
        _corner_terms(c1, cm1, cand1[0], x1, m),
        _surf_terms(s1, sm1, cand1[1], x1, m)),
        jax="corner+surf terms B=1", expect={})
    table.stage(f"B={B} corner + surf terms (1 round), flat", lambda: (
        bm._batch_corner_terms(cB, cmB, candB[0], xB, m),
        bm._batch_surf_terms(sB, smB, candB[1], xB, m)),
        jax=f"corner+surf terms B={B} / flat terms (1 round) B={B}",
        expect={})
    table.stage(f"B=1 terms + LM (1 round, {m.gn_iterations} iterations)",
                lambda: single.mo_lm_on_fixed_terms(
                    c1, s1, _corner_terms(c1, cm1, cand1[0], x1, m),
                    _surf_terms(s1, sm1, cand1[1], x1, m), x1, m),
                jax="solve_mapping-no-carry B=1 (one round of it)",
                expect={})
    table.stage(f"B={B} terms + LM (1 round), flat",
                lambda: batch_terms_lm_round(stacksB, *candB, xB, m),
                jax=f"flat terms+LM (1 round) B={B}", expect={})
    table.stage("B=1 grid_insert corner + surf [row_gather x2]", lambda: (
        grid_insert(cube.corner, pc1, cm1, m.corner_cell, m.line_resolution),
        grid_insert(cube.surf, ps1, sm1, m.surf_cell, m.plane_resolution)),
        jax="grid_insert(corner stack) B=1", expect={"row_gather": 2})
    table.stage(f"B={B} batch_grid_insert corner + surf [row_gather x2]",
                lambda: (bm.batch_grid_insert(
                    gm.corner, bm._world(xB, cB), cmB, m.corner_cell,
                    m.line_resolution, B), bm.batch_grid_insert(
                    gm.surf, bm._world(xB, sB), smB, m.surf_cell,
                    m.plane_resolution, B)),
                jax=f"grid_insert(corner/surf stack) B={B} / flat insert c+s "
                f"B={B}", expect={"row_gather": 2})
    nb = gm.surf.n_buckets(B)
    key = torch.where(smB.reshape(-1), bm._flat_buckets(
        bm._world(xB, sB), m.surf_cell, nb), gm.surf.pts.shape[0])
    pw = bm._world(xB, sB).reshape(-1, 3)
    table.stage(f"B={B} _merged_row_insert, surf (copies its table) "
                "[row_gather]",
                lambda: bm._merged_row_insert(gm.surf.pts, key, pw,
                                              m.plane_resolution),
                shape=f"[{gm.surf.pts.shape[0]}, {gm.surf.pts.shape[1]}]",
                expect={"row_gather": 1})
    radius = window_half_extent(m, x1.device)
    table.stage("B=1 grid_evict corner + surf", lambda: (
        grid_evict(cube.corner, x1[4:], radius),
        grid_evict(cube.surf, x1[4:], radius)),
        jax="grid_evict(corner) B=1", expect={})
    table.stage(f"B={B} batch_map_evict", lambda: bm.batch_map_evict(
        gm, xB[:, 4:], m, B), jax=f"grid_evict(corner) B={B} / flat "
        f"batch_map_evict B={B}", expect={})
    table.stage("B=1 map_update (inserts, evict select) [row_gather x2]",
                lambda: map_update(cube, c1, cm1, s1, sm1, x1[:4], x1[4:], m),
                jax="map_update B=1", expect={"row_gather": 2})
    table.stage("B=1 solve_mapping, no carry [grid_probe, row_gather x2]",
                lambda: solve_mapping(cube, c1, cm1, s1, sm1, q_pred, t_pred,
                                      m), jax="solve_mapping-no-carry B=1",
                expect={"grid_probe": 1, "row_gather": 2})


def _sweep_section(table, cfg, dev, frames, dirs, chunk):
    F = chunk
    table.section(("scripts/profile_batch.py",),
                  f"a chunk of {F} lockstep frames on range images already "
                  f"on the card (after a warm chunk) at B = "
                  f"{', '.join(map(str, SWEEP))}, beside the push_polar "
                  "path over the same frames")
    r = torch.from_numpy(np.stack(frames[:2 * F]).astype(np.int32)).to(dev)
    warm, timed = r[:F], r[F:2 * F]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rates = {}
    for B in SWEEP:
        if B == 1:
            pq = so3.identity_quat(dev).expand(F, 4)
            pt = torch.zeros((F, 3), device=dev)
            up = torch.zeros((F,), dtype=torch.bool, device=dev)
            st = loam_run_chunk_polar(LoamState.create(cfg, dev), warm, dirs,
                                      pq, pt, up, cfg)[0]
            fn = (lambda st=st: loam_run_chunk_polar(st, timed, dirs, pq, pt,
                                                     up, cfg))
            want = {k: v * F for k, v in single.FRAME_HAND.items()}
        else:
            rb = timed.expand(B, *timed.shape)
            st = loam_run_chunk_batch_polar(BatchLoamState.create(
                cfg, B, dev), warm.expand(B, *warm.shape), dirs, cfg)[0]
            fn = (lambda st=st, rb=rb, B=B: loam_run_chunk_batch_polar(
                st, rb, dirs, cfg))
            want = {k: v * F for k, v in frame_hand(B).items()}
        table.stage(f"B={B} chunk of {F}, range images on the card"
                    + (" (single engine)" if B == 1 else ""), fn,
                    jax=f"B={B} device-only", expect=want, key=f"sweep:{B}")
        row = table.rows[-1]
        push_ms = _push_path_ms(cfg, dev, frames[:2 * F], B, F, sync)
        rates[B] = {"chunk_wall_ms": row["wall_ms"],
                    "chunk_device_ms": row["device_ms"],
                    "frames_per_s_wall": B * F / row["wall_ms"] * 1e3,
                    "frames_per_s_device": (B * F / row["device_ms"] * 1e3
                                            if row["device_ms"] else None),
                    "push_polar_chunk_wall_ms": push_ms,
                    "frames_per_s_push_polar": B * F / push_ms * 1e3}
        table.note(f"B={B}: aggregate {rates[B]['frames_per_s_wall']:.2f} "
                   "frames/s (chunk wall)"
                   + (f", {rates[B]['frames_per_s_device']:.2f} (graph "
                      "replay)" if row["device_ms"] else "")
                   + f"; push_polar path {push_ms:.1f} ms a chunk, "
                   f"{rates[B]['frames_per_s_push_polar']:.2f} frames/s")
    table.extra["sweep"] = rates


def _push_path_ms(cfg, dev, frames, B, F, sync) -> float:
    """Wall ms of the push_polar path over a chunk (host staging, upload and
    the chunk), after a warm chunk, every stream pushed the same frames."""
    eng = (LoamEngine(cfg, chunk=F, device=dev) if B == 1
           else BatchLoamEngine(cfg, B, chunk=F, device=dev))

    def push(k):
        if B == 1:
            eng.push_polar(frames[k])
        else:
            for b in range(B):
                eng.push_polar(b, frames[k])

    for k in range(F):
        push(k)
    sync()
    t0 = time.perf_counter()
    for k in range(F, 2 * F):
        push(k)
    sync()
    return (time.perf_counter() - t0) * 1e3


def run(device="cuda", tiny: bool = False, runs: int = 3, replays: int = 20,
        chunk: int = 8, frames=None) -> dict:
    """Every section; returns the JSON record. frames: the drive's first
    max(3, 2 * chunk) range images where the caller has them."""
    from ..data import synthetic

    dev = engine_device(device)
    cfg, n_az = profile(tiny)
    S = cfg.lidar.n_scans
    table = StageTable("profile_batch_stages", dev, runs, replays, tiny)
    frames = frames or drive_frames(max(3, 2 * chunk), S, n_az,
                                    workers(tiny))
    elev = torch.tensor(np.radians(synthetic.hdl64_elevations(S)),
                        dtype=torch.float32, device=dev)
    dirs = polar_directions(elev, n_az)
    r = [torch.from_numpy(f.astype(np.int32)).to(dev) for f in frames[:3]]
    single_in, batch_in = _frames_section(table, cfg, dev, r, dirs)
    _mapping_section(table, cfg, single_in, batch_in)
    _sweep_section(table, cfg, dev, frames, dirs, chunk)
    return table.result()


def main(argv=None) -> int:
    args = parse("vloam_tpu_torch.tools.profile_batch_stages", __doc__,
                 argv)
    emit(run(args.device, args.tiny, args.runs, args.replays, args.chunk))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
