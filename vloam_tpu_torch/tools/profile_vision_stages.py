"""A VloamEngine frame (camera + LiDAR, detach_VO_LO=False) split into its
stages, each with its host enqueue, its wall, the device time of its kernels
replayed from a CUDA graph and its launches: the port of the JAX package's
stage profilers of the combined frame.

    python -m vloam_tpu_torch.tools.profile_vision_stages [--device cpu]
        [--tiny] [--runs N] [--replays N] [--chunk F]

Sections, each headed by the script it ports:
  scripts/profile_vision_stages.py: detect_keypoints, describe_keypoints
    (K3), match_descriptors, build_depth_grid, query_depth and solve_vo on
    the script's frame (drive_trajectory(2)[1], its xyz scan and image).
  scripts/profile_vision_chunk.py: the combined polar frame as its stages
    (loop 1: the depth grid's points, registration with K1, the VO seed and
    the image, detection, K3, the depth grid, matching, the VO solve and its
    selects, LO with 4 ring_min1_packed, the voxel stacks, loop 1's tail;
    loop 2: mapping_run_chunk of the frame with grid_probe and 2 row_gather)
    on the state two frames leave, beside the whole frame, their launches
    summed against it; then vision_lo_run_chunk_polar and mapping_run_chunk
    over a chunk of F frames.

The stage split follows the default VO path (kitti_hdl64's options); it
refuses a config with CLAHE, bucket NMS, LK flow, the low-texture fallback
or reset_VO_to_identity on. Runs on the card unless --device cpu, where only
the host clocks are taken.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import so3
from ..lidar.loam_step import engine_device
from ..lidar.odometry import solve_lo
from ..lidar.scan_registration import register_scan_polar
from ..lidar.voxel import reciprocal_f32
from ..vision import features
from ..vision.depth_map import build_depth_grid, query_depth
from ..vision.vo import solve_vo
from ..vloam_step import (CamExtrinsics, MapState, PolarGeometry,
                          VisionLoState, VisionState, _conjugate, _invert,
                          _seed_from_lo_f2f, _vision_lo_frame,
                          mapping_run_chunk, vision_lo_run_chunk_polar)
from .bench import _Calib
from .profile_stages import voxel_stage
from .stages import (StageTable, camera_images, drive_frames, emit, n_points,
                     parse, profile, workers, xyz_frames)

SCRIPTS = ("scripts/profile_vision_stages.py",
           "scripts/profile_vision_chunk.py")
HAND = {"fov": {}, "scanreg": {"select_rings": 1}, "seed": {},
        "detect": {}, "describe": {"zncc_describe": 1}, "depth_grid": {},
        "match": {}, "vo": {}, "lo": {"ring_min1_packed": 4},
        "voxel_corner": {}, "voxel_surf": {}, "tail1": {},
        "mapping": {"grid_probe": 1, "row_gather": 2}}
FRAME_HAND = {"select_rings": 1, "ring_min1_packed": 4, "zncc_describe": 1,
              "grid_probe": 1, "row_gather": 2}
TOP = tuple(HAND)
_OPTIONS = ("clahe", "keypoint_nms", "optical_flow_match", "lowtex_fallback",
            "reset_VO_to_identity")


def check_default_path(vo) -> None:
    on = [k for k in _OPTIONS if getattr(vo, k)]
    if on:
        raise ValueError(f"the stage split follows the default VO path; "
                         f"{on} set")


# ---- the combined frame by stages: vision_lo_run_chunk_polar's loop body
# (_vision_lo_frame, _vision_frame_core) and mapping_run_chunk of one frame

def fov_points(r_img, geom: PolarGeometry, scale: float):
    """The depth grid's points: the forward columns decoded."""
    r = geom.fov_columns(r_img).to(torch.float32) * scale
    return (geom.fov_dirs * r[..., None]).reshape(-1, 3)


def seed_stage(st: VisionLoState, image_u8, ext):
    """Whether the state has a frame, the VO seed from the last LO f2f and
    the image as float: (initialized, a_seed, t_seed, img)."""
    initialized = st.frame_idx > 0
    a_seed, t_seed = _seed_from_lo_f2f(st.q_f2f, st.t_f2f, ext)
    return (initialized, a_seed, t_seed,
            image_u8.to(torch.float32) * reciprocal_f32(255.0))


def depth_grid_stage(grid_scan, n_rays: int, ext, vo):
    in_mask = torch.arange(grid_scan.shape[0],
                           device=grid_scan.device) < n_rays
    return build_depth_grid(grid_scan, in_mask, ext.P_velo_to_img, vo)


def match_stage(vstate: VisionState, desc, kp_mask, xy, vo):
    """Matches of the last frame's keypoints: (curr_uv, valid)."""
    idx1, valid = features.match_descriptors(
        vstate.prev_desc, vstate.prev_kp_mask, desc, kp_mask, vo.match_ratio,
        matcher=vo.matcher, select=vo.match_select)
    return torch.index_select(xy, 0, idx1), valid


def vo_stage(st: VisionLoState, curr_uv, valid, seed, ext, cfg):
    """solve_vo, its selects and the LO prior from seed = seed_stage(...)[:3]:
    (q_prior, t_prior, vo_ok, vo_out [9])."""
    vo = cfg.vo
    dev = curr_uv.device
    initialized, a_seed, t_seed = seed
    valid = valid & initialized
    angles, t_vo, n32, n22 = solve_vo(st.vision.prev_kp, curr_uv, valid,
                                      st.vision.prev_grid, ext.Kinv, a_seed,
                                      t_seed, vo)
    q_vo = so3.quat_from_axis_angle(angles)
    vo_ok = (initialized & torch.all(torch.isfinite(angles))
             & torch.all(torch.isfinite(t_vo))
             & (n32 + n22 >= vo.min_vo_matches))
    q_vo = torch.where(vo_ok, q_vo, so3.identity_quat(dev))
    t_vo = torch.where(vo_ok, t_vo, 0.0)
    q_vo_i, t_vo_i = _invert(q_vo, t_vo)
    qv_i, tv_i = _invert(ext.q_velo_cam, ext.t_velo_cam)
    q_pr, t_pr = _conjugate(qv_i, tv_i, q_vo_i, t_vo_i)
    vo_out = torch.cat([q_vo, t_vo, torch.stack([n32, n22]).to(torch.float32)])
    return q_pr, t_pr, vo_ok, vo_out


def lo_stage(st: VisionLoState, feats, initialized, vo_res, cfg):
    """LO seeded from the frame's VO: (q_f2f, t_f2f, n_corner, n_surf, q_w,
    t_w)."""
    q_pr, t_pr, vo_ok, _ = vo_res
    dev = st.q_w.device
    use_prior = vo_ok & (not cfg.detach_VO_LO)
    q0 = torch.where(use_prior, q_pr, st.q_f2f)
    t0 = torch.where(use_prior, t_pr, st.t_f2f)
    q_s, t_s, n_c, n_s = solve_lo(feats.sharp, feats.flat, st.corner_last,
                                  st.surf_last, q0, t0, cfg.lo)
    q = torch.where(initialized, q_s, so3.identity_quat(dev))
    t = torch.where(initialized, t_s, 0.0)
    n_c = torch.where(initialized, n_c, 0)
    n_s = torch.where(initialized, n_s, 0)
    q_w = torch.where(initialized,
                      so3.quat_normalize(so3.quat_multiply(st.q_w, q)),
                      st.q_w)
    t_w = torch.where(initialized, st.t_w + so3.quat_rotate(st.q_w, t),
                      st.t_w)
    return q, t, n_c, n_s, q_w, t_w


def tail1_stage(st: VisionLoState, vision: VisionState, feats, lo, vo_out):
    """Loop 1's new state and its 25-float row."""
    q, t, n_c, n_s, q_w, t_w = lo
    new_st = VisionLoState(
        vision=vision, corner_last=feats.less_sharp_slab,
        surf_last=feats.less_flat_slab, q_f2f=q, t_f2f=t, q_w=q_w, t_w=t_w,
        frame_idx=st.frame_idx + 1)
    counts = torch.stack([n_c, n_s]).to(torch.float32)
    return new_st, torch.cat([q, t, q_w, t_w, counts, vo_out]).to(
        torch.float32)


def mapping_stage(mst: MapState, stacks, q_w, t_w, cfg):
    """Loop 2 over the one frame: mapping_run_chunk on [1, ...] views."""
    return mapping_run_chunk(mst, *(x[None] for x in stacks), q_w[None],
                             t_w[None], cfg)


def frame_by_stages(st, mst, r_img, image_u8, geom, ext, cfg,
                    scale: float = 0.005):
    """One frame of vision_lo_run_chunk_polar then mapping_run_chunk, as the
    stages: (st', out [25], mst', mo_out [1, 8])."""
    vo = cfg.vo
    m = cfg.mapping
    check_default_path(vo)
    n_rays = geom.fov_dirs.shape[0] * geom.fov_dirs.shape[1]
    grid_scan = fov_points(r_img, geom, scale)
    feats = register_scan_polar(r_img, geom.dirs, cfg.lidar, cfg.scanreg,
                                scale)
    *seed, img = seed_stage(st, image_u8, ext)
    xy, _, kp_mask = features.detect_keypoints(img, vo)
    desc = features.describe_keypoints(img, xy, vo)
    grid = depth_grid_stage(grid_scan, n_rays, ext, vo)
    curr_uv, valid = match_stage(st.vision, desc, kp_mask, xy, vo)
    vo_res = vo_stage(st, curr_uv, valid, seed, ext, cfg)
    lo = lo_stage(st, feats, seed[0], vo_res, cfg)
    stacks = (*voxel_stage(feats.less_sharp, m.line_resolution,
                           m.corner_stack_cap),
              *voxel_stage(feats.less_flat, m.plane_resolution,
                           m.surf_stack_cap))
    st2, out = tail1_stage(st, VisionState(xy, kp_mask, desc, img, grid),
                           feats, lo, vo_res[3])
    mst2, mo = mapping_stage(mst, stacks, lo[4], lo[5], cfg)
    return st2, out, mst2, mo


def whole_frame(st, mst, r_img, image_u8, geom, ext, cfg,
                scale: float = 0.005):
    """The same frame through the engine's functions: the loop body of
    vision_lo_run_chunk_polar (its depth-grid points,
    register_scan_polar, _vision_lo_frame) and mapping_run_chunk."""
    n_rays = geom.fov_dirs.shape[0] * geom.fov_dirs.shape[1]
    grid_scan = fov_points(r_img, geom, scale)
    feats = register_scan_polar(r_img, geom.dirs, cfg.lidar, cfg.scanreg,
                                scale)
    st, out, stacks = _vision_lo_frame(st, grid_scan, n_rays, feats,
                                       image_u8, ext, cfg)
    mst, mo = mapping_run_chunk(mst, *(x[None] for x in stacks),
                                out[None, 7:11], out[None, 11:14], cfg)
    return st, out, mst, mo


def engine_parts(cfg, n_az: int, dev):
    """(calib, ext, geom) as VloamEngine builds them for the synthetic rig."""
    from ..data import synthetic

    calib = _Calib(cfg.vo.img_width, cfg.vo.img_height)
    elev = torch.tensor(np.radians(synthetic.hdl64_elevations(
        cfg.lidar.n_scans)), dtype=torch.float32, device=dev)
    return (calib, CamExtrinsics.from_calib(calib, dev),
            PolarGeometry.create(elev, n_az, cfg.vo.polar_fov_fraction))


# ---- the sections ----

def _vision_section(table, cfg, dev, n_az, n_workers):
    """profile_vision_stages.py's stages on its own frame."""
    from ..data import synthetic

    vo = cfg.vo
    S = cfg.lidar.n_scans
    T = synthetic.drive_trajectory(2)[1]
    img_u8 = camera_images([T], vo.img_width, vo.img_height, n_workers)[0]
    scan_np = xyz_frames([T], [1], S, n_az, cfg.lidar.max_points)[0]
    _, ext, _ = engine_parts(cfg, n_az, dev)
    img = (torch.from_numpy(img_u8).to(dev).to(torch.float32)
           * reciprocal_f32(255.0))
    scan = torch.from_numpy(scan_np).to(dev)
    mask = torch.arange(scan.shape[0], device=dev) < n_points(scan_np)
    table.section(("scripts/profile_vision_stages.py",),
                  "the vision stages on the script's frame "
                  "(drive_trajectory(2)[1], its xyz scan and image)")
    K, W, H = vo.max_keypoints, vo.img_width, vo.img_height
    xy, _, m = table.stage("detect_keypoints", lambda: features.
                           detect_keypoints(img, vo),
                           jax="detect_keypoints", shape=f"({K}, {W}x{H})",
                           expect={})
    p = vo.descriptor_patch
    desc = table.stage("describe_keypoints [K3]",
                       lambda: features.describe_keypoints(img, xy, vo),
                       jax="describe_keypoints", shape=f"({K} x {p}x{p})",
                       expect={"zncc_describe": 1})
    table.stage("match_descriptors (the frame against itself)",
                lambda: features.match_descriptors(
                    desc, m, desc, m, vo.match_ratio, matcher=vo.matcher,
                    select=vo.match_select),
                jax="match_descriptors", shape=f"({K}x{K}x{p * p})",
                expect={})
    grid = table.stage("build_depth_grid", lambda: build_depth_grid(
        scan, mask, ext.P_velo_to_img, vo), jax="build_depth_grid",
        shape=f"({n_points(scan_np)} pts)", expect={})
    table.stage("query_depth", lambda: query_depth(grid, xy, vo),
                jax="query_depth", shape=f"({K})", expect={})
    zero = torch.zeros(3, device=dev)
    table.stage(f"solve_vo ({vo.max_iterations} LM iterations)",
                lambda: solve_vo(xy, xy, m, grid, ext.Kinv, zero, zero, vo),
                jax="solve_vo (32 LM iters)", expect={})


def _frame_section(table, cfg, dev, n_az, frames, images):
    vo = cfg.vo
    m = cfg.mapping
    check_default_path(vo)
    _, ext, geom = engine_parts(cfg, n_az, dev)
    r = [torch.from_numpy(f.astype(np.int32)).to(dev) for f in frames[:3]]
    im = [torch.from_numpy(i).to(dev) for i in images[:3]]
    st = VisionLoState.create(cfg, dev)
    mst = MapState.create(cfg, dev)
    st, vl, stacks = vision_lo_run_chunk_polar(st, torch.stack(r[:2]), geom,
                                               torch.stack(im[:2]), ext, cfg)
    mst, _ = mapping_run_chunk(mst, *stacks, vl[:, 7:11], vl[:, 11:14], cfg)
    table.section(("scripts/profile_vision_chunk.py",),
                  "the combined polar frame's stages (frame 2 on the state "
                  "of frames 0-1) beside the whole frame")
    n_rays = geom.fov_dirs.shape[0] * geom.fov_dirs.shape[1]
    r2, im2 = r[2], im[2]
    K = vo.max_keypoints

    def stage(key, label, fn, jax="", shape=""):
        return table.stage(label, fn, jax=jax, shape=shape, expect=HAND[key],
                           key="vloam:" + key)

    grid_scan = stage("fov", "depth-grid points (forward columns)",
                      lambda: fov_points(r2, geom, 0.005),
                      shape=f"{n_rays} rays")
    feats = stage("scanreg", "register_scan_polar [K1]",
                  lambda: register_scan_polar(r2, geom.dirs, cfg.lidar,
                                              cfg.scanreg),
                  jax="(in vision_lo_run_chunk_polar)")
    *seed, img = stage("seed", "VO seed from LO f2f, image as float",
                       lambda: seed_stage(st, im2, ext))
    xy, _, kp_mask = stage("detect", "detect_keypoints",
                           lambda: features.detect_keypoints(img, vo),
                           jax="detect_keypoints")
    desc = stage("describe", "describe_keypoints [K3]",
                 lambda: features.describe_keypoints(img, xy, vo),
                 jax="describe_keypoints")
    grid = stage("depth_grid", "build_depth_grid",
                 lambda: depth_grid_stage(grid_scan, n_rays, ext, vo),
                 jax="build_depth_grid")
    curr_uv, valid = stage("match", "match_descriptors + gather",
                           lambda: match_stage(st.vision, desc, kp_mask, xy,
                                               vo),
                           jax="match_descriptors", shape=f"{K} x {K}")
    vo_res = stage("vo", "solve_vo (query_depth, LM) + selects + LO prior",
                   lambda: vo_stage(st, curr_uv, valid, seed, ext, cfg),
                   jax="query_depth + solve_vo")
    lo = stage("lo", "solve_lo seeded by VO + LO world pose "
               "[ring_min1_packed x4]", lambda: lo_stage(st, feats, seed[0],
                                                         vo_res, cfg))
    c = stage("voxel_corner", "voxel corner stack", lambda: voxel_stage(
        feats.less_sharp, m.line_resolution, m.corner_stack_cap))
    s = stage("voxel_surf", "voxel surf stack", lambda: voxel_stage(
        feats.less_flat, m.plane_resolution, m.surf_stack_cap))
    stage("tail1", "loop 1 tail: state, 25-float row",
          lambda: tail1_stage(st, VisionState(xy, kp_mask, desc, img, grid),
                              feats, lo, vo_res[3]))
    stage("mapping", "mapping_run_chunk, 1 frame [grid_probe, row_gather x2]",
          lambda: mapping_stage(mst, (*c, *s), lo[4], lo[5], cfg),
          jax="mapping_run_chunk")
    table.stage("whole combined frame: loop 1 + loop 2",
                lambda: whole_frame(st, mst, r2, im2, geom, ext, cfg),
                jax="vision_lo_run_chunk_polar + mapping_run_chunk, a frame",
                expect=FRAME_HAND, key="vloam:frame")
    table.sum_check("VloamEngine frame", ["vloam:" + k for k in TOP],
                    "vloam:frame")
    return ext, geom


def _chunk_section(table, cfg, dev, frames, images, ext, geom, chunk):
    F = chunk
    table.section(("scripts/profile_vision_chunk.py",),
                  "vision_lo_run_chunk_polar and mapping_run_chunk over "
                  f"the drive's first {F} frame(s)")
    ranges = torch.from_numpy(np.stack(frames[:F]).astype(np.int32)).to(dev)
    imgs = torch.from_numpy(np.stack(images[:F])).to(dev)
    st = VisionLoState.create(cfg, dev)
    mst = MapState.create(cfg, dev)
    _, vl, stacks = table.stage(
        f"vision_lo_run_chunk_polar ({F} frame(s))",
        lambda: vision_lo_run_chunk_polar(st, ranges, geom, imgs, ext, cfg),
        jax="vision_lo_run_chunk (program 1: vision+scanreg+LO)",
        shape=f"{F} frame(s)", expect={"select_rings": F,
                                     "ring_min1_packed": 4 * F,
                                     "zncc_describe": F})
    table.stage(f"mapping_run_chunk ({F} frame(s))",
                lambda: mapping_run_chunk(mst, *stacks, vl[:, 7:11],
                                          vl[:, 11:14], cfg),
                jax="mapping_run_chunk", shape=f"{F} frame(s)",
                expect={"grid_probe": F, "row_gather": 2 * F})
    a, b = table.rows[-2], table.rows[-1]
    table.note(f"a frame: {(a['wall_ms'] + b['wall_ms']) / F:.2f} ms wall, "
               f"{(a['host_ms'] + b['host_ms']) / F:.2f} ms host"
               + (f", {(a['device_ms'] + b['device_ms']) / F:.2f} ms device"
                  if a["device_ms"] is not None else ""))


def run(device="cuda", tiny: bool = False, runs: int = 3, replays: int = 20,
        chunk: int = 8, frames=None, images=None) -> dict:
    """Every section; returns the JSON record. frames, images: the drive's
    first max(3, chunk) range images and camera images where the caller has
    them."""
    from ..data import synthetic

    dev = engine_device(device)
    base, n_az = profile(tiny)
    cfg = base.replace(detach_VO_LO=False)
    vo = cfg.vo
    n = max(3, chunk)
    table = StageTable("profile_vision_stages", dev, runs, replays, tiny)
    frames = frames or drive_frames(n, cfg.lidar.n_scans, n_az,
                                    workers(tiny))
    images = images or camera_images(
        synthetic.drive_trajectory(n, speed=1.1, yaw_rate=0.01),
        vo.img_width, vo.img_height, workers(tiny))
    _vision_section(table, cfg, dev, n_az, workers(tiny))
    ext, geom = _frame_section(table, cfg, dev, n_az, frames, images)
    _chunk_section(table, cfg, dev, frames, images, ext, geom, chunk)
    return table.result()


def main(argv=None) -> int:
    args = parse("vloam_tpu_torch.tools.profile_vision_stages", __doc__,
                 argv)
    emit(run(args.device, args.tiny, args.runs, args.replays, args.chunk))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
