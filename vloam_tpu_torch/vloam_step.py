"""Device-resident combined camera + LiDAR engine (port of
vloam_tpu/vloam_step.py, single-device path).

Per chunk of F frames, two frame loops over state that stays on the device
(the JAX reference's two lax.scan programs):

  1. vision + LO, per frame: detect / describe (K3) / match -> depth grid ->
     VO solve seeded from the previous frame's LO f2f (reference
     visual_odometry.cpp:269-281) -> scan registration (K1) -> f2f LO
     (ring_min1_packed) seeded from the same frame's VO when detach_VO_LO
     is False (laser_odometry.cpp:223-236) -> voxel-downsampled map stacks,
  2. mapping, per frame: scan-to-map refinement of the LO world poses over
     those stacks, carrying the grid map.

The VO <-> LO coupling transforms (vloam_tf.cpp:59-75) are quaternion pose
algebra on the device. Nothing in the frame loops reads a device value on
the host: every lax.cond / jnp.where of the reference is a torch.where over
results computed unconditionally, and the packed VLOAM_OUT_DIM rows stay on
the device until ``VloamEngine.finish``.

Every VO option runs as the reference's: the detectors, the ZNCC and ORB
descriptors, the BF and FLANN matchers with KNN or NN selection, CLAHE,
bucket NMS, LK flow matching and the low-texture fallback (LK flow
re-matches a frame pair whose descriptor matches collapsed). With a mesh,
loop 2 is the mapping chunk sharded over its ranks
(parallel/mesh_fused.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .data.synthetic import hdl64_elevations, pad_scan
from .geometry import so3
from .lidar.loam_step import (_select_tree, _upload, _upload_polar,
                              engine_device, pack12, unpack12,
                              unpack_outputs)
from .lidar.mapping import GridMap, export_map_points, solve_mapping
from .lidar.odometry import solve_lo
from .lidar.ring_assoc import RingSlab
from .lidar.scan_registration import (polar_directions, ray_directions,
                                      register_scan, register_scan_polar)
from .lidar.voxel import reciprocal_f32, voxel_downsample
from .vision import features
from .vision.depth_map import DepthGrid, build_depth_grid, grid_shape
from .vision.optical_flow import lk_flow
from .vision.vo import solve_vo

VLOAM_OUT_DIM = 33


class CamExtrinsics(NamedTuple):
    """The constant extrinsic chain as quaternion poses on the device, the
    inverse intrinsics (computed once on the host) and the projection."""

    q_base_cam: torch.Tensor  # base_T_cam0
    t_base_cam: torch.Tensor
    q_velo_cam: torch.Tensor  # velo_T_cam0
    t_velo_cam: torch.Tensor
    Kinv: torch.Tensor  # [3, 3]
    P_velo_to_img: torch.Tensor  # [3, 4]

    @staticmethod
    def from_calib(calib, device) -> "CamExtrinsics":
        from scipy.spatial.transform import Rotation as R

        base_T_cam = np.asarray(calib.imu_T_cam0, np.float64)
        imu_T_velo = np.asarray(calib.imu_T_velo, np.float64)
        velo_T_cam = np.linalg.inv(imu_T_velo) @ base_T_cam
        K = np.asarray(calib.K, np.float32)

        def t(x):
            return torch.tensor(np.asarray(x), dtype=torch.float32,
                                device=device)

        return CamExtrinsics(
            q_base_cam=t(R.from_matrix(base_T_cam[:3, :3]).as_quat()),
            t_base_cam=t(base_T_cam[:3, 3]),
            q_velo_cam=t(R.from_matrix(velo_T_cam[:3, :3]).as_quat()),
            t_velo_cam=t(velo_T_cam[:3, 3]),
            Kinv=t(np.linalg.inv(K)),
            P_velo_to_img=t(calib.P_velo_to_img),
        )


def _compose(q1, t1, q2, t2):
    return (so3.quat_normalize(so3.quat_multiply(q1, q2)),
            so3.quat_rotate(q1, t2) + t1)


def _invert(q, t):
    qi = so3.quat_conjugate(q)
    return qi, -so3.quat_rotate(qi, t)


def _conjugate(q_a, t_a, q_x, t_x):
    """a^-1 * x * a."""
    qa_i, ta_i = _invert(q_a, t_a)
    q1, t1 = _compose(qa_i, ta_i, q_x, t_x)
    return _compose(q1, t1, q_a, t_a)


class VisionState(NamedTuple):
    prev_kp: torch.Tensor  # [K, 2]
    prev_kp_mask: torch.Tensor  # [K]
    prev_desc: torch.Tensor  # [K, D]: D = P*P (ZNCC) or 256 (ORB)
    prev_img: torch.Tensor  # [H, W]
    prev_grid: DepthGrid

    @staticmethod
    def create(cfg, device) -> "VisionState":
        k = cfg.vo.max_keypoints
        d = features.descriptor_dim(cfg.vo)
        gw, gh = grid_shape(cfg.vo)

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return VisionState(
            prev_kp=zeros((k, 2)), prev_kp_mask=zeros((k,), torch.bool),
            prev_desc=zeros((k, d)),
            prev_img=zeros((cfg.vo.img_height, cfg.vo.img_width)),
            prev_grid=DepthGrid(u=zeros((gw, gh)), v=zeros((gw, gh)),
                                z=zeros((gw, gh)),
                                cnt=zeros((gw, gh), torch.int32)),
        )


class VisionLoState(NamedTuple):
    vision: VisionState
    corner_last: RingSlab
    surf_last: RingSlab
    q_f2f: torch.Tensor  # [4] last LO frame-to-frame estimate
    t_f2f: torch.Tensor
    q_w: torch.Tensor  # [4] LO world pose (odom frame)
    t_w: torch.Tensor
    frame_idx: torch.Tensor  # [] int32

    @staticmethod
    def create(cfg, device) -> "VisionLoState":
        sr = cfg.scanreg
        S = cfg.lidar.n_scans
        zeros3 = torch.zeros(3, dtype=torch.float32, device=device)
        return VisionLoState(
            vision=VisionState.create(cfg, device),
            corner_last=RingSlab.empty(S, sr.less_sharp_cap // S, device),
            surf_last=RingSlab.empty(S, sr.less_flat_cap // S, device),
            q_f2f=so3.identity_quat(device), t_f2f=zeros3,
            q_w=so3.identity_quat(device), t_w=zeros3,
            frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        )


class MapState(NamedTuple):
    cube: GridMap
    q_wmap_wodom: torch.Tensor
    t_wmap_wodom: torch.Tensor
    frame_idx: torch.Tensor

    @staticmethod
    def create(cfg, device) -> "MapState":
        return MapState(
            cube=GridMap.create(cfg.mapping, device),
            q_wmap_wodom=so3.identity_quat(device),
            t_wmap_wodom=torch.zeros(3, dtype=torch.float32, device=device),
            frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        )


def _vision_frame_core(vstate: VisionState, scan, n_pts, image_u8, a_seed,
                       t_seed, initialized, ext: CamExtrinsics, cfg):
    """Vision half of one frame: detect / describe / match (or LK flow), depth
    grid and the VO solve from an explicit cam-frame seed. Returns (vstate',
    prior_q, prior_t, vo_ok, vo_out [9])."""
    vo = cfg.vo
    dev = image_u8.device
    img = image_u8.to(torch.float32) * reciprocal_f32(255.0)
    if vo.clahe:
        img = features.clahe(img)
    xy, score, kp_mask = features.detect_keypoints(img, vo)
    if vo.keypoint_nms:
        kp_mask = features.bucket_nms(xy, score, kp_mask, vo.img_width,
                                      vo.img_height, vo.nms_bucket,
                                      vo.nms_bucket, vo.nms_max_total)
    desc = features.describe_keypoints(img, xy, vo)
    in_mask = torch.arange(scan.shape[0], device=dev) < n_pts
    grid = build_depth_grid(scan, in_mask, ext.P_velo_to_img, vo)

    if vo.reset_VO_to_identity:
        a_seed = torch.zeros_like(a_seed)
        t_seed = torch.zeros_like(t_seed)

    if vo.optical_flow_match:
        curr_uv, status = lk_flow(vstate.prev_img, img, vstate.prev_kp, vo)
        valid = vstate.prev_kp_mask & status
    else:
        idx1, valid = features.match_descriptors(
            vstate.prev_desc, vstate.prev_kp_mask, desc, kp_mask,
            vo.match_ratio, matcher=vo.matcher, select=vo.match_select)
        curr_uv = torch.index_select(xy, 0, idx1)
        if vo.lowtex_fallback:
            # descriptor matching collapsed (low texture): re-match the
            # frame pair by LK flow, which tracks faint texture that fails
            # the ratio test. A device select, never a host branch.
            xy1, status = lk_flow(vstate.prev_img, img, vstate.prev_kp, vo)
            used_flow = torch.sum(valid) < vo.min_vo_matches
            curr_uv = torch.where(used_flow, xy1, curr_uv)
            valid = torch.where(used_flow, vstate.prev_kp_mask & status,
                                valid)
    valid = valid & initialized

    angles, t_vo, n32, n22 = solve_vo(vstate.prev_kp, curr_uv, valid,
                                      vstate.prev_grid, ext.Kinv, a_seed,
                                      t_seed, vo)
    q_vo = so3.quat_from_axis_angle(angles)
    solve_ok = (initialized & torch.all(torch.isfinite(angles))
                & torch.all(torch.isfinite(t_vo))
                & (n32 + n22 >= vo.min_vo_matches))
    if vo.lowtex_fallback:
        # Only a descriptor solve may seed LO (flow on textureless input can
        # track confidently wrong). The exported stream falls back from the
        # solve (descriptors or flow) to the LO-derived seed, then identity.
        vo_ok = solve_ok & ~used_flow
        q_fb = so3.quat_from_axis_angle(a_seed)
        q_fb = torch.where(torch.all(torch.isfinite(q_fb)), q_fb,
                           so3.identity_quat(dev))
        t_fb = torch.where(torch.all(torch.isfinite(t_seed)), t_seed, 0.0)
        q_vo = torch.where(solve_ok, q_vo, q_fb)
        t_vo = torch.where(solve_ok, t_vo, t_fb)
    else:
        vo_ok = solve_ok
        q_vo = torch.where(vo_ok, q_vo, so3.identity_quat(dev))
        t_vo = torch.where(vo_ok, t_vo, 0.0)

    q_vo_i, t_vo_i = _invert(q_vo, t_vo)
    qv_i, tv_i = _invert(ext.q_velo_cam, ext.t_velo_cam)
    q_pr, t_pr = _conjugate(qv_i, tv_i, q_vo_i, t_vo_i)

    vo_out = torch.cat([q_vo, t_vo, torch.stack([n32, n22]).to(torch.float32)])
    return VisionState(xy, kp_mask, desc, img, grid), q_pr, t_pr, vo_ok, vo_out


def _seed_from_lo_f2f(q_lo_f2f, t_lo_f2f, ext: CamExtrinsics):
    """Cam-frame VO seed from the LO f2f estimate:
    cam0_curr_LOT_cam0_prev = base_T_cam0^-1 * T_lo_f2f^-1 * base_T_cam0
    (visual_odometry.cpp:269-281)."""
    q_lo_i, t_lo_i = _invert(q_lo_f2f, t_lo_f2f)
    q_seed, t_seed = _conjugate(ext.q_base_cam, ext.t_base_cam, q_lo_i, t_lo_i)
    return so3.axis_angle_from_quat(q_seed), t_seed


def _vision_lo_frame(st: VisionLoState, grid_scan, grid_n, feats, image_u8,
                     ext: CamExtrinsics, cfg):
    """One frame of loop 1. grid_scan / grid_n feed the depth grid (the FOV
    columns in polar mode); feats are the frame's scan-registration
    features. Returns (st', out [25], stacks (c_xyz, c_m, s_xyz, s_m))."""
    dev = st.q_w.device
    initialized = st.frame_idx > 0
    a_seed, t_seed = _seed_from_lo_f2f(st.q_f2f, st.t_f2f, ext)
    vst, q_pr, t_pr, vo_ok, vo_out = _vision_frame_core(
        st.vision, grid_scan, grid_n, image_u8, a_seed, t_seed, initialized,
        ext, cfg)
    use_prior = vo_ok & (not cfg.detach_VO_LO)
    q0 = torch.where(use_prior, q_pr, st.q_f2f)
    t0 = torch.where(use_prior, t_pr, st.t_f2f)

    # The LO solve runs on frame 0 too: its all-SENTINEL slabs zero every
    # IRLS weight, so it returns its seed and the select reproduces the skip.
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

    c_xyz, _, _, c_m = voxel_downsample(
        feats.less_sharp.xyz, feats.less_sharp.mask,
        cfg.mapping.line_resolution, cfg.mapping.corner_stack_cap)
    s_xyz, _, _, s_m = voxel_downsample(
        feats.less_flat.xyz, feats.less_flat.mask,
        cfg.mapping.plane_resolution, cfg.mapping.surf_stack_cap)

    new_st = VisionLoState(
        vision=vst, corner_last=feats.less_sharp_slab,
        surf_last=feats.less_flat_slab, q_f2f=q, t_f2f=t, q_w=q_w, t_w=t_w,
        frame_idx=st.frame_idx + 1)
    counts = torch.stack([n_c, n_s]).to(torch.float32)
    out = torch.cat([q, t, q_w, t_w, counts, vo_out]).to(torch.float32)
    return new_st, out, (c_xyz, c_m, s_xyz, s_m)


def _stack_frames(outs, stacks):
    return torch.stack(outs), tuple(torch.stack(s) for s in zip(*stacks))


def vision_lo_run_chunk(state: VisionLoState, scans: torch.Tensor,
                        n_pts: torch.Tensor, images_u8: torch.Tensor,
                        ext: CamExtrinsics, cfg):
    """Loop 1 over F frames, xyz ingest: scans [F, max_points, 3], n_pts [F],
    images [F, H, W] uint8. Returns (state', out [F, 25], stacks of
    [F, ...])."""
    outs, stacks = [], []
    for f in range(scans.shape[0]):
        feats = register_scan(scans[f], n_pts[f], cfg.lidar, cfg.scanreg)
        state, out, st = _vision_lo_frame(state, scans[f], n_pts[f], feats,
                                          images_u8[f], ext, cfg)
        outs.append(out)
        stacks.append(st)
    return (state, *_stack_frames(outs, stacks))


class PolarGeometry(NamedTuple):
    """Static ray geometry of a range image: all rays for scan
    registration, and the forward columns the depth grid decodes."""

    dirs: torch.Tensor  # [S, A, 3]
    fov_dirs: torch.Tensor  # [S, A', 3]
    half: int  # the first and last `half` columns; 0 = all columns

    @staticmethod
    def create(elev_rad, n_azimuth: int, fov_fraction: float,
               device=None) -> "PolarGeometry":
        """Both tables from scan_registration.ray_directions (elev_rad [S]
        a tensor or an array; device as ray_directions takes it)."""
        A = n_azimuth
        frac = min(max(fov_fraction, 0.0), 1.0)
        half = min(A, max(1, int(round(A * frac / 2.0))))
        # the JAX combined engine's azimuths, -(i * f32(2 pi / A)): its step
        # is an ulp off scan_registration.azimuth_angles' at some widths
        az = -(np.arange(A, dtype=np.float32) * np.float32(2.0 * math.pi / A))
        if 2 * half < A:
            az = np.concatenate([az[:half], az[A - half:]])
        else:
            half = 0
        return PolarGeometry(polar_directions(elev_rad, A, device),
                             ray_directions(elev_rad, az, device), half)

    def fov_columns(self, r_img: torch.Tensor) -> torch.Tensor:
        if self.half == 0:
            return r_img
        A = r_img.shape[1]
        return torch.cat([r_img[:, :self.half], r_img[:, A - self.half:]],
                         dim=1)


def vision_lo_run_chunk_polar(state: VisionLoState, ranges: torch.Tensor,
                              geom: PolarGeometry, images_u8: torch.Tensor,
                              ext: CamExtrinsics, cfg, scale: float = 0.005,
                              packed: bool = False):
    """Loop 1, polar ingest: ranges [F, S, A] integer range images (or
    [F, S, A//2*3] uint8 pack12 images when `packed`). Scan registration
    reads the whole image; the depth grid decodes only the forward
    cfg.vo.polar_fov_fraction of the columns (rays outside the camera's
    FOV never project)."""
    n_rays = geom.fov_dirs.shape[0] * geom.fov_dirs.shape[1]
    outs, stacks = [], []
    for f in range(ranges.shape[0]):
        r_img = unpack12(ranges[f]) if packed else ranges[f]
        r = geom.fov_columns(r_img).to(torch.float32) * scale
        grid_scan = (geom.fov_dirs * r[..., None]).reshape(-1, 3)
        feats = register_scan_polar(r_img, geom.dirs, cfg.lidar, cfg.scanreg,
                                    scale)
        state, out, st = _vision_lo_frame(state, grid_scan, n_rays, feats,
                                          images_u8[f], ext, cfg)
        outs.append(out)
        stacks.append(st)
    return (state, *_stack_frames(outs, stacks))


def mapping_run_chunk(mstate: MapState, c_xyz, c_m, s_xyz, s_m, q_w_lo,
                      t_w_lo, cfg):
    """Loop 2: scan-to-map refinement over F frames' stacks and LO world
    poses. Returns (mstate', out [F, 8] = [q_mo(4), t_mo(3), mapped])."""
    dev = q_w_lo.device
    outs = []
    for f in range(q_w_lo.shape[0]):
        q_w, t_w = q_w_lo[f], t_w_lo[f]
        q_pred = so3.quat_normalize(
            so3.quat_multiply(mstate.q_wmap_wodom, q_w))
        t_pred = mstate.t_wmap_wodom + so3.quat_rotate(mstate.q_wmap_wodom,
                                                       t_w)
        cube, q_m, t_m, _ = solve_mapping(mstate.cube, c_xyz[f], c_m[f],
                                          s_xyz[f], s_m[f], q_pred, t_pred,
                                          cfg.mapping)
        if cfg.lo.mapping_skip_frame == 1:
            mapped = torch.ones((), dtype=torch.bool, device=dev)
        else:
            # skipped frames run the solve too and `mapped` selects: the
            # reference's lax.cond would be a host read here
            mapped = (mstate.frame_idx % cfg.lo.mapping_skip_frame) == 0
            cube = _select_tree(mapped, cube, mstate.cube)
            q_m = torch.where(mapped, q_m, q_pred)
            t_m = torch.where(mapped, t_m, t_pred)
        q_off = so3.quat_normalize(
            so3.quat_multiply(q_m, so3.quat_conjugate(q_w)))
        t_off = t_m - so3.quat_rotate(q_off, t_w)
        mstate = MapState(
            cube=cube,
            q_wmap_wodom=torch.where(mapped, q_off, mstate.q_wmap_wodom),
            t_wmap_wodom=torch.where(mapped, t_off, mstate.t_wmap_wodom),
            frame_idx=mstate.frame_idx + 1)
        outs.append(torch.cat([q_m, t_m, mapped.to(torch.float32)[None]]))
    return mstate, torch.stack(outs)


def _fit_image(image: np.ndarray, vo_cfg) -> np.ndarray:
    """Crop / zero-pad an image to the configured shape (bottom / right
    only, so pixel coordinates and the intrinsics stay valid)."""
    H, W = vo_cfg.img_height, vo_cfg.img_width
    if image.shape == (H, W):
        return image
    image = image[:H, :W]
    if image.shape != (H, W):
        image = np.pad(image, ((0, H - image.shape[0]),
                               (0, W - image.shape[1])))
    return image


def _to_u8(image: np.ndarray) -> np.ndarray:
    if image.dtype != np.uint8:
        image = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    return image


class VloamEngine:
    """Host wrapper of the combined camera + LiDAR engine: chunks of F
    frames through loop 1 (vision + LO) and loop 2 (mapping), exchanging the
    LO world poses and voxel-downsampled stacks as [F]-shaped device
    tensors. Outputs stay on the device until `finish()` (one download).

    calib: K [3, 3], P_velo_to_img [3, 4], imu_T_velo and imu_T_cam0 [4, 4].
    device: where the state lives and every frame runs: the card by default
    (the hand-written kernels), and without one the constructor raises;
    "cpu" runs the kernels' plain PyTorch versions.
    pack12: stage push_polar images as 12-bit packed uint8
    (lidar.loam_step.pack12).
    map_callback(frame_idx, corner, surf): as LoamEngine's, after the chunk
    that reaches every cfg.mapping.map_pub_number frames.
    mesh, mesh_window_rows: as LoamEngine's: loop 1 runs whole on every
    rank, loop 2 is the mesh mapping chunk (parallel/mesh_fused.py), and
    `window_active_rows` reports its window."""

    def __init__(self, cfg, calib, chunk: int = 8, device="cuda",
                 pack12: bool = False, map_callback=None, mesh=None,
                 mesh_window_rows: int = 4096):
        self.cfg = cfg
        self.chunk = chunk
        self.mesh = mesh
        if mesh is None:
            self.device = engine_device(device)
        else:
            from .parallel.mesh_fused import MeshMappingChunk
            from .parallel.sharded import mesh_device

            self.device = mesh_device(mesh, device)
            self._mesh_chunk = MeshMappingChunk(mesh, cfg, mesh_window_rows)
        self.pack12 = pack12
        self.ext = CamExtrinsics.from_calib(calib, self.device)
        # Polar ingest decodes only the forward +-(polar_fov_fraction * pi)
        # azimuth wedge for the depth grid; a camera yawed outside it would
        # silently lose all LiDAR depth, so check the principal axis here.
        frac = float(cfg.vo.polar_fov_fraction)
        if frac < 1.0:
            # cam0 +z in the velo frame: third column of velo_T_cam's rotation
            velo_T_cam = np.asarray(getattr(calib, "imu_T_cam0", np.eye(4)))
            axis = velo_T_cam[:3, 2]
            yaw = abs(float(np.arctan2(axis[1], axis[0])))
            half_fov = np.arctan2(cfg.vo.img_width / 2.0,
                                  float(np.asarray(calib.K)[0, 0]))
            if yaw + half_fov > frac * np.pi + 1e-6:
                raise ValueError(
                    f"camera FOV (yaw {np.degrees(yaw):.1f} deg +- "
                    f"{np.degrees(half_fov):.1f} deg from velo +x) exceeds "
                    f"the decoded polar wedge +-{frac * 180:.0f} deg; raise "
                    "vo.polar_fov_fraction (1.0 = full sweep)")
        self.vstate = VisionLoState.create(cfg, self.device)
        self.lstate = MapState.create(cfg, self.device)
        if mesh is not None:
            self.lstate = self._mesh_chunk.shard(self.lstate)
        self._outs: list[torch.Tensor] = []
        self._scans: list[np.ndarray] = []
        self._ns: list[int] = []
        self._imgs: list[np.ndarray] = []
        self._polar: list[np.ndarray] = []
        self._geom = None
        self._polar_scale = 0.005
        self.map_callback = map_callback
        self._next_pub = cfg.mapping.map_pub_number
        self._frame = 0  # frames pushed through, for the publish cadence

    @property
    def state(self):
        return (self.vstate, self.lstate)

    @property
    def window_active_rows(self) -> tuple[int, int]:
        return ((0, 0) if self.mesh is None
                else self._mesh_chunk.window_active_rows)

    def _run_mapping(self, vl_out, stacks):
        if self.mesh is None:
            self.lstate, mo_out = mapping_run_chunk(
                self.lstate, *stacks, vl_out[:, 7:11], vl_out[:, 11:14],
                self.cfg)
        else:
            self.lstate, mo_out = self._mesh_chunk(
                self.lstate, *stacks, vl_out[:, 7:11], vl_out[:, 11:14])
        return torch.cat([
            vl_out[:, :14],  # q_f2f, t_f2f, q_w_lo, t_w_lo
            mo_out[:, :7],  # q_mo, t_mo
            vl_out[:, 14:16],  # n_corner, n_surf
            mo_out[:, 7:8],  # mapped flag
            vl_out[:, 16:],  # vo_out (q_vo, t_vo, n32, n22)
        ], dim=1)

    def push(self, points: np.ndarray, image: np.ndarray):
        """Push one scan [n, 3] float32 (sensor frame) and its cam0 image
        [H, W] (uint8, or float in [0, 1])."""
        if self._polar:
            raise ValueError("do not mix push() and push_polar()")
        padded, n = pad_scan(points, self.cfg.lidar.max_points)
        self._scans.append(padded)
        self._ns.append(n)
        self._imgs.append(_fit_image(_to_u8(image), self.cfg.vo))
        if len(self._scans) >= self.chunk:
            self._flush()

    def push_polar(self, range_img: np.ndarray, image: np.ndarray,
                   range_scale: float = 0.005,
                   elevations_deg: np.ndarray | None = None):
        """Push one quantized range image [n_scans, n_azimuth] uint16 (0 = no
        return) and its cam0 image. All frames share shape and scale."""
        if self._scans:
            raise ValueError("do not mix push() and push_polar()")
        if self._geom is None:
            ed = (elevations_deg if elevations_deg is not None
                  else hdl64_elevations(self.cfg.lidar.n_scans))
            self._geom = PolarGeometry.create(
                np.radians(ed).astype(np.float32), range_img.shape[1],
                self.cfg.vo.polar_fov_fraction, self.device)
        self._polar_scale = range_scale
        self._polar.append(pack12(range_img) if self.pack12 else range_img)
        self._imgs.append(_fit_image(_to_u8(image), self.cfg.vo))
        if len(self._polar) >= self.chunk:
            self._flush_polar()

    def _flush_polar(self):
        if not self._polar:
            return
        ranges = _upload_polar(np.stack(self._polar), self.device)
        imgs = _upload(np.stack(self._imgs), self.device)
        self._polar, self._imgs = [], []
        self.vstate, vl_out, stacks = vision_lo_run_chunk_polar(
            self.vstate, ranges, self._geom, imgs, self.ext, self.cfg,
            self._polar_scale, packed=self.pack12)
        self._outs.append(self._run_mapping(vl_out, stacks))
        self._frame += ranges.shape[0]
        self._maybe_publish_map()

    def _flush(self):
        if not self._scans:
            return
        scans = _upload(np.stack(self._scans), self.device)
        ns = _upload(np.asarray(self._ns, np.int64), self.device)
        imgs = _upload(np.stack(self._imgs), self.device)
        self._scans, self._ns, self._imgs = [], [], []
        self.vstate, vl_out, stacks = vision_lo_run_chunk(
            self.vstate, scans, ns, imgs, self.ext, self.cfg)
        self._outs.append(self._run_mapping(vl_out, stacks))
        self._frame += scans.shape[0]
        self._maybe_publish_map()

    def _maybe_publish_map(self):
        if self.map_callback is not None and self._frame >= self._next_pub:
            cube = (self.lstate.cube if self.mesh is None
                    else self._mesh_chunk.whole_map(self.lstate.cube))
            corner, surf = export_map_points(cube)
            self.map_callback(self._frame, corner, surf)
            while self._next_pub <= self._frame:
                self._next_pub += self.cfg.mapping.map_pub_number

    def finish(self) -> np.ndarray:
        """[N, VLOAM_OUT_DIM] packed rows (one download)."""
        self._flush()
        self._flush_polar()
        if not self._outs:
            return np.zeros((0, VLOAM_OUT_DIM), np.float32)
        return torch.cat(self._outs).cpu().numpy()


def unpack_vloam_outputs(outs: np.ndarray, calib,
                         min_correspondences: int = 10) -> dict:
    """Named arrays and the three cam0-start-frame trajectories (VO / LO /
    MO) as [N, 3, 4], recomposed in float64 with the frame-chain algebra
    (vloam_tf.cpp:59-153), vectorized: a prefix product of the VO
    increments, then one batched conjugation per stream. base_T_cam0 =
    imu_T_cam0 (the frame chain's base_T_imu = I)."""
    from .fusion.frame_chain import base_T_cam0
    from .geometry.np_pose import inv_T, mat_cumprod, qt_to_T

    res = unpack_outputs(outs[:, :24], min_correspondences)
    res["q_vo"] = outs[:, 24:28].astype(np.float64)
    res["t_vo"] = outs[:, 28:31].astype(np.float64)
    res["n32"] = outs[:, 31].astype(int)
    res["n22"] = outs[:, 32].astype(int)

    n = len(outs)
    B = base_T_cam0(calib.imu_T_cam0)
    Binv = np.linalg.inv(B)
    # VO world accumulation (vloam_tf.cpp:59-75): per-frame increment
    # B inv(cam0_curr_T_cam0_last) B^-1; identity on frame 0 and on
    # non-finite solves
    C = qt_to_T(res["q_vo"], res["t_vo"])
    M = np.einsum("ij,njk,kl->nil", B, inv_T(C), Binv)
    bad = ~np.isfinite(M).all(axis=(1, 2))
    if n > 0:
        bad[0] = True
    M[bad] = np.eye(4)
    worlds = {
        "VO": mat_cumprod(M),
        "LO": qt_to_T(res["q_w_lo"], res["t_w_lo"]),
        "MO": qt_to_T(res["q_w_mo"], res["t_w_mo"]),
    }
    # export re-based to the cam0 start frame (vloam_tf.cpp:77-153)
    for which, W in worlds.items():
        X = np.einsum("ij,njk,kl->nil", Binv, W, B)
        start_inv = inv_T(X[0]) if n > 0 else np.eye(4)
        res[f"traj_{which}"] = np.einsum("ij,njk->nik", start_inv,
                                         X)[:, :3, :]
    return res
