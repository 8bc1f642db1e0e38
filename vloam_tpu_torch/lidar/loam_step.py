"""Device-resident LOAM step: scanreg + LO + MO per frame (port of
vloam_tpu/lidar/loam_step.py: the single-device main path, the lockstep
batch engine, and with a mesh the scanreg + LO half-program ahead of the
sharded mapping chunk, parallel/mesh_fused.py).

All recurrent state (last feature slabs, f2f/world poses, the grid map, the
odom->map offset) stays on the device as a LoamState of tensors. A chunk of
frames is a Python loop over that state (the JAX reference's lax.scan), and
each frame appends one packed OUT_DIM row that stays on the device until
``LoamEngine.finish`` downloads them all at once. Nothing in the frame loop
reads a device value back to the host, so on CUDA the host only queues
kernels; every decision the reference makes with lax.cond or jnp.where is a
``torch.where`` here.

The batch half (BatchLoamState, BatchLoamEngine) runs B independent
sequences in lockstep. Where the reference vmaps its single-stream stages
(registration, LO, the voxel filters) this port loops over the streams; the
mapping stage is flat-batched over all of them (batch_mapping.py), so its
launches are paid once per lockstep frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.synthetic import hdl64_elevations, pad_scan
from ..geometry import so3
from .batch_mapping import BatchGridMap, batch_map_evict, batch_solve_mapping
from .mapping import GridMap, export_map_points, solve_mapping
from .odometry import solve_lo
from .ring_assoc import RingSlab
from .scan_registration import (azimuth_angles, polar_directions,
                                ray_directions, register_scan,
                                register_scan_polar)
from .voxel import voxel_downsample

OUT_DIM = 24  # packed per-frame output row


class LoamState(NamedTuple):
    corner_last: RingSlab
    surf_last: RingSlab
    q_f2f: torch.Tensor  # [4] last LO frame-to-frame estimate (prior seed)
    t_f2f: torch.Tensor  # [3]
    q_w: torch.Tensor  # [4] LO world pose (odom frame)
    t_w: torch.Tensor  # [3]
    cube: GridMap
    q_wmap_wodom: torch.Tensor  # [4]
    t_wmap_wodom: torch.Tensor  # [3]
    frame_idx: torch.Tensor  # [] int32

    @staticmethod
    def create(cfg, device) -> "LoamState":
        sr = cfg.scanreg
        S = cfg.lidar.n_scans

        def zeros3():
            return torch.zeros(3, dtype=torch.float32, device=device)

        return LoamState(
            corner_last=RingSlab.empty(S, sr.less_sharp_cap // S, device),
            surf_last=RingSlab.empty(S, sr.less_flat_cap // S, device),
            q_f2f=so3.identity_quat(device), t_f2f=zeros3(),
            q_w=so3.identity_quat(device), t_w=zeros3(),
            cube=GridMap.create(cfg.mapping, device),
            q_wmap_wodom=so3.identity_quat(device), t_wmap_wodom=zeros3(),
            frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        )


def _select_tree(pred: torch.Tensor, a, b):
    """torch.where(pred, a, b) over matching NamedTuple trees of tensors."""
    if isinstance(a, torch.Tensor):
        return torch.where(pred, a, b)
    return type(a)(*(_select_tree(pred, x, y) for x, y in zip(a, b)))


def loam_frame_step(state: LoamState, scan: torch.Tensor, n_pts,
                    prior_q: torch.Tensor, prior_t: torch.Tensor,
                    use_prior: torch.Tensor, cfg):
    """One frame from an xyz point buffer [max_points, 3]; returns
    (new_state, out [OUT_DIM])."""
    feats = register_scan(scan, n_pts, cfg.lidar, cfg.scanreg)
    return loam_frame_step_feats(state, feats, prior_q, prior_t, use_prior,
                                 cfg)


def loam_frame_step_feats(state: LoamState, feats, prior_q, prior_t,
                          use_prior, cfg):
    """One frame from extracted features; returns (new_state, out [OUT_DIM]):
    out = [q_f2f(4), t_f2f(3), q_w_lo(4), t_w_lo(3), q_w_mo(4), t_w_mo(3),
           n_corner_corr, n_plane_corr, mapped_flag]."""
    dev = state.q_w.device
    q0 = torch.where(use_prior, prior_q, state.q_f2f)
    t0 = torch.where(use_prior, prior_t, state.t_f2f)
    q, t, n_c, n_s, q_w, t_w, (c_xyz, c_m, s_xyz, s_m) = _lo_step(
        state, feats, q0, t0, cfg)

    # ---- mapping ----
    q_pred = so3.quat_normalize(so3.quat_multiply(state.q_wmap_wodom, q_w))
    t_pred = state.t_wmap_wodom + so3.quat_rotate(state.q_wmap_wodom, t_w)

    cube, q_m, t_m, _ = solve_mapping(state.cube, c_xyz, c_m, s_xyz, s_m,
                                      q_pred, t_pred, cfg.mapping)
    if cfg.lo.mapping_skip_frame == 1:
        mapped = torch.ones((), dtype=torch.bool, device=dev)
    else:
        # Skipped frames still run the solve, and `mapped` selects its
        # result, so the host never reads the predicate (the reference's
        # lax.cond would be a device->host read here).
        mapped = (state.frame_idx % cfg.lo.mapping_skip_frame) == 0
        cube = _select_tree(mapped, cube, state.cube)
        q_m = torch.where(mapped, q_m, q_pred)
        t_m = torch.where(mapped, t_m, t_pred)

    # transformUpdate (reference laser_mapping.cpp:140-144), only on mapped
    q_off = so3.quat_normalize(
        so3.quat_multiply(q_m, so3.quat_conjugate(q_w)))
    t_off = t_m - so3.quat_rotate(q_off, t_w)
    q_wmap_wodom = torch.where(mapped, q_off, state.q_wmap_wodom)
    t_wmap_wodom = torch.where(mapped, t_off, state.t_wmap_wodom)

    new_state = LoamState(
        corner_last=feats.less_sharp_slab,
        surf_last=feats.less_flat_slab,
        q_f2f=q, t_f2f=t, q_w=q_w, t_w=t_w,
        cube=cube, q_wmap_wodom=q_wmap_wodom, t_wmap_wodom=t_wmap_wodom,
        frame_idx=state.frame_idx + 1,
    )
    counts = torch.stack([n_c, n_s, mapped.to(n_c.dtype)]).to(torch.float32)
    out = torch.cat([q, t, q_w, t_w, q_m, t_m, counts]).to(torch.float32)
    return new_state, out


def _lo_step(st, feats, q0, t0, cfg):
    """LO of one frame against st's last feature slabs (st: a LoamState or
    a LoChunkState) from the seed (q0, t0), its LO world pose, and the
    frame's voxel-downsampled mapping stacks. Returns (q_f2f, t_f2f,
    n_corner, n_surf, q_w, t_w, (c_xyz, c_m, s_xyz, s_m))."""
    dev = st.q_w.device
    initialized = st.frame_idx > 0
    # The LO solve runs on frame 0 too: its "last" slabs are all SENTINEL,
    # every association fails the 25 m^2 gate, all IRLS weights are zero
    # and the solve returns its seed — the select reproduces the skip.
    q_s, t_s, n_c, n_s = solve_lo(feats.sharp, feats.flat, st.corner_last,
                                  st.surf_last, q0, t0, cfg.lo)
    q = torch.where(initialized, q_s, so3.identity_quat(dev))
    t = torch.where(initialized, t_s, 0.0)
    n_c = torch.where(initialized, n_c, 0)
    n_s = torch.where(initialized, n_s, 0)
    # world accumulation (reference laser_odometry.cpp:477-478)
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
    return q, t, n_c, n_s, q_w, t_w, (c_xyz, c_m, s_xyz, s_m)


def _dequantize(scans: torch.Tensor, scale: float) -> torch.Tensor:
    """int16 staged scans (x scale metres per unit) -> float32 metres;
    float32 scans pass through."""
    if scans.dtype == torch.float32:
        return scans
    return scans.to(torch.float32) * scale


def loam_run_chunk(state: LoamState, scans: torch.Tensor, n_pts: torch.Tensor,
                   prior_q, prior_t, use_prior, cfg, scale: float = 1.0):
    """Advance F frames from xyz buffers [F, max_points, 3], float32 or
    int16 (x scale, dequantized on the device); returns (state, outs
    [F, OUT_DIM])."""
    scans = _dequantize(scans, scale)
    outs = []
    for f in range(scans.shape[0]):
        state, out = loam_frame_step(state, scans[f], n_pts[f], prior_q[f],
                                     prior_t[f], use_prior[f], cfg)
        outs.append(out)
    return state, torch.stack(outs)


def loam_run_chunk_polar(state: LoamState, ranges: torch.Tensor,
                         dirs: torch.Tensor, prior_q, prior_t, use_prior, cfg,
                         scale: float = 0.005, packed: bool = False):
    """Polar-ingest chunk: ranges [F, S, A] integer range images (or
    [F, S, A//2*3] uint8 pack12 images when `packed`), dirs [S, A, 3]."""
    outs = []
    for f in range(ranges.shape[0]):
        r_img = unpack12(ranges[f]) if packed else ranges[f]
        feats = register_scan_polar(r_img, dirs, cfg.lidar, cfg.scanreg,
                                    scale)
        state, out = loam_frame_step_feats(state, feats, prior_q[f],
                                           prior_t[f], use_prior[f], cfg)
        outs.append(out)
    return state, torch.stack(outs)


class LoChunkState(NamedTuple):
    """Recurrent state of the LiDAR-only scanreg + LO half-program, run
    apart from the mapping stage when that runs sharded over a mesh
    (parallel/mesh_fused.py). vloam_step.VisionLoState without the vision
    buffers."""

    corner_last: RingSlab
    surf_last: RingSlab
    q_f2f: torch.Tensor
    t_f2f: torch.Tensor
    q_w: torch.Tensor
    t_w: torch.Tensor
    frame_idx: torch.Tensor

    @staticmethod
    def create(cfg, device) -> "LoChunkState":
        sr = cfg.scanreg
        S = cfg.lidar.n_scans
        zeros3 = torch.zeros(3, dtype=torch.float32, device=device)
        return LoChunkState(
            corner_last=RingSlab.empty(S, sr.less_sharp_cap // S, device),
            surf_last=RingSlab.empty(S, sr.less_flat_cap // S, device),
            q_f2f=so3.identity_quat(device), t_f2f=zeros3,
            q_w=so3.identity_quat(device), t_w=zeros3.clone(),
            frame_idx=torch.zeros((), dtype=torch.int32, device=device))


def _lo_frame(st: LoChunkState, feats, cfg):
    """Scan features -> LO f2f, the LO world pose and the voxel-downsampled
    mapping stacks: the first half of loam_frame_step_feats, without the
    mapping solve. Returns (st', out [16] = [q_f2f, t_f2f, q_w, t_w,
    n_corner, n_surf], (c_xyz, c_m, s_xyz, s_m))."""
    q, t, n_c, n_s, q_w, t_w, stacks = _lo_step(st, feats, st.q_f2f,
                                                st.t_f2f, cfg)
    new_st = LoChunkState(
        corner_last=feats.less_sharp_slab, surf_last=feats.less_flat_slab,
        q_f2f=q, t_f2f=t, q_w=q_w, t_w=t_w, frame_idx=st.frame_idx + 1)
    out = torch.cat([q, t, q_w, t_w,
                     torch.stack([n_c, n_s]).to(torch.float32)])
    return new_st, out.to(torch.float32), stacks


def _lo_chunk(state: LoChunkState, frame_feats, cfg):
    outs, stacks = [], []
    for feats in frame_feats:
        state, out, st = _lo_frame(state, feats, cfg)
        outs.append(out)
        stacks.append(st)
    return (state, torch.stack(outs),
            tuple(torch.stack(x) for x in zip(*stacks)))


def lo_run_chunk(state: LoChunkState, scans: torch.Tensor,
                 n_pts: torch.Tensor, cfg, scale: float = 1.0):
    """scanreg + LO over F frames from xyz buffers (no mapping). Returns
    (state', outs [F, 16], stacks (c_xyz, c_m, s_xyz, s_m) of [F, ...])."""
    scans = _dequantize(scans, scale)
    return _lo_chunk(state, (register_scan(scans[f], n_pts[f], cfg.lidar,
                                           cfg.scanreg)
                             for f in range(scans.shape[0])), cfg)


def lo_run_chunk_polar(state: LoChunkState, ranges: torch.Tensor,
                       dirs: torch.Tensor, cfg, scale: float = 0.005,
                       packed: bool = False):
    """Polar-ingest scanreg + LO chunk (no mapping); ranges and dirs as
    loam_run_chunk_polar's."""
    return _lo_chunk(state, (register_scan_polar(
        unpack12(r) if packed else r, dirs, cfg.lidar, cfg.scanreg, scale)
        for r in ranges), cfg)


def engine_device(device) -> torch.device:
    """The device an engine's state lives on. The engines run on the card
    unless the caller names another device, and asking for the card where
    there is none raises: nothing carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for (the engines' default) but "
            "torch.cuda.is_available() is false; pass device=\"cpu\" to run "
            "the plain PyTorch versions on the CPU")
    return dev


def stage_scan(points: np.ndarray, cap: int, quantize_mm: float):
    """Host staging of one scan [n, 3] into a [cap, 3] buffer: float32, or
    with quantize_mm > 0 int16 in that many millimetres per unit (5 -> 5 mm
    resolution, coordinates clamped at +-163.8 m), which halves the upload.
    Returns (buffer, n kept)."""
    if quantize_mm <= 0:
        return pad_scan(points, cap)
    out = np.zeros((cap, 3), np.int16)
    n = min(len(points), cap)
    out[:n] = np.clip(points[:n] * (1000.0 / quantize_mm),
                      -32767, 32767).astype(np.int16)
    return out, n


def _upload_polar(stacked: np.ndarray, device) -> torch.Tensor:
    """Stacked range images (uint16, or pack12's uint8) -> device tensor;
    uint16 travels as its int16 bit pattern (2 bytes/ray) and is widened to
    int32 on the device."""
    if stacked.dtype == np.uint16:
        return _upload(stacked.view(np.int16), device).to(
            torch.int32) & 0xFFFF
    return _upload(stacked, device)


def _polar_dirs(cfg, n_azimuth: int, elevations_deg, device) -> torch.Tensor:
    """Unit ray directions [S, A, 3] of a range image's cells."""
    ed = (elevations_deg if elevations_deg is not None
          else hdl64_elevations(cfg.lidar.n_scans))
    return polar_directions(np.radians(ed).astype(np.float32), n_azimuth,
                            device)


def _upload(x: np.ndarray, device) -> torch.Tensor:
    """Host array -> device tensor without blocking the host: on CUDA the
    copy goes through pinned memory and is queued on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class LoamEngine:
    """Host wrapper: chunked device-resident LOAM over a frame stream.
    Outputs stay on the device until `finish()` (one download).

    quantize_mm > 0 stages push() scans as int16 in that many millimetres
    per unit (see stage_scan); the chunk dequantizes on the device.
    device: where the state lives and every frame runs: the card by default
    (the hand-written kernels), and without one the constructor raises;
    "cpu" runs the kernels' plain PyTorch versions.
    pack12: stage push_polar images as 12-bit packed uint8 (see pack12()).
    map_callback(frame_idx, corner [Mc, 3], surf [Ms, 3]): called after the
    chunk that reaches every cfg.mapping.map_pub_number frames with the
    accumulated map (the /laser_cloud_map publisher analogue, reference
    laser_mapping.cpp:778-793); each call downloads the map, a host sync
    between chunks.
    mesh: a parallel.sharded.Mesh (data_mesh()): every rank of it builds the
    same engine and pushes the same frames; scanreg + LO run whole on each
    rank and the mapping stage runs as distributed BA over the mesh
    (parallel/mesh_fused.py: map blocks and scan stacks sharded, windowed
    ring k-NN, all-reduced normal equations) on the rank's mesh.device.
    `window_active_rows` then reports (peak active map rows, the window's
    rows over all ranks) of the frames run so far (a host read);
    map_callback gets the whole map
    gathered from the ranks (a collective: pass one on every rank or on
    none)."""

    def __init__(self, cfg, chunk: int = 8, quantize_mm: float = 0.0,
                 device="cuda", pack12: bool = False, map_callback=None,
                 mesh=None, mesh_window_rows: int = 4096):
        self.cfg = cfg
        self.chunk = chunk
        self.quantize_mm = quantize_mm
        self.pack12 = pack12
        self.mesh = mesh
        if mesh is None:
            self.device = engine_device(device)
            self.state = LoamState.create(cfg, self.device)
        else:
            from ..parallel.mesh_fused import MeshMappingChunk
            from ..parallel.sharded import mesh_device
            from ..vloam_step import MapState

            self.device = mesh_device(mesh, device)
            self._mesh_chunk = MeshMappingChunk(mesh, cfg, mesh_window_rows)
            self.state = (LoChunkState.create(cfg, self.device),
                          self._mesh_chunk.shard(
                              MapState.create(cfg, self.device)))
        self._outs: list[torch.Tensor] = []
        self._pending_scans: list[np.ndarray] = []
        self._pending_n: list[int] = []
        self._pending_polar: list[np.ndarray] = []
        self._dirs = None
        self._polar_scale = 0.005
        self.map_callback = map_callback
        self._frames_done = 0
        self._next_pub = cfg.mapping.map_pub_number

    @property
    def window_active_rows(self) -> tuple[int, int]:
        return ((0, 0) if self.mesh is None
                else self._mesh_chunk.window_active_rows)

    def _after_chunk(self, n_frames: int):
        self._frames_done += n_frames
        if (self.map_callback is not None
                and self._frames_done >= self._next_pub):
            cube = (self.state.cube if self.mesh is None
                    else self._mesh_chunk.whole_map(self.state[1].cube))
            corner, surf = export_map_points(cube)
            self.map_callback(self._frames_done, corner, surf)
            while self._next_pub <= self._frames_done:
                self._next_pub += self.cfg.mapping.map_pub_number

    def _priors(self, f: int):
        """Identity priors for f frames (use_prior all False)."""
        pq = so3.identity_quat(self.device).expand(f, 4)
        pt = torch.zeros((f, 3), dtype=torch.float32, device=self.device)
        up = torch.zeros((f,), dtype=torch.bool, device=self.device)
        return pq, pt, up

    def push(self, points: np.ndarray):
        """Push one scan [n, 3] float32 (sensor frame)."""
        # xyz and polar queues flush on independent thresholds; interleaving
        # them would reorder frames relative to push order
        if self._pending_polar:
            raise ValueError("do not mix push() and push_polar()")
        buf, n = stage_scan(points, self.cfg.lidar.max_points,
                            self.quantize_mm)
        self._pending_scans.append(buf)
        self._pending_n.append(n)
        if len(self._pending_scans) >= self.chunk:
            self._flush()

    def push_polar(self, range_img: np.ndarray, range_scale: float = 0.005,
                   elevations_deg: np.ndarray | None = None):
        """Push one quantized range image [n_scans, n_azimuth] uint16 (0 =
        no return). All frames of a sequence share shape and scale."""
        if self._pending_scans:
            raise ValueError("do not mix push() and push_polar()")
        if self._dirs is None:
            self._dirs = _polar_dirs(self.cfg, range_img.shape[1],
                                     elevations_deg, self.device)
        self._polar_scale = range_scale
        self._pending_polar.append(pack12(range_img) if self.pack12
                                   else range_img)
        if len(self._pending_polar) >= self.chunk:
            self._flush_polar()

    def _flush_polar(self):
        if not self._pending_polar:
            return
        ranges = _upload_polar(np.stack(self._pending_polar), self.device)
        self._pending_polar = []
        if self.mesh is not None:
            outs = self._run_mesh(lo_run_chunk_polar, ranges, self._dirs,
                                  self.cfg, self._polar_scale,
                                  packed=self.pack12)
        else:
            pq, pt, up = self._priors(ranges.shape[0])
            self.state, outs = loam_run_chunk_polar(
                self.state, ranges, self._dirs, pq, pt, up, self.cfg,
                self._polar_scale, packed=self.pack12)
        self._outs.append(outs)
        self._after_chunk(ranges.shape[0])

    def _flush(self):
        if not self._pending_scans:
            return
        scans = _upload(np.stack(self._pending_scans), self.device)
        ns = _upload(np.asarray(self._pending_n, np.int64), self.device)
        self._pending_scans, self._pending_n = [], []
        scale = self.quantize_mm / 1000.0
        if self.mesh is not None:
            outs = self._run_mesh(lo_run_chunk, scans, ns, self.cfg, scale)
        else:
            pq, pt, up = self._priors(scans.shape[0])
            self.state, outs = loam_run_chunk(self.state, scans, ns, pq, pt,
                                              up, self.cfg, scale)
        self._outs.append(outs)
        self._after_chunk(scans.shape[0])

    def _run_mesh(self, lo_fn, *args, **kw):
        """Mesh mode: the scanreg + LO chunk, then the mesh mapping chunk;
        assembles the OUT_DIM rows as the reference's (loam_step.py:302-314).
        """
        lo_state, map_state = self.state
        lo_state, lo_out, stacks = lo_fn(lo_state, *args, **kw)
        map_state, mo_out = self._mesh_chunk(map_state, *stacks,
                                             lo_out[:, 7:11],
                                             lo_out[:, 11:14])
        self.state = (lo_state, map_state)
        return torch.cat([lo_out[:, :14], mo_out[:, :7], lo_out[:, 14:16],
                          mo_out[:, 7:8]], dim=1)

    def finish(self) -> np.ndarray:
        """[N, OUT_DIM] packed results (one download)."""
        self._flush()
        self._flush_polar()
        if not self._outs:
            return np.zeros((0, OUT_DIM), np.float32)
        return torch.cat(self._outs).cpu().numpy()


class BatchLoamState(NamedTuple):
    """B concurrent sequences' LOAM state. Per-stream recurrent state is
    stacked ([B, ...] leaves); the map lives in the flat-batched grid
    (batch_mapping.BatchGridMap: the stream axis is folded into the
    hash-bucket axis, so the mapping stage's gathers, sorts and scatters are
    single flat ops over all streams)."""

    corner_last: RingSlab  # xyz [B, S, C, 3]
    surf_last: RingSlab
    q_f2f: torch.Tensor  # [B, 4]
    t_f2f: torch.Tensor  # [B, 3]
    q_w: torch.Tensor  # [B, 4]
    t_w: torch.Tensor  # [B, 3]
    gm: BatchGridMap
    q_wmap_wodom: torch.Tensor  # [B, 4]
    t_wmap_wodom: torch.Tensor  # [B, 3]
    frame_idx: torch.Tensor  # [] int32 (streams advance in lockstep)

    @staticmethod
    def create(cfg, batch: int, device) -> "BatchLoamState":
        sr = cfg.scanreg
        S = cfg.lidar.n_scans

        def slab(cap):
            xyz = RingSlab.empty(S, cap, device).xyz
            return RingSlab(xyz.expand((batch,) + xyz.shape).contiguous())

        def ident():
            return so3.identity_quat(device).expand(batch, 4).contiguous()

        def zeros3():
            return torch.zeros((batch, 3), dtype=torch.float32, device=device)

        return BatchLoamState(
            corner_last=slab(sr.less_sharp_cap // S),
            surf_last=slab(sr.less_flat_cap // S),
            q_f2f=ident(), t_f2f=zeros3(), q_w=ident(), t_w=zeros3(),
            gm=BatchGridMap.create(cfg.mapping, batch, device),
            q_wmap_wodom=ident(), t_wmap_wodom=zeros3(),
            frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        )


def _stack_tree(trees):
    """Matching NamedTuple trees of tensors -> one tree of [B, ...] stacks."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(_stack_tree(list(xs)) for xs in zip(*trees)))


def _stream_of(tree, b: int):
    """Stream b's slice (views) of a tree of [B, ...] tensors."""
    if isinstance(tree, torch.Tensor):
        return tree[b]
    return type(tree)(*(_stream_of(x, b) for x in tree))


def batch_frame_step_feats(state: BatchLoamState, feats, cfg, batch: int):
    """One lockstep frame for B streams from stacked features (a
    ScanFeatures tree of [B, ...] leaves); returns (new_state, out
    [B, OUT_DIM]). Per-stream semantics match loam_frame_step_feats; LO and
    the voxel filters run stream by stream (the reference vmaps them), the
    mapping stage flat-batched (batch_mapping.batch_solve_mapping), and
    eviction is deferred to chunk boundaries (batch_map_evict)."""
    dev = state.q_w.device
    m = cfg.mapping
    initialized = state.frame_idx > 0

    lo, stacks = [], []
    for b in range(batch):
        f = _stream_of(feats, b)
        lo.append(solve_lo(f.sharp, f.flat,
                           _stream_of(state.corner_last, b),
                           _stream_of(state.surf_last, b),
                           state.q_f2f[b], state.t_f2f[b], cfg.lo))
        c_xyz, _, _, c_m = voxel_downsample(
            f.less_sharp.xyz, f.less_sharp.mask, m.line_resolution,
            m.corner_stack_cap)
        s_xyz, _, _, s_m = voxel_downsample(
            f.less_flat.xyz, f.less_flat.mask, m.plane_resolution,
            m.surf_stack_cap)
        stacks.append((c_xyz, c_m, s_xyz, s_m))
    q_s, t_s, n_c, n_s = (torch.stack(x) for x in zip(*lo))
    c_xyz, c_m, s_xyz, s_m = (torch.stack(x) for x in zip(*stacks))

    # frame 0 runs the LO solve too and selects the identity, as
    # loam_frame_step_feats does
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

    gm, q_m, t_m = batch_solve_mapping(state.gm, c_xyz, c_m, s_xyz, s_m,
                                       q_pred, t_pred, m, batch)
    if cfg.lo.mapping_skip_frame == 1:
        mapped = torch.ones((), dtype=torch.bool, device=dev)
    else:
        # streams advance in lockstep, so the skip predicate is scalar; the
        # solve runs anyway and `mapped` selects it (no host read)
        mapped = (state.frame_idx % cfg.lo.mapping_skip_frame) == 0
        gm = _select_tree(mapped, gm, state.gm)
        q_m = torch.where(mapped, q_m, q_pred)
        t_m = torch.where(mapped, t_m, t_pred)

    q_off = so3.quat_normalize(
        so3.quat_multiply(q_m, so3.quat_conjugate(q_w)))
    t_off = t_m - so3.quat_rotate(q_off, t_w)
    q_wmap_wodom = torch.where(mapped, q_off, state.q_wmap_wodom)
    t_wmap_wodom = torch.where(mapped, t_off, state.t_wmap_wodom)

    new_state = BatchLoamState(
        corner_last=feats.less_sharp_slab,
        surf_last=feats.less_flat_slab,
        q_f2f=q, t_f2f=t, q_w=q_w, t_w=t_w,
        gm=gm, q_wmap_wodom=q_wmap_wodom, t_wmap_wodom=t_wmap_wodom,
        frame_idx=state.frame_idx + 1,
    )
    counts = torch.stack([n_c, n_s, mapped.to(n_c.dtype).expand(batch)],
                         dim=1).to(torch.float32)
    out = torch.cat([q, t, q_w, t_w, q_m, t_m, counts],
                    dim=1).to(torch.float32)
    return new_state, out


def _batch_chunk_epilogue(state: BatchLoamState, cfg,
                          batch: int) -> BatchLoamState:
    """Chunk-boundary map maintenance: recenter the streams that crossed a
    cube boundary (see batch_mapping.batch_map_evict)."""
    t_map = state.t_wmap_wodom + so3.quat_rotate(state.q_wmap_wodom,
                                                 state.t_w)
    return state._replace(gm=batch_map_evict(state.gm, t_map, cfg.mapping,
                                             batch))


def loam_run_chunk_batch(states: BatchLoamState, scans: torch.Tensor,
                         n_pts: torch.Tensor, cfg, scale: float = 1.0):
    """Advance B independent sequences x F frames in lockstep.

    scans [B, F, N, 3] float32 or int16 (x scale, dequantized on the
    device); n_pts [B, F]. Returns (states, outs [B, F, OUT_DIM])."""
    scans = _dequantize(scans, scale)
    B = scans.shape[0]
    outs = []
    for f in range(scans.shape[1]):
        feats = _stack_tree([register_scan(scans[b, f], n_pts[b, f],
                                           cfg.lidar, cfg.scanreg)
                             for b in range(B)])
        states, out = batch_frame_step_feats(states, feats, cfg, B)
        outs.append(out)
    return _batch_chunk_epilogue(states, cfg, B), torch.stack(outs, dim=1)


def loam_run_chunk_batch_polar(states: BatchLoamState, ranges: torch.Tensor,
                               dirs: torch.Tensor, cfg, scale: float = 0.005,
                               packed: bool = False):
    """Polar-ingest batch chunk: ranges [B, F, S, A] integer range images
    (or [B, F, S, A//2*3] uint8 pack12 images when `packed`), dirs
    [S, A, 3]. Returns (states, outs [B, F, OUT_DIM])."""
    B = ranges.shape[0]
    outs = []
    for f in range(ranges.shape[1]):
        r_b = unpack12(ranges[:, f]) if packed else ranges[:, f]
        feats = _stack_tree([register_scan_polar(r_b[b], dirs, cfg.lidar,
                                                 cfg.scanreg, scale)
                             for b in range(B)])
        states, out = batch_frame_step_feats(states, feats, cfg, B)
        outs.append(out)
    return _batch_chunk_epilogue(states, cfg, B), torch.stack(outs, dim=1)


def batch_states(cfg, batch: int, device) -> BatchLoamState:
    """B fresh lockstep sequences sharing one flat-batched map."""
    return BatchLoamState.create(cfg, batch, device)


class BatchLoamEngine:
    """Run B sequences concurrently on one device. Frames are pushed per
    stream and a chunk runs once every stream holds `chunk` frames; all
    streams must have equal length (pad short ones with repeated last frames
    and ignore the tail outputs). Outputs stay on the device until
    `finish()`.

    quantize_mm, device and pack12 as in LoamEngine: the card by default,
    and the constructor raises where there is none."""

    def __init__(self, cfg, batch: int, chunk: int = 4,
                 quantize_mm: float = 0.0, pack12: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.chunk = chunk
        self.quantize_mm = quantize_mm
        self.pack12 = pack12
        self.device = engine_device(device)
        self.states = batch_states(cfg, batch, self.device)
        self._outs: list[torch.Tensor] = []
        self._scans: list[list] = [[] for _ in range(batch)]
        self._ns: list[list] = [[] for _ in range(batch)]
        self._polar: list[list] = [[] for _ in range(batch)]
        self._dirs = None
        self._polar_scale = 0.005

    def push_polar(self, stream: int, range_img: np.ndarray,
                   range_scale: float = 0.005,
                   elevations_deg: np.ndarray | None = None):
        """Push one quantized range image [n_scans, n_azimuth] uint16 onto
        `stream` (the smallest upload: 2 bytes/ray)."""
        if any(self._scans):
            raise ValueError("do not mix push() and push_polar()")
        if self._dirs is None:
            self._dirs = _polar_dirs(self.cfg, range_img.shape[1],
                                     elevations_deg, self.device)
        self._polar_scale = range_scale
        self._polar[stream].append(pack12(range_img) if self.pack12
                                   else range_img)
        if all(len(s) >= self.chunk for s in self._polar):
            self._flush_polar()

    def _flush_polar(self):
        f = min(len(s) for s in self._polar)
        if f == 0:
            return
        ranges = _upload_polar(
            np.stack([np.stack(s[:f]) for s in self._polar]), self.device)
        self._polar = [s[f:] for s in self._polar]
        self.states, outs = loam_run_chunk_batch_polar(
            self.states, ranges, self._dirs, self.cfg, self._polar_scale,
            packed=self.pack12)
        self._outs.append(outs)

    def push(self, stream: int, points: np.ndarray):
        """Push one scan [n, 3] float32 (sensor frame) onto `stream`."""
        if any(self._polar):
            raise ValueError("do not mix push() and push_polar()")
        buf, n = stage_scan(points, self.cfg.lidar.max_points,
                            self.quantize_mm)
        self._scans[stream].append(buf)
        self._ns[stream].append(n)
        if all(len(s) >= self.chunk for s in self._scans):
            self._flush()

    def _flush(self):
        f = min(len(s) for s in self._scans)
        if f == 0:
            return
        scans = _upload(np.stack([np.stack(s[:f]) for s in self._scans]),
                        self.device)
        ns = _upload(np.asarray([n[:f] for n in self._ns], np.int64),
                     self.device)
        self._scans = [s[f:] for s in self._scans]
        self._ns = [n[f:] for n in self._ns]
        self.states, outs = loam_run_chunk_batch(
            self.states, scans, ns, self.cfg, self.quantize_mm / 1000.0)
        self._outs.append(outs)

    def finish(self) -> np.ndarray:
        """[B, N, OUT_DIM] packed results (one download)."""
        self._flush()
        self._flush_polar()
        if not self._outs:
            return np.zeros((self.batch, 0, OUT_DIM), np.float32)
        return torch.cat(self._outs, dim=1).cpu().numpy()


def polar_to_xyz_cols(ranges: torch.Tensor, elev_rad, az,
                      scale: float) -> torch.Tensor:
    """Decode a (possibly column-subset) quantized range image [S, A'] with
    explicit per-column azimuths az [A'] into sensor-frame points
    [S*A', 3]; elev_rad and az are tensors or arrays (ray_directions).
    Invalid rays (range 0) decode to the origin."""
    S, A = ranges.shape
    r = ranges.to(torch.float32) * scale  # [S, A]
    dirs = ray_directions(elev_rad, az, ranges.device)
    return (dirs * r[..., None]).reshape(S * A, 3)


def polar_to_xyz(ranges: torch.Tensor, elev_rad,
                 scale: float) -> torch.Tensor:
    """Decode a quantized range image [S, A] (0 = no return) into
    sensor-frame points [S*A, 3], ring-major."""
    return polar_to_xyz_cols(ranges, elev_rad,
                             azimuth_angles(ranges.shape[1]), scale)


def pack12(img: np.ndarray) -> np.ndarray:
    """Host-side: pack a uint16 range image [..., A] with values < 4096
    into 12-bit pairs [..., A//2*3] uint8 (1.5 bytes/ray)."""
    if img.dtype != np.uint16 or img.shape[-1] % 2:
        raise ValueError("pack12 needs a uint16 image with an even width")
    if img.max(initial=0) >= 4096:
        raise ValueError("pack12 needs range/scale < 4096")
    a = img[..., 0::2]
    b = img[..., 1::2]
    out = np.empty(img.shape[:-1] + (img.shape[-1] // 2, 3), np.uint8)
    out[..., 0] = a & 0xFF
    out[..., 1] = (a >> 8) | ((b & 0xF) << 4)
    out[..., 2] = b >> 4
    return out.reshape(img.shape[:-1] + (-1,))


def unpack12(packed: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of pack12: [..., A//2*3] uint8 -> [..., A]
    int32. Bit-exact round trip."""
    lead = packed.shape[:-1]
    trip = packed.reshape(lead + (packed.shape[-1] // 3, 3)).to(torch.int32)
    a = trip[..., 0] | ((trip[..., 1] & 0xF) << 8)
    b = (trip[..., 1] >> 4) | (trip[..., 2] << 4)
    return torch.stack([a, b], dim=-1).reshape(lead + (-1,))


def unpack_outputs(outs: np.ndarray, min_correspondences: int = 10) -> dict:
    """Split packed rows into named f64 arrays; recompose the LO world pose
    in float64 from the f2f increments (vectorized prefix scan). Warns on
    frames whose LO correspondence count fell below min_correspondences
    (reference "less correspondence!", laser_odometry.cpp:452-455)."""
    from ..geometry.np_pose import cumulative_se3

    n = len(outs)
    res = {
        "q_f2f": outs[:, 0:4].astype(np.float64),
        "t_f2f": outs[:, 4:7].astype(np.float64),
        "q_w_lo32": outs[:, 7:11].astype(np.float64),
        "t_w_lo32": outs[:, 11:14].astype(np.float64),
        "q_w_mo": outs[:, 14:18].astype(np.float64),
        "t_w_mo": outs[:, 18:21].astype(np.float64),
        "n_corner": outs[:, 21].astype(int),
        "n_surf": outs[:, 22].astype(int),
        "mapped": outs[:, 23] > 0.5,
    }
    # frame 0 carries no motion (first frame skips the LO solve)
    d_q = res["q_f2f"].copy()
    d_t = res["t_f2f"].copy()
    if n > 0:
        d_q[0] = (0.0, 0.0, 0.0, 1.0)
        d_t[0] = 0.0
    res["q_w_lo"], res["t_w_lo"] = cumulative_se3(d_q, d_t)
    degraded = np.flatnonzero(
        (res["n_corner"] + res["n_surf"] < min_correspondences)
        & (np.arange(n) > 0))
    res["lo_degraded"] = degraded
    if len(degraded):
        import logging

        logging.getLogger("vloam_tpu_torch").warning(
            "less correspondence! LO had < %d constraints on %d frame(s): "
            "%s", min_correspondences, len(degraded),
            degraded[:16].tolist())
    return res
