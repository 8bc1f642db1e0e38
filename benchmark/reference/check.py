"""Follow a run's output rows frame by frame with the plain reference.

The engines carry state from frame to frame: the last frame's features,
the LO pose, the odom -> map offset and the map. The reference works every
frame's result out again from the frame's inputs and the state that the
run's own rows give before it:

- scan registration and both mapping stacks of every frame, from its range
  image;
- at the checked frames, LO from the seed the engine used (the last row's
  f2f, or with a camera the frame's own VO), against the last frame's
  features, and its correspondence counts (row columns 21-22);
- at the checked frames, the scan-to-map solve from the prediction of the
  last row's offset and this row's LO world pose, on a map that the
  reference builds itself: every earlier frame's stacks inserted at that
  frame's map-refined pose from the rows;
- with a camera, at the checked frames, VO between the last and this
  frame's views from the last row's LO f2f (row columns 24-32);
- at every frame, the LO world pose as the last row's world pose times this
  row's f2f (what the checked frames' LO leaves out: the accumulation).

`follow` returns the reference's rows at the checked frames, `compare` the
gaps between two sets of rows: the run's and the reference's, or the
control's (the reference in bfloat16) and the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import frames as F

LEVER_M = 10.0  # a rotation gap counts as the shift of a point this far out
FEATURE_BLOCK = 32  # frames whose rings are selected in one call
Q, T, QW, TW = slice(0, 4), slice(4, 7), slice(7, 11), slice(11, 14)
QM, TM, NC, NS, VO = slice(14, 18), slice(18, 21), 21, 22, slice(24, 33)


def pose_gap(qa, ta, qb, tb) -> np.ndarray:
    """|ta - tb| + LEVER_M x the rotation angle between qa and qb, in
    float64 (metres), over the leading axes."""
    qa, qb = np.asarray(qa, np.float64), np.asarray(qb, np.float64)
    dt = np.linalg.norm(np.asarray(ta, np.float64)
                        - np.asarray(tb, np.float64), axis=-1)
    qa = qa / np.linalg.norm(qa, axis=-1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=-1, keepdims=True)
    # angle of qa^-1 qb: 2 atan2(|vector part|, |scalar part|)
    w = np.sum(qa * qb, axis=-1)
    v = np.linalg.norm(qa[..., 3:4] * qb[..., :3] - qb[..., 3:4] * qa[..., :3]
                       - np.cross(qa[..., :3], qb[..., :3]), axis=-1)
    return dt + LEVER_M * 2.0 * np.arctan2(v, np.abs(w))


def world_chain(rows: np.ndarray, device,
                precision: str = "float32") -> np.ndarray:
    """The LO world poses [N - 1, 7] of frames 1.. as the last row's world
    pose times this row's f2f, the rows' poses held in `precision`."""
    r = F.held(torch.as_tensor(rows, dtype=torch.float32, device=device),
               precision)
    q, t = F.compose(r[:-1, QW], r[:-1, TW], r[1:, Q], r[1:, T])
    return torch.cat([q, t], dim=1).cpu().numpy()


def world_chain_gap(rows: np.ndarray, device) -> float:
    """The largest gap between a row's LO world pose and world_chain's,
    over every frame after the first."""
    if rows.shape[0] < 2:
        return 0.0
    w = world_chain(rows, device)
    return float(np.max(pose_gap(rows[1:, QW], rows[1:, TW], w[:, :4],
                                 w[:, 4:])))


def follow(rows: np.ndarray, range_image, cfg, sensor: F.Sensor,
           scale: float, checked, device, precision: str = "float32",
           camera: F.Camera | None = None, image=None, visit=None,
           streams: int = 0):
    """The reference's rows at the frames `checked` (sorted indices into
    rows), following rows [N, D] from frame 0. range_image(k) / image(k):
    frame k's range image [S, A] uint16 / camera image [H, W] uint8 (numpy).
    With `camera`, the combined engine's frame (VO seeds LO unless
    cfg.detach_VO_LO). visit(k, ctx), if given, is called at every frame
    up to the last checked one with the frame's reference state (the
    roofline's counts read it). streams > 0: the rows are one stream of
    the lockstep engine with that many streams, whose map stores its points
    in fixed point. Returns {k: reference row [D] float32, NaN where the
    reference computes nothing}."""
    if cfg.lo.mapping_skip_frame != 1:
        raise ValueError("the reference follows engines that map every frame")
    checked = sorted(set(int(k) for k in checked))
    last = checked[-1]
    r = torch.as_tensor(rows[:last + 1], dtype=torch.float32, device=device)
    dev = torch.device(device)
    gmap = F.new_map(cfg, dev)
    last_slabs = F.empty_features(cfg, dev)
    q_off = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    t_off = torch.zeros(3, device=dev)
    prev_view = None
    out = {}
    block: list = []
    with torch.no_grad():
        for k in range(last + 1):
            r_img = torch.as_tensor(range_image(k).astype(np.int32),
                                    device=dev)
            if not block:  # the next FEATURE_BLOCK frames' features
                imgs = torch.stack([torch.as_tensor(
                    range_image(j).astype(np.int32), device=dev)
                    for j in range(k, min(k + FEATURE_BLOCK, last + 1))])
                block = F.lidar_features(imgs, sensor, cfg, scale, precision)
            feats = block.pop(0)
            stacks = F.map_stacks(feats, cfg)
            need_view = camera is not None and (k in checked
                                                or k + 1 in checked)
            view = (F.camera_view(torch.as_tensor(image(k), device=dev),
                                  r_img, sensor, camera, cfg, scale,
                                  precision) if need_view else None)
            if k in checked:
                ref = torch.full((rows.shape[1],), float("nan"), device=dev)
                q0, t0 = (r[k - 1, Q], r[k - 1, T]) if k else (
                    q_off, t_off)
                if camera is not None:
                    q_pr, t_pr, vo_ok, vo_row = F.vo_solve(
                        prev_view if k else view, view, q0, t0, k > 0,
                        camera, cfg)
                    ref[VO] = vo_row
                    if not cfg.detach_VO_LO:
                        q0 = torch.where(vo_ok, q_pr, q0)
                        t0 = torch.where(vo_ok, t_pr, t0)
                q, t, n_c, n_s = F.lo_f2f(feats, last_slabs, q0, t0, k > 0,
                                          cfg)
                ref[Q], ref[T] = q, t
                ref[NC], ref[NS] = n_c.to(torch.float32), n_s.to(
                    torch.float32)
                q_pred, t_pred = F.compose(q_off, t_off, r[k, QW], r[k, TW])
                ref[QM], ref[TM] = F.mo_refine(gmap, stacks, q_pred, t_pred,
                                               cfg)
                out[k] = ref.cpu().numpy()
            before = gmap
            gmap = F.map_insert(gmap, stacks, r[k, QM], r[k, TM], cfg,
                                streams)
            if visit is not None:
                visit(k, dict(feats=feats, stacks=stacks, map_before=before,
                              map_after=gmap, last_slabs=last_slabs,
                              q_off=q_off, t_off=t_off, row=r[k]))
            q_off, t_off = F.map_offset(r[k, QM], r[k, TM], r[k, QW],
                                        r[k, TW])
            last_slabs = (feats.less_sharp_slab, feats.less_flat_slab)
            prev_view = view
    return out


def lo_at(rows: np.ndarray, range_image, cfg, sensor: F.Sensor,
          scale: float, k: int, device, precision: str = "float32"):
    """The reference's row at frame k >= 1 of a LiDAR-only engine with LO
    alone: frame k's LO from the last row's f2f against frame k - 1's
    features (no map; the other columns NaN). {k: row}."""
    dev = torch.device(device)
    r = torch.as_tensor(rows[k - 1], dtype=torch.float32, device=dev)
    imgs = torch.stack([torch.as_tensor(range_image(j).astype(np.int32),
                                        device=dev) for j in (k - 1, k)])
    with torch.no_grad():
        last, feats = F.lidar_features(imgs, sensor, cfg, scale, precision)
        q, t, n_c, n_s = F.lo_f2f(feats, (last.less_sharp_slab,
                                          last.less_flat_slab),
                                  r[Q], r[T], True, cfg)
    ref = np.full(rows.shape[1], np.nan, np.float32)
    ref[Q], ref[T] = q.cpu().numpy(), t.cpu().numpy()
    ref[NC], ref[NS] = float(n_c), float(n_s)
    return {k: ref}


def compare(rows: dict, ref: dict, camera: bool,
            per_frame: bool = False) -> dict:
    """The gaps between rows[k] and ref[k] (rows of the same layout) at the
    frames of `ref`: LO f2f, LO correspondence counts (a share of the
    reference's), MO, and with a camera VO and its match counts. The
    largest of each over the frames, or with per_frame each frame's (in
    sorted frame order; NaN where the reference computed none of that
    number). A NaN or infinite value in rows gives an infinite gap."""
    ks = sorted(ref)
    a = np.stack([rows[k] for k in ks]).astype(np.float64)
    b = np.stack([ref[k] for k in ks]).astype(np.float64)

    def count_gap(cols):
        da = np.abs(a[:, cols] - b[:, cols]).sum(axis=1)
        return da / np.maximum(b[:, cols].sum(axis=1), 1.0)

    def pose(c):
        return pose_gap(a[:, c:c + 4], a[:, c + 4:c + 7], b[:, c:c + 4],
                        b[:, c + 4:c + 7])

    gaps = {"lo_pose_gap_m": (pose(Q.start), slice(0, 7)),
            "lo_corr_gap": (count_gap([NC, NS]), slice(NC, NS + 1)),
            "mo_pose_gap_m": (pose(QM.start), slice(QM.start, TM.stop))}
    if camera:
        v = VO.start
        gaps["vo_pose_gap_m"] = (pose(v), slice(v, v + 7))
        gaps["vo_match_gap"] = (count_gap([v + 7, v + 8]),
                                slice(v + 7, v + 9))
    out = {}
    for name, (g, cols) in gaps.items():
        done = np.isfinite(b[:, cols]).all(axis=1)
        out[name] = np.where(done, np.where(np.isfinite(g), g, np.inf),
                             np.nan)
    if per_frame:
        return out
    return {k: float(np.nanmax(g)) for k, g in out.items()}
