"""Keypoint detection, descriptors and matching (port of
vloam_tpu/vision/features.py; reference image_util.cpp), on the one path
the engines' VO runs: Shi-Tomasi keypoints, ZNCC descriptors, a brute-force
matcher with the ratio test (frames._check_vo_options refuses the others).

- detect_keypoints: the Shi-Tomasi response (min_eig_response: Sobel
  gradients as separable shift-adds, box sums by two prefix sums added in
  XLA's CPU order), then border mask, quality gate, max-pool NMS, top-k and
  quadratic subpixel refinement,
- describe_keypoints: zero-normalized p x p patches (zncc_describe),
- match_descriptors: one [K0, K1] similarity product, nearest and second
  nearest per row, ratio test.

Every top-k keeps JAX's tie order (equal scores: lower index first): a
stable sort for the keypoints, an explicit first-index argmin for the
matcher.

Images are float32 [H, W] in [0, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..lidar.ring_assoc import first_argmin
from ..lidar.voxel import blocked_cumsum, reciprocal_f32


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img shifted so out[y, x] = img[y+dy, x+dx], zero-padded."""
    h, w = img.shape
    out = img
    if dy:
        z = img.new_zeros((abs(dy), w))
        out = (torch.cat([out[dy:], z]) if dy > 0
               else torch.cat([z, out[:dy]]))
    if dx:
        z = img.new_zeros((h, abs(dx)))
        out = (torch.cat([out[:, dx:], z], dim=1) if dx > 0
               else torch.cat([z, out[:, :dx]], dim=1))
    return out


def _sobel_xy(img: torch.Tensor):
    """Both Sobel gradients (kernels / 8) by separable shift-adds, zero
    boundaries: smooth [1, 2, 1] along one axis, central difference along
    the other."""
    sy = _shift(img, -1, 0) + 2.0 * img + _shift(img, 1, 0)
    sx = _shift(img, 0, -1) + 2.0 * img + _shift(img, 0, 1)
    gx = (_shift(sy, 0, -1) - _shift(sy, 0, 1)) / 8.0
    gy = (_shift(sx, -1, 0) - _shift(sx, 1, 0)) / 8.0
    return gx, gy


def _edge_pad(x: torch.Tensor, dim: int, before: int, after: int):
    """Replicate the first / last slice along `dim`."""
    n = x.shape[dim]
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1)
    shape = list(x.shape)
    shape[dim] = before
    pre = first.expand(shape)
    shape[dim] = after
    return torch.cat([pre, x, last.expand(shape)], dim=dim)


def _box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """Unnormalized size x size box sum over the last two axes (edge
    padding) by two prefix-sum passes, added in XLA's CPU order."""
    pad = size // 2
    cs = blocked_cumsum(_edge_pad(img, -1, pad + 1, pad), img.dim() - 1)
    h = cs[..., size:] - cs[..., :-size]
    cs2 = blocked_cumsum(_edge_pad(h, -2, pad + 1, pad), img.dim() - 2)
    return cs2[..., size:, :] - cs2[..., :-size, :]


def _structure_tensor(img: torch.Tensor, block: int):
    """The block-summed structure tensor's planes (sum gx^2, sum gx gy,
    sum gy^2), through one box filter as a [3, H, W] stack."""
    gx, gy = _sobel_xy(img)
    return _box_filter(torch.stack([gx * gx, gx * gy, gy * gy]),
                       block).unbind(0)


def min_eig_response(img: torch.Tensor, block: int) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue of the block-summed structure tensor."""
    a, b, c = _structure_tensor(img, block)
    tr = 0.5 * (a + c)
    det_term = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    return tr - det_term


def detect_keypoints(img: torch.Tensor, cfg):
    """Returns (xy [K, 2] float32 pixel coords (x, y), score [K], mask [K]),
    K = cfg.max_keypoints; unused rows are zero and masked out."""
    resp = min_eig_response(img, cfg.shi_tomasi_block)
    h, w = resp.shape
    dev = resp.device
    # exclude borders (gradient + descriptor support)
    m = cfg.descriptor_patch
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    interior = (yy >= m) & (yy < h - m) & (xx >= m) & (xx < w - m)
    resp = torch.where(interior, resp, -torch.inf)

    # quality gate relative to the global max (goodFeaturesToTrack)
    thr = cfg.shi_tomasi_quality * torch.amax(resp)

    # min-distance NMS: a peak is the max of its (2r+1)^2 window,
    # r = ceil(min_distance); max_pool2d pads with -inf like reduce_window
    r = int(-(-cfg.shi_tomasi_min_distance // 1))
    pooled = F.max_pool2d(resp[None, None], 2 * r + 1, stride=1,
                          padding=r)[0, 0]
    is_peak = (resp >= pooled) & (resp > thr) & torch.isfinite(resp)

    flat = torch.where(is_peak.reshape(-1), resp.reshape(-1), -torch.inf)
    # top-k by a stable descending sort: equal scores keep the lower index
    score, idx = torch.sort(flat, descending=True, stable=True)
    score = score[:cfg.max_keypoints]
    idx = idx[:cfg.max_keypoints]
    iy = torch.div(idx, w, rounding_mode="floor")
    ix = idx - iy * w
    mask = torch.isfinite(score)
    xy = torch.stack([ix.to(torch.float32), iy.to(torch.float32)], dim=-1)
    # quadratic peak interpolation on the response surface
    rs = torch.where(torch.isfinite(resp), resp, 0.0)

    def at(dy, dx):
        return rs[torch.clamp(iy + dy, 0, h - 1),
                  torch.clamp(ix + dx, 0, w - 1)]

    gx = 0.5 * (at(0, 1) - at(0, -1))
    gy = 0.5 * (at(1, 0) - at(-1, 0))
    hxx = at(0, 1) - 2.0 * at(0, 0) + at(0, -1)
    hyy = at(1, 0) - 2.0 * at(0, 0) + at(-1, 0)
    hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
    det = hxx * hyy - hxy * hxy
    solvable = torch.abs(det) > 1e-12
    ox = torch.where(solvable, -(hyy * gx - hxy * gy) / det, 0.0)
    oy = torch.where(solvable, -(hxx * gy - hxy * gx) / det, 0.0)
    xy = xy + torch.clamp(torch.stack([ox, oy], dim=-1), -0.5, 0.5)
    return (torch.where(mask[:, None], xy, 0.0),
            torch.where(mask, score, 0.0), mask)


def zncc_describe(img: torch.Tensor, xy: torch.Tensor,
                  p: int) -> torch.Tensor:
    """ZNCC descriptors [K, p*p], unit rows: per keypoint, the p x p patch at
    top-left (clip(int(y) - p/2, 0, H - p), clip(int(x) - p/2, 0, W - p)) as
    one flat [K, p*p] gather, minus its mean, over its L2 norm; a centred norm
    below 1e-3 gives a zero row (the engines' floor, which zeroes the masked
    keypoints parked at (0, 0); the matcher masks them)."""
    H, W = img.shape
    offs = torch.arange(p, device=img.device)
    # .to(int64) truncates toward zero, as astype(int32) does
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - p // 2, 0, H - p)
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - p // 2, 0, W - p)
    idx = ((y0[:, None, None] + offs[None, :, None]) * W
           + x0[:, None, None] + offs[None, None, :]).reshape(-1, p * p)
    patch = img.reshape(-1)[idx]
    wp = patch - torch.sum(patch, dim=1, keepdim=True) * reciprocal_f32(p * p)
    n = torch.sqrt(torch.sum(wp * wp, dim=1, keepdim=True))
    return torch.where(n < 1e-3, 0.0, wp / torch.clamp(n, min=1e-6))


def similarity(desc0: torch.Tensor, desc1: torch.Tensor) -> torch.Tensor:
    """desc0 @ desc1.T [K0, K1] at least as exact as float32 (the JAX form
    asks for Precision.HIGHEST). The product runs in float64 and is
    rounded to float32: cuBLAS never applies TF32 or reduced-precision
    modes to a double GEMM, so no process-wide matmul flag can change it."""
    return (desc0.to(torch.float64) @ desc1.to(torch.float64).T).to(
        torch.float32)


def match_descriptors(desc0: torch.Tensor, mask0: torch.Tensor,
                      desc1: torch.Tensor, mask1: torch.Tensor,
                      ratio: float = 0.8):
    """Brute-force matching on one similarity product (matchDescriptors,
    image_util.cpp:214-296): per row the nearest (first index on ties, as
    lax.top_k) and second-nearest descriptor distance; rows passing the
    ratio test d1 < ratio * d2 are valid. Returns (idx1 [K0] int64,
    valid [K0])."""
    sim = similarity(desc0, desc1)
    d = torch.sqrt(torch.clamp(2.0 - 2.0 * sim, min=0.0))
    d = torch.where(mask1[None, :], d, torch.inf)
    i1 = first_argmin(d, 1)
    d1 = torch.amin(d, dim=1)
    col = torch.arange(d.shape[1], device=d.device)
    d2 = torch.amin(torch.where(col[None, :] == i1[:, None], torch.inf, d),
                    dim=1)
    valid = mask0 & torch.isfinite(d1) & (d1 < ratio * d2)
    return i1, valid
