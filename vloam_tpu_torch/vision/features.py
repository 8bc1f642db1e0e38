"""Keypoint detection, ZNCC descriptors and brute-force matching (port of
vloam_tpu/vision/features.py, the default path; reference image_util.cpp).

- detect_keypoints: Shi-Tomasi min-eigenvalue response (separable Sobel
  shift-adds, box sums by two prefix sums added in XLA's CPU order), border
  mask, quality gate, max-pool NMS, top-k, quadratic subpixel refinement,
- describe_keypoints: zero-normalized p x p patches; on CUDA the
  hand-written kernel K3 (kernels/csrc/zncc_describe.cu), on the CPU its
  plain version zncc_describe_plain,
- match_descriptors: one [K0, K1] similarity product, nearest and second
  nearest per row, ratio test (KNN) or best match (NN),
- clahe: contrast-limited adaptive histogram equalization before detection,
- bucket_nms: at most so many keypoints per image bucket, then a global cap.

Every top-k keeps JAX's tie order (equal scores: lower index first): a
stable sort for the keypoints and for the NMS ranking, an explicit
first-index argmin for the matcher. The other detectors, ORB descriptors and
the FLANN matcher are not ported; their options raise NotImplementedError
(check_vo_options refuses them up front).

Images are float32 [H, W] in [0, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from ..lidar.ring_assoc import first_argmin
from ..lidar.voxel import blocked_cumsum


def check_vo_options(vo) -> None:
    """Raise NotImplementedError for a VO option the port does not run."""
    for name, value in (("detector", "shi_tomasi"), ("descriptor", "zncc"),
                        ("matcher", "bf")):
        if getattr(vo, name) != value:
            raise NotImplementedError(
                f"vo.{name}={getattr(vo, name)!r} is not ported (only "
                f"{value!r})")


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


def clahe(img: torch.Tensor, clip_limit: float = 2.0, tiles: tuple = (8, 8),
          n_bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization (the reference's
    cv::createCLAHE(2.0) preprocessing, visual_odometry.cpp:31,97-100):
    per-tile histograms, clipped and redistributed, CDF lookup tables, and
    a bilinear blend of the 4 surrounding tiles' tables per pixel."""
    h, w = img.shape
    ty, tx = tiles
    th = -(-h // ty)
    tw = -(-w // tx)
    dev = img.device
    pad_img = _edge_pad(_edge_pad(img, 0, 0, ty * th - h), 1, 0, tx * tw - w)
    bins = torch.clamp((pad_img * (n_bins - 1)).to(torch.int64), 0,
                       n_bins - 1)
    tile_r = torch.arange(ty * th, device=dev) // th
    tile_c = torch.arange(tx * tw, device=dev) // tw
    tid = tile_r[:, None] * tx + tile_c[None, :]
    flat_idx = (tid * n_bins + bins).reshape(-1)
    # Every addend is 1.0 and every count stays below 2^24, so the float32
    # sums are exact in any order: the atomics of index_add_ on CUDA give
    # the same histogram on every run.
    hist = torch.zeros(ty * tx * n_bins, dtype=torch.float32,
                       device=dev).index_add_(
        0, flat_idx, torch.ones_like(flat_idx, dtype=torch.float32))
    hist = hist.reshape(ty * tx, n_bins)
    n_pix = th * tw
    clip = clip_limit * n_pix / n_bins
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=1,
                       keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / n_bins
    cdf = blocked_cumsum(hist, 1)
    cdf_min = cdf[:, :1]
    lut = ((cdf - cdf_min) / torch.clamp(n_pix - cdf_min, min=1.0)).reshape(
        ty, tx, n_bins)

    # bilinear interpolation between tile centres
    yy = torch.arange(h, dtype=torch.float32, device=dev)
    xx = torch.arange(w, dtype=torch.float32, device=dev)
    fy = torch.clamp((yy - th / 2.0) / th, 0.0, ty - 1.0)
    fx = torch.clamp((xx - tw / 2.0) / tw, 0.0, tx - 1.0)
    y0 = (torch.clamp(torch.floor(fy).to(torch.int64), 0, ty - 2) if ty > 1
          else torch.zeros_like(fy, dtype=torch.int64))
    x0 = (torch.clamp(torch.floor(fx).to(torch.int64), 0, tx - 2) if tx > 1
          else torch.zeros_like(fx, dtype=torch.int64))
    wy = (fy - y0) if ty > 1 else torch.zeros_like(fy)
    wx = (fx - x0) if tx > 1 else torch.zeros_like(fx)
    b = bins[:h, :w]
    y0g = y0[:, None]
    x0g = x0[None, :]
    y1g = torch.clamp(y0g + 1, max=ty - 1)
    x1g = torch.clamp(x0g + 1, max=tx - 1)
    v00 = lut[y0g, x0g, b]
    v01 = lut[y0g, x1g, b]
    v10 = lut[y1g, x0g, b]
    v11 = lut[y1g, x1g, b]
    wyg = wy[:, None]
    wxg = wx[None, :]
    out = (v00 * (1 - wyg) * (1 - wxg) + v01 * (1 - wyg) * wxg
           + v10 * wyg * (1 - wxg) + v11 * wyg * wxg)
    return torch.clamp(out, 0.0, 1.0)


def bucket_nms(xy: torch.Tensor, score: torch.Tensor, mask: torch.Tensor,
               img_w: int, img_h: int, bucket_w: int = 100,
               bucket_h: int = 100, max_total: int = 400) -> torch.Tensor:
    """Bucketed keypoint NMS (reference keyPointsNMS, image_util.cpp:
    100-150): keep the max_total // n_buckets strongest keypoints of each
    bucket_w x bucket_h cell, then the strongest max_total overall (ties
    at the last kept score all stay). Returns the updated mask."""
    nx = -(-img_w // bucket_w)
    ny = -(-img_h // bucket_h)
    nb = nx * ny
    per_bucket = max(1, max_total // nb)
    bid = ((xy[:, 0] // bucket_w).to(torch.int64)
           + nx * (xy[:, 1] // bucket_h).to(torch.int64))
    bid = torch.where(mask, bid, nb)
    k = xy.shape[0]
    # rank within a bucket by descending score: the reference's lexsort
    # by (bucket, -score) as two stable sorts, the minor key first
    by_score = torch.sort(score, descending=True, stable=True)[1]
    order = by_score[torch.sort(bid[by_score], stable=True)[1]]
    bid_s = bid[order]
    starts = torch.searchsorted(bid_s, torch.arange(nb + 1,
                                                    device=bid.device))
    # the reference looks masked rows (bid_s == nb) up at bucket nb - 1;
    # keep_sorted drops them either way
    rank = (torch.arange(k, device=bid.device)
            - starts[torch.clamp(bid_s, max=nb - 1)])
    keep_sorted = (rank < per_bucket) & (bid_s < nb)
    keep = torch.empty_like(keep_sorted).scatter_(0, order, keep_sorted)
    keep = keep & mask
    # global cap: the max_total-th largest kept score
    s = torch.where(keep, score, -torch.inf)
    kth = torch.topk(s, min(max_total, k)).values[-1]
    return keep & (s >= kth)


def min_eig_response(img: torch.Tensor, block: int) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue of the block-summed structure tensor. The
    three tensor planes go through one box filter as a [3, H, W] stack."""
    gx, gy = _sobel_xy(img)
    a, b, c = _box_filter(torch.stack([gx * gx, gx * gy, gy * gy]),
                          block).unbind(0)
    tr = 0.5 * (a + c)
    det_term = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    return tr - det_term


def detect_keypoints(img: torch.Tensor, cfg):
    """Returns (xy [K, 2] float32 pixel coords (x, y), score [K], mask [K]),
    K = cfg.max_keypoints; unused rows are zero and masked out."""
    if cfg.detector != "shi_tomasi":
        raise NotImplementedError(f"detector={cfg.detector!r} is not ported "
                                  "(only shi_tomasi)")
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
    if cfg.subpixel:
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


def zncc_describe_plain(img: torch.Tensor, xy: torch.Tensor,
                        p: int) -> torch.Tensor:
    """Plain PyTorch K3: per keypoint, the p x p patch at top-left
    (clip(int(y) - p/2, 0, H - p), clip(int(x) - p/2, 0, W - p)) as one
    flat [K, p*p] gather, minus its mean, over its L2 norm; a centred norm
    below 1e-3 gives a zero row (the Pallas kernel's floor)."""
    H, W = img.shape
    offs = torch.arange(p, device=img.device)
    # .to(int64) truncates toward zero, as astype(int32) does
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - p // 2, 0, H - p)
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - p // 2, 0, W - p)
    idx = ((y0[:, None, None] + offs[None, :, None]) * W
           + x0[:, None, None] + offs[None, None, :]).reshape(-1, p * p)
    patch = img.reshape(-1)[idx]
    wp = patch - torch.sum(patch, dim=1, keepdim=True) / (p * p)
    n = torch.sqrt(torch.sum(wp * wp, dim=1, keepdim=True))
    return torch.where(n < 1e-3, 0.0, wp / torch.clamp(n, min=1e-6))


def zncc_describe(img: torch.Tensor, xy: torch.Tensor, p: int):
    """ZNCC descriptors (K3). CPU tensors take zncc_describe_plain; CUDA
    tensors launch kernels/csrc/zncc_describe.cu (or raise — there is no
    fallback)."""
    if img.device.type == "cpu" and xy.device.type == "cpu":
        return zncc_describe_plain(img, xy, p)
    return kernels.zncc_describe(img, xy, p)


def describe_keypoints(img: torch.Tensor, xy: torch.Tensor, cfg):
    """Unit-norm descriptors [K, p*p]; rows are directly matmul-matchable.
    The floor of K3 zeroes near-constant patches; on the engine's path those
    are the masked keypoints parked at (0, 0), which the matcher masks."""
    if cfg.descriptor != "zncc":
        raise NotImplementedError(f"descriptor={cfg.descriptor!r} is not "
                                  "ported (only zncc)")
    return zncc_describe(img, xy, cfg.descriptor_patch)


def similarity(desc0: torch.Tensor, desc1: torch.Tensor) -> torch.Tensor:
    """desc0 @ desc1.T [K0, K1] at least as exact as float32 (the JAX form
    asks for Precision.HIGHEST). The product runs in float64 and is
    rounded to float32: cuBLAS never applies TF32 or reduced-precision
    modes to a double GEMM, so no process-wide matmul flag can change it."""
    return (desc0.to(torch.float64) @ desc1.to(torch.float64).T).to(
        torch.float32)


def match_descriptors(desc0: torch.Tensor, mask0: torch.Tensor,
                      desc1: torch.Tensor, mask1: torch.Tensor,
                      ratio: float = 0.8, matcher: str = "bf",
                      select: str = "knn"):
    """Brute-force matching on one similarity product (matchDescriptors,
    image_util.cpp:214-296): per row the nearest (first index on ties, as
    lax.top_k) and second-nearest descriptor distance; select "knn" keeps
    rows passing the ratio test d1 < ratio * d2, "nn" every masked row with
    a finite match. Returns (idx1 [K0] int64, valid [K0])."""
    if matcher != "bf":
        raise NotImplementedError(f"matcher={matcher!r} is not ported "
                                  "(only bf)")
    sim = similarity(desc0, desc1)
    d = torch.sqrt(torch.clamp(2.0 - 2.0 * sim, min=0.0))
    d = torch.where(mask1[None, :], d, torch.inf)
    i1 = first_argmin(d, 1)
    d1 = torch.amin(d, dim=1)
    col = torch.arange(d.shape[1], device=d.device)
    d2 = torch.amin(torch.where(col[None, :] == i1[:, None], torch.inf, d),
                    dim=1)
    valid = mask0 & torch.isfinite(d1)
    if select != "nn":
        valid = valid & (d1 < ratio * d2)
    return i1, valid
