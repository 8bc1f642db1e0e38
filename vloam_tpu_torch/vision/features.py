"""Keypoint detection, descriptors and matching (port of
vloam_tpu/vision/features.py; reference image_util.cpp).

- detect_keypoints: a response map, then border mask, quality gate,
  max-pool NMS, top-k and quadratic subpixel refinement. The response is
  cfg.detector's, dispatched as the reference's if chain:
    fast  -> fast_response (contiguous-arc test over the 16-pixel circle),
    orb   -> the FAST gate scored by harris_response (cv::ORB HARRIS_SCORE),
    brisk -> multiscale_fast_response (FAST over a mean-pooled pyramid),
    sift  -> dog_response (difference-of-Gaussians scale-space extrema),
    akaze -> hessian_response (scale-normalized determinant of Hessian),
    any other name -> min_eig_response (Shi-Tomasi, the default),
  with Sobel gradients as separable shift-adds, box sums by two prefix sums
  added in XLA's CPU order and Gaussian blurs as separable shift-add taps,
- describe_keypoints: cfg.descriptor "orb" -> orb_describe (oriented
  BRIEF-256, bits as +-1/16), otherwise zero-normalized p x p patches: on
  CUDA the hand-written kernel K3 (kernels/csrc/zncc_describe.cu), on the
  CPU its plain version zncc_describe_plain,
- match_descriptors: one [K0, K1] similarity product, nearest and second
  nearest per row, ratio test (KNN) or best match (NN); "flann" is the
  same exact search (the reference's approx_max_k is exact on the CPU),
- clahe: contrast-limited adaptive histogram equalization before detection,
- bucket_nms: at most so many keypoints per image bucket, then a global cap.

Every top-k keeps JAX's tie order (equal scores: lower index first): a
stable sort for the keypoints and for the NMS ranking, an explicit
first-index argmin for the matcher. Sums whose order decides a discrete
outcome add in a fixed order on every device (the FAST excess in circle
order, the blur taps in tap order), never through a reduction kernel.

Images are float32 [H, W] in [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..lidar.ring_assoc import first_argmin
from ..lidar.voxel import blocked_cumsum, reciprocal_f32
from .optical_flow import mean_pool2


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
    fy = torch.clamp((yy - th / 2.0) * reciprocal_f32(th), 0.0, ty - 1.0)
    fx = torch.clamp((xx - tw / 2.0) * reciprocal_f32(tw), 0.0, tx - 1.0)
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


def harris_response(img: torch.Tensor, block: int,
                    k: float = 0.04) -> torch.Tensor:
    """Harris corner measure det(M) - k tr(M)^2 of the block-summed
    structure tensor (cv::ORB HARRIS_SCORE), rounded as the reference's
    compiled CPU code rounds it: XLA contracts both subtractions into fused
    multiply-adds, fma(-k, (a + c)^2, fma(a, c, -b*b)). Each is emulated in
    float64, where the float32 products are exact."""
    a, b, c = _structure_tensor(img, block)
    f64 = torch.float64
    det = (a.to(f64) * c.to(f64) - (b * b).to(f64)).to(torch.float32)
    tr2 = (a + c) ** 2
    k32 = float(np.float32(k))  # the reference's weak-typed k, as float32
    return (det.to(f64) - k32 * tr2.to(f64)).to(torch.float32)


def _gauss_kernel_1d(sigma: float) -> np.ndarray:
    """The reference's float32 taps, radius max(1, int(3 sigma + 0.5))."""
    r = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _taps(img: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    """Convolution of img with the symmetric taps k along `dim`, zero
    boundaries, 'same' size: each tap a product of a shifted view, added in
    tap order (the same rounding on every device; no convolution kernel,
    so no TF32 mode can reach it)."""
    r = len(k) // 2
    n = img.shape[dim]
    pad = (r, r, 0, 0) if dim == 1 else (0, 0, r, r)
    p = F.pad(img, pad)
    out = None
    for j, kj in enumerate(k.tolist()):
        term = kj * p.narrow(dim, j, n)
        out = term if out is None else out + term
    return out


def gauss_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur (radius 3 sigma), rows then columns."""
    k = _gauss_kernel_1d(sigma)
    return _taps(_taps(img, k, 1), k, 0)


def dog_response(img: torch.Tensor, base_sigma: float = 1.6,
                 n_scales: int = 4) -> torch.Tensor:
    """SIFT-style difference-of-Gaussians response (reference SIFT
    DetectorType, image_util.cpp:60-63): |DoG| where it is a 3 x 3 spatial
    maximum and at least its neighbouring scales', maxed over scales."""
    sigmas = [base_sigma * (2.0 ** (i / 2.0)) for i in range(n_scales)]
    blurs = [gauss_blur(img, s) for s in sigmas]
    mag = torch.abs(torch.stack([blurs[i + 1] - blurs[i]
                                 for i in range(n_scales - 1)]))
    # max_pool2d pads with -inf like reduce_window
    spatial_peak = mag >= F.max_pool2d(mag, 3, stride=1, padding=1)
    ninf = torch.full_like(mag[:1], -torch.inf)
    lo = torch.cat([ninf, mag[:-1]])
    hi = torch.cat([mag[1:], ninf])
    scale_peak = (mag >= lo) & (mag >= hi)
    return torch.amax(torch.where(spatial_peak & scale_peak, mag, 0.0), dim=0)


def hessian_response(img: torch.Tensor,
                     sigmas: tuple = (1.6, 3.2, 6.4)) -> torch.Tensor:
    """Scale-normalized determinant of Hessian, maxed over Gaussian scales
    (the blob measure AKAZE thresholds; reference image_util.cpp:56-59)."""
    out = None
    for s in sigmas:
        lx, ly = _sobel_xy(gauss_blur(img, s))
        lxx, lxy = _sobel_xy(lx)
        _, lyy = _sobel_xy(ly)
        det = (s * s) ** 2 * (lxx * lyy - lxy * lxy)
        out = det if out is None else torch.maximum(out, det)
    return out


# FAST-16 Bresenham circle offsets (dy, dx)
_FAST_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_response(img: torch.Tensor, threshold: float,
                  arc: int = 9) -> torch.Tensor:
    """FAST corner response (image_util.cpp:37-40): a corner has >= `arc`
    contiguous circle pixels all brighter or all darker than the centre by
    `threshold` (edge-padded image); its response is the summed excess
    |ring - centre| - threshold over the circle pixels past the threshold,
    added in circle order one add at a time (XLA's CPU sum over the circle
    axis adds so, bit for bit)."""
    h, w = img.shape
    pads = _edge_pad(_edge_pad(img, 0, 3, 3), 1, 3, 3)
    ring = torch.stack([pads[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dy, dx in _FAST_CIRCLE])  # [16, H, W]
    brighter = ring > img + threshold
    darker = ring < img - threshold

    def has_arc(mask):
        # a circular run of `arc`: the OR over the 16 starts of the AND of
        # `arc` consecutive circle pixels
        doubled = torch.cat([mask, mask])
        out = torch.zeros_like(mask[0])
        for s in range(16):
            out = out | torch.all(doubled[s:s + arc], dim=0)
        return out

    is_corner = has_arc(brighter) | has_arc(darker)
    terms = torch.where(brighter | darker, torch.abs(ring - img) - threshold,
                        0.0)
    excess = torch.zeros_like(img)
    for term in terms:
        excess = excess + term
    return torch.where(is_corner, excess, 0.0)


def multiscale_fast_response(img: torch.Tensor, threshold: float,
                             n_levels: int = 3) -> torch.Tensor:
    """BRISK stand-in (reference image_util.cpp:48-51): FAST over a
    mean-pooled pyramid; coarse responses are nearest-upsampled, cropped or
    zero-padded (bottom, right) to full size and maxed, so keypoint
    coordinates stay full-resolution."""
    h, w = img.shape
    resp = fast_response(img, threshold)
    level = img
    for lvl in range(1, n_levels):
        level = mean_pool2(level)
        f = 2 ** lvl
        up = fast_response(level, threshold).repeat_interleave(
            f, dim=0).repeat_interleave(f, dim=1)[:h, :w]
        up = F.pad(up, (0, w - up.shape[1], 0, h - up.shape[0]))
        resp = torch.maximum(resp, up)
    return resp


def detector_response(img: torch.Tensor, cfg) -> torch.Tensor:
    """cfg.detector's response map, dispatched as the reference's if chain
    (features.py:310-321): names it does not list get Shi-Tomasi."""
    if cfg.detector == "fast":
        return fast_response(img, cfg.fast_threshold)
    if cfg.detector == "orb":
        # cv::ORB: FAST candidates ranked by the Harris measure (:41-47)
        gate = fast_response(img, cfg.fast_threshold) > 0.0
        return torch.where(gate, harris_response(img, cfg.shi_tomasi_block),
                           0.0)
    if cfg.detector == "brisk":
        return multiscale_fast_response(img, cfg.fast_threshold)
    if cfg.detector == "sift":
        return dog_response(img)
    if cfg.detector == "akaze":
        return hessian_response(img)
    return min_eig_response(img, cfg.shi_tomasi_block)


def detect_keypoints(img: torch.Tensor, cfg):
    """Returns (xy [K, 2] float32 pixel coords (x, y), score [K], mask [K]),
    K = cfg.max_keypoints; unused rows are zero and masked out."""
    resp = detector_response(img, cfg)
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
    wp = patch - torch.sum(patch, dim=1, keepdim=True) * reciprocal_f32(p * p)
    n = torch.sqrt(torch.sum(wp * wp, dim=1, keepdim=True))
    return torch.where(n < 1e-3, 0.0, wp / torch.clamp(n, min=1e-6))


def zncc_describe(img: torch.Tensor, xy: torch.Tensor, p: int):
    """ZNCC descriptors (K3). CPU tensors take zncc_describe_plain; CUDA
    tensors launch kernels/csrc/zncc_describe.cu (or raise — there is no
    fallback)."""
    if img.device.type == "cpu" and xy.device.type == "cpu":
        return zncc_describe_plain(img, xy, p)
    return kernels.zncc_describe(img, xy, p)


# ---- oriented BRIEF (the reference's ORB descriptor, image_util.cpp:166) --

_ORB_PATCH = 31  # cv::ORB patch size


def _brief_pairs(n_bits: int, patch: int):
    """Static BRIEF sampling pattern: Gaussian(0, patch/5) point pairs (the
    distribution cv::ORB's learned pattern was trained from), drawn from the
    reference's generator and seed, so the pairs are its own. Returns two
    float32 [n_bits, 2] (x, y) arrays."""
    rng = np.random.default_rng(0x16833)
    lim = patch // 2 - 1
    pts = np.clip(rng.normal(0.0, patch / 5.0, (2, n_bits, 2)),
                  -lim, lim).astype(np.float32)
    return pts[0], pts[1]


def _ic_angle_grids(patch: int):
    """x and y offsets over the patch, zero outside the radius patch // 2
    disc (cv::ORB IC_Angle's moments)."""
    r = patch // 2
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1].astype(np.float32)
    circ = (xs * xs + ys * ys <= r * r).astype(np.float32)
    return xs * circ, ys * circ


_ORB_TABLES: dict = {}


def _orb_tables(n_bits: int, device) -> tuple:
    """(pairs a, pairs b, moment grids x, y) on `device`, uploaded once per
    device and bit count: a frame loop never copies them (a copy from host
    memory would wait on the device)."""
    key = (n_bits, str(device))
    if key not in _ORB_TABLES:
        _ORB_TABLES[key] = tuple(
            torch.from_numpy(a).to(device)
            for a in (*_brief_pairs(n_bits, _ORB_PATCH),
                      *_ic_angle_grids(_ORB_PATCH)))
    return _ORB_TABLES[key]


def orb_describe(img: torch.Tensor, xy: torch.Tensor, n_bits: int = 256):
    """Oriented BRIEF (rBRIEF) [K, n_bits]: per keypoint, the 31 x 31 patch
    at (int(x) - 15, int(y) - 15), its start clamped into the image as
    dynamic_slice clamps it (masked keypoints parked at (0, 0) take the
    top-left patch); the intensity-centroid orientation over its radius-15
    disc (cv::ORB IC_Angle); the BRIEF pairs rotated by it, rounded half to
    even and clipped to the patch; each bit I(a) > I(b) stored as
    +-1/sqrt(n_bits). For unit rows sim = 1 - 2 ham / n_bits, so the
    matcher's similarity product ranks as Hamming distance does
    (image_util.cpp:237 BFMatcher(NORM_HAMMING))."""
    p = _ORB_PATCH
    half = p // 2
    H, W = img.shape
    ax, ay, gx, gy = _orb_tables(n_bits, img.device)
    offs = torch.arange(p, device=img.device)
    # .to(int64) truncates toward zero, as astype(int32) does
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - half, 0, W - p)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - half, 0, H - p)
    idx = ((y0[:, None, None] + offs[None, :, None]) * W
           + x0[:, None, None] + offs[None, None, :])
    patch = img.reshape(-1)[idx]  # [K, p, p]
    m10 = torch.sum(patch * gx, dim=(1, 2))
    m01 = torch.sum(patch * gy, dim=(1, 2))
    theta = torch.atan2(m01, m10)
    c = torch.cos(theta)[:, None]
    s = torch.sin(theta)[:, None]
    flat = patch.reshape(patch.shape[0], -1)

    def sample(pairs):  # [n_bits, 2] (x, y) -> [K, n_bits] intensities
        rx = c * pairs[:, 0] - s * pairs[:, 1]
        ry = s * pairs[:, 0] + c * pairs[:, 1]
        # torch.round rounds half to even, as jnp.round
        ix = torch.clamp(torch.round(rx).to(torch.int64) + half, 0, p - 1)
        iy = torch.clamp(torch.round(ry).to(torch.int64) + half, 0, p - 1)
        return torch.take_along_dim(flat, iy * p + ix, dim=1)

    scale = 1.0 / float(np.sqrt(n_bits))
    return torch.where(sample(ax) > sample(ay), scale, -scale)


def descriptor_dim(cfg) -> int:
    """Width of describe_keypoints' rows under cfg. (The reference's engine
    state holds [K, p*p] for either descriptor, so its ORB runs only where
    p*p is 256; the port sizes the state by this.)"""
    return 256 if cfg.descriptor == "orb" else cfg.descriptor_patch ** 2


def describe_keypoints(img: torch.Tensor, xy: torch.Tensor, cfg):
    """Unit-norm descriptors; rows are directly matmul-matchable.
    descriptor "orb": orb_describe [K, 256]; otherwise ZNCC [K, p*p]. The
    floor of K3 zeroes near-constant patches; on the engine's path those
    are the masked keypoints parked at (0, 0), which the matcher masks."""
    if cfg.descriptor == "orb":
        return orb_describe(img, xy)
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
    """Matching on one similarity product (matchDescriptors,
    image_util.cpp:214-296): per row the nearest (first index on ties, as
    lax.top_k) and second-nearest descriptor distance; select "knn" keeps
    rows passing the ratio test d1 < ratio * d2, "nn" every masked row with
    a finite match. matcher "bf" (BFMatcher) and "flann" run the same exact
    search: the reference's FLANN analogue, lax.approx_max_k, is an exact
    top-k on the CPU. Returns (idx1 [K0] int64, valid [K0])."""
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
