"""Pyramidal Lucas-Kanade optical flow, batched over keypoints (port of
vloam_tpu/vision/optical_flow.py; reference image_util.cpp:351-372,
cv::calcOpticalFlowPyrLK with window 15 x 15, maxLevel 2, 10 iterations).

Each keypoint's window is one row of a [K, win^2] tensor of sample
coordinates, sampled by a four-tap bilinear gather; the per-keypoint
iteration is a Python loop of cfg.flow_iterations over all keypoints at
once. Gradients are taken on the first image (classic KLT), so the 2 x 2
system is built once per level. Nothing is read back to the host: the
fused engine calls this inside its frame loop.
"""

from __future__ import annotations

import torch


def _bilinear(img: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """Sample img [H, W] at float coords (x, y) of any one shape; the
    top-left tap is clipped to [0, W-2] x [0, H-2] and the weights to
    [0, 1] (outside the image the border pixels are extended)."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    flat = img.reshape(-1)
    base = y0 * w + x0
    i00 = flat[base]
    i01 = flat[base + 1]
    i10 = flat[base + w]
    i11 = flat[base + w + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def mean_pool2(img: torch.Tensor) -> torch.Tensor:
    """2 x 2 average pooling (an odd last row or column is dropped). Each
    block is summed row by row, left to right, as XLA's CPU reduce adds it
    for outputs wider than 32 pixels, so such outputs are bit-identical to
    the reference's `.mean(axis=(1, 3))` (at 32 or fewer XLA adds the two
    rows' pairs first, and the last bit may differ)."""
    h, w = img.shape
    b = img[:h // 2 * 2, :w // 2 * 2].reshape(h // 2, 2, w // 2, 2)
    return (((b[:, 0, :, 0] + b[:, 0, :, 1]) + b[:, 1, :, 0])
            + b[:, 1, :, 1]) / 4.0


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Pyramid by 2 x 2 average pooling per level (mean_pool2)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(mean_pool2(pyr[-1]))
    return pyr


def lk_flow(img0: torch.Tensor, img1: torch.Tensor, xy0: torch.Tensor, cfg):
    """Track keypoints xy0 [K, 2] of img0 into img1 (both [H, W] float32).
    Returns (xy1 [K, 2], status [K] bool): status is false where a level's
    structure tensor is singular (det <= 1e-6) or the track ends within the
    window's half-width of the finest level's border."""
    levels = cfg.flow_levels
    r = cfg.flow_window // 2
    offs = torch.arange(cfg.flow_window, device=xy0.device) - r
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    ox = ox.to(torch.float32).reshape(1, -1)
    oy = oy.to(torch.float32).reshape(1, -1)

    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)
    guess = torch.zeros_like(xy0)  # flow estimate in level-0 pixels
    status = torch.ones(xy0.shape[0], dtype=torch.bool, device=xy0.device)
    for lvl in range(levels - 1, -1, -1):
        scale = float(2 ** lvl)  # a power of two: the divisions are exact
        p0, p1 = pyr0[lvl], pyr1[lvl]
        kx = xy0[:, :1] / scale
        ky = xy0[:, 1:] / scale
        x0 = kx + ox
        y0 = ky + oy
        t = _bilinear(p0, x0, y0)
        gx = 0.5 * (_bilinear(p0, x0 + 1, y0) - _bilinear(p0, x0 - 1, y0))
        gy = 0.5 * (_bilinear(p0, x0, y0 + 1) - _bilinear(p0, x0, y0 - 1))
        gxx = torch.sum(gx * gx, dim=1)
        gxy = torch.sum(gx * gy, dim=1)
        gyy = torch.sum(gy * gy, dim=1)
        det = gxx * gyy - gxy * gxy
        ok = det > 1e-6
        inv = torch.where(ok, 1.0 / torch.clamp(det, min=1e-12), 0.0)
        g = guess
        for _ in range(cfg.flow_iterations):
            x1 = kx + g[:, :1] / scale + ox
            y1 = ky + g[:, 1:] / scale + oy
            diff = t - _bilinear(p1, x1, y1)
            bx = torch.sum(diff * gx, dim=1)
            by = torch.sum(diff * gy, dim=1)
            dx = inv * (gyy * bx - gxy * by)
            dy = inv * (-gxy * bx + gxx * by)
            g = g + torch.stack([dx, dy], dim=1) * scale
        if lvl == 0:
            # bounds only matter at the finest level (coarse levels clamp);
            # rejecting at every level would discard most of a short image
            h, w = p1.shape
            x1 = kx[:, 0] + g[:, 0] / scale
            y1 = ky[:, 0] + g[:, 1] / scale
            ok = ok & (x1 > r) & (x1 < w - r - 1) & (y1 > r) & (y1 < h - r - 1)
        guess = g
        status = status & ok
    return xy0 + guess, status
