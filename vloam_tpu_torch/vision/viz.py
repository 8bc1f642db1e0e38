"""Debug-image renderers (a copy of vloam_tpu/vision/viz.py; render_depth
queries the port's depth grid).

Host-side equivalents of the reference's visualization publishers
(visual_odometry.cpp publish() :489-522: matches, depth, optical flow;
image_util.cpp visualizeMatches/visualizeOpticalFlow; point_cloud_util.cpp
visualizeDepth) — rendered to PNG files instead of ROS image topics.
"""

from __future__ import annotations

import numpy as np


def _to_rgb(img: np.ndarray) -> np.ndarray:
    g = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _depth_color(depth, d_min=0.1, d_max=50.0):
    """Reference colormap (point_cloud_util.cpp:274-289): green->red->blue."""
    ratio = np.clip((depth - d_min) / (d_max - d_min), 0.0, 1.0)
    r = np.where(ratio < 0.5, 255 * (1 - ratio * 2), 255 * (ratio - 0.5) * 2)
    g = np.where(ratio < 0.5, 255 * ratio * 2, 255 * (1 - (ratio - 0.5) * 2))
    b = np.where(ratio < 0.5, 0.0, 255 * (ratio - 0.5) * 2)
    # note reference uses BGR cv::Scalar(b,g,r)-style tuples; we emit RGB
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def _draw_dot(canvas, x, y, color, r=1):
    h, w = canvas.shape[:2]
    x, y = int(round(x)), int(round(y))
    if 0 <= x < w and 0 <= y < h:
        canvas[max(0, y - r):y + r + 1, max(0, x - r):x + r + 1] = color


def render_matches(img0, img1, kp0, kp1, pairs, path=None):
    """Side-by-side match image (visualizeMatches equivalent).
    pairs: list of (i0, i1) keypoint index pairs."""
    from PIL import Image, ImageDraw

    c0, c1 = _to_rgb(img0), _to_rgb(img1)
    h = max(c0.shape[0], c1.shape[0])
    canvas = np.zeros((h, c0.shape[1] + c1.shape[1], 3), np.uint8)
    canvas[: c0.shape[0], : c0.shape[1]] = c0
    canvas[: c1.shape[0], c0.shape[1]:] = c1
    im = Image.fromarray(canvas)
    draw = ImageDraw.Draw(im)
    off = c0.shape[1]
    rng = np.random.default_rng(0)
    for i0, i1 in pairs:
        x0, y0 = float(kp0[i0][0]), float(kp0[i0][1])
        x1, y1 = float(kp1[i1][0]) + off, float(kp1[i1][1])
        color = tuple(int(v) for v in rng.integers(64, 255, 3))
        draw.line([(x0, y0), (x1, y1)], fill=color, width=1)
        draw.ellipse([x0 - 2, y0 - 2, x0 + 2, y0 + 2], outline=color)
        draw.ellipse([x1 - 2, y1 - 2, x1 + 2, y1 + 2], outline=color)
    if path:
        im.save(path)
    return np.asarray(im)


def render_flow(img1, kp0, kp1, status, path=None):
    """Flow arrows on the current image (visualizeOpticalFlow equivalent)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(_to_rgb(img1))
    draw = ImageDraw.Draw(im)
    for (x0, y0), (x1, y1), ok in zip(np.asarray(kp0), np.asarray(kp1),
                                      np.asarray(status)):
        if not ok:
            continue
        draw.line([(float(x0), float(y0)), (float(x1), float(y1))],
                  fill=(0, 255, 0), width=1)
        draw.ellipse([x1 - 1, y1 - 1, x1 + 1, y1 + 1], fill=(255, 0, 0))
    if path:
        im.save(path)
    return np.asarray(im)


def render_depth(img, grid, cfg, path=None, stride=3):
    """Depth overlay sampled on a pixel grid (visualizeDepth equivalent,
    point_cloud_util.cpp:471-504). grid: a DepthGrid on any device."""
    import torch

    from .depth_map import query_depth

    h, w = np.asarray(img).shape
    xs, ys = np.meshgrid(np.arange(0, w, stride), np.arange(0, h, stride))
    pts = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float32)
    depths = query_depth(grid, torch.from_numpy(pts).to(grid.z.device),
                         cfg).cpu().numpy()
    canvas = _to_rgb(img)
    colors = _depth_color(depths)
    for (x, y), d, c in zip(pts, depths, colors):
        if d > 0:
            _draw_dot(canvas, x, y, c)
    if path:
        from PIL import Image

        Image.fromarray(canvas).save(path)
    return canvas
