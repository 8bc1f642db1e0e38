"""Where K1 select_rings spends its time on the GPU: the kernel on the
feature layout of one synthetic kitti_hdl64 frame ([64, 1800]), whole and
with parts of its work switched off through its own parameters.

    python -m vloam_tpu_torch.tools.profile_select_rings

- "no rounds" (0 corner and 0 flat picks) is what staging the ring, writing
  the labels and the launch cost; the rest of "6 sectors" is pick rounds.
- 8 sectors still run side by side, one warp each; 9 sectors, and 1 sector
  (whose 1789 points no longer fit a warp's registers), run in order in one
  warp: the serial paths.
- [256, 1800] is a 4-stream batch in one launch.
Every variant is held to select_rings_plain first. Needs a GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import kitti_hdl64
from ..data import synthetic
from ..lidar import scan_registration as sr
from .timing import card_line, device_ms, require_cuda


class _Selection:
    """Selection constants in the shape select_rings_plain reads them."""

    def __init__(self, cfg, n_sectors, n_corner, n_flat):
        self.curvature_threshold = cfg.curvature_threshold
        self.n_sectors = n_sectors
        self.max_sharp_per_sector = cfg.max_sharp_per_sector
        self.max_less_sharp_per_sector = n_corner
        self.max_flat_per_sector = n_flat


def frame_layout(n_az: int = 1800):
    """(curv, bf, counts) of one synthetic HDL-64 polar frame on the GPU."""
    cfg = kitti_hdl64()
    T = synthetic.drive_trajectory(1, speed=1.1, yaw_rate=0.01)[0]
    img = synthetic.simulate_scan_polar(
        synthetic.urban_scene(0, extent=80.0), T, n_scans=64,
        n_azimuth=n_az, noise=0.01, seed=0)
    elev = torch.tensor(np.radians(synthetic.hdl64_elevations(64)),
                        dtype=torch.float32, device="cuda")
    pts, _, counts = sr.polar_layout(
        torch.from_numpy(img.astype(np.int32)).cuda(),
        sr.polar_directions(elev, n_az), cfg.lidar)
    return (sr._curvature(pts).contiguous(),
            sr._break_prefix(pts, cfg.scanreg.neighbor_suppress_gap_sq)
            .to(torch.int32).contiguous(),
            counts.to(torch.int32).contiguous())


def run(runs: int = 20) -> dict:
    require_cuda()
    cfg = kitti_hdl64().scanreg
    curv, bf, counts = frame_layout()
    nc, nf = cfg.max_less_sharp_per_sector, cfg.max_flat_per_sector
    variants = (("6 sectors x (20 corner + 4 flat)", 6, nc, nf, 1),
                ("no rounds", 6, 0, 0, 1), ("corner rounds only", 6, nc, 0, 1),
                ("flat rounds only", 6, 0, nf, 1), ("8 sectors", 8, nc, nf, 1),
                ("9 sectors, in order", 9, nc, nf, 1),
                ("1 sector, in shared memory", 1, nc, nf, 1),
                ("[256, 1800], 6 sectors", 6, nc, nf, 4))
    out = {}
    for name, ns, n_corner, n_flat, rep in variants:
        c, b, n = curv.repeat(rep, 1), bf.repeat(rep, 1), counts.repeat(rep)

        def launch():
            return kernels.select_rings(
                c, b, n, cfg.curvature_threshold, ns,
                cfg.max_sharp_per_sector, n_corner, n_flat)

        want = sr.select_rings_plain(c, b, n, _Selection(cfg, ns, n_corner,
                                                         n_flat))
        got = launch()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: labels differ from the plain version "
                               f"at {int((got != want).sum())} points")
        out[name] = (device_ms(launch, runs), device_ms(launch, runs,
                                                        cold=False))
        print(f"select_rings {name}: {out[name][0] * 1e3:.1f} us cold L2, "
              f"{out[name][1] * 1e3:.1f} us warm ({int((got != 0).sum())} "
              "labels)", flush=True)
    return out


def main() -> None:
    require_cuda()
    print(card_line(), flush=True)
    run()


if __name__ == "__main__":
    main()
