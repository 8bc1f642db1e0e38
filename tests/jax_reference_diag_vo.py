"""The JAX package's VO stages composed as scripts/diag_vo.py's main composes
them (base variant: ZNCC, brute force, ratio test), on the CPU over the
first pairs of the port's evaluation drive: a reference for
vloam_tpu_torch/tools/diag_vo.py measured on the same host as the card.

    JAX_PLATFORMS=cpu python tests/jax_reference_diag_vo.py [N_PAIRS]

The frames are tools/eval_frames.synthetic_drive's 100-frame drive (its
first N_PAIRS + 1 frames, the drive of scripts/eval_synthetic.py bit for
bit, tests/test_torch_eval.py), the truth and the error measures the
port's (diag_vo.load_drive, diag_vo.error). Prints one JSON line: per pair
the valid matches, n32, n22, the rotation error (mrad), the translation
error vector and its norm (mm), and the solve's angles and translation.
Writes nothing but the temporary directory's frame cache.
"""

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vloam_tpu.config import kitti_hdl64  # noqa: E402
from vloam_tpu.vision import features  # noqa: E402
from vloam_tpu.vision.depth_map import build_depth_grid  # noqa: E402
from vloam_tpu.vision.vo import solve_vo  # noqa: E402
from vloam_tpu_torch import config as tcfg  # noqa: E402
from vloam_tpu_torch.tools import diag_vo  # noqa: E402


def pair(drive, k: int, vo) -> dict:
    img0 = jnp.asarray(drive.frames[k]["image"], jnp.float32)
    img1 = jnp.asarray(drive.frames[k + 1]["image"], jnp.float32)
    xy0, _, m0 = features.detect_keypoints(img0, vo)
    xy1, _, m1 = features.detect_keypoints(img1, vo)
    d0 = features.describe_keypoints(img0, xy0, vo)
    d1 = features.describe_keypoints(img1, xy1, vo)
    idx1, ok = features.match_descriptors(d0, m0, d1, m1, vo.match_ratio,
                                          matcher=vo.matcher,
                                          select=vo.match_select)
    pts0 = drive.frames[k]["points"]
    grid0 = build_depth_grid(jnp.asarray(pts0, jnp.float32),
                             jnp.ones(len(pts0), bool),
                             jnp.asarray(drive.P.numpy()), vo)
    a, t, n32, n22 = solve_vo(xy0, xy1[idx1], ok, grid0,
                              jnp.asarray(drive.K, jnp.float32),
                              jnp.zeros(3, jnp.float32),
                              jnp.zeros(3, jnp.float32), vo)
    a, t = np.asarray(a, np.float64), np.asarray(t, np.float64)
    rot, err = diag_vo.error(drive.truth(k), a, t)
    return {"valid": int(np.asarray(ok).sum()), "n32": int(n32),
            "n22": int(n22), "rot_mrad": float(rot),
            "err_mm": [float(v) for v in err],
            "trans_mm": float(np.linalg.norm(err)),
            "angles": a.tolist(), "t": t.tolist()}


def main(n_pairs: int) -> None:
    vo = kitti_hdl64().replace(detach_VO_LO=False).vo
    drive = diag_vo.load_drive(n_pairs, tcfg.kitti_hdl64(), "cpu")
    pairs = [pair(drive, k, vo) for k in range(n_pairs)]
    print(json.dumps({"reference": "vloam_tpu (JAX) on the CPU",
                      "entry": "main, base", "pairs": pairs}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10)
