"""The per-ring reductions behind LO association beside each other on the
GPU: K2 (ring_min2, a running top-2), its argmin-then-mask formulation
(ring_argmin2), the min-only variant corner association uses (ring_min1) and
the plain PyTorch version.

    python -m vloam_tpu_torch.tools.profile_ring_variants

The counterpart of scripts/profile_ring_variants.py, at its two shapes
(corner 64 x 128 slots x 1024 queries, surf 64 x 512 x 2048) and on its
synthetic rings. Every variant is checked against the plain version (slots
and distances identical) before it is timed. Needs a GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..lidar.ring_assoc import SENTINEL, ring_min1_plain, ring_min2_plain
from .timing import card_line, device_ms, require_cuda, ring_reduce_bound

SHAPES = (("corner", 64, 128, 1024), ("surf", 64, 512, 2048))


def make(S: int, C: int, Q: int, seed: int = 0, device="cuda"):
    """Rings as noisy circles and queries drawn from them: queries [Q, 3],
    slab_t [S, 3, C]."""
    rng = np.random.default_rng(seed)
    slab = np.full((S, C, 3), SENTINEL, np.float32)
    for s in range(S):
        th = np.linspace(0, 2 * np.pi, C, endpoint=False)
        r = 10.0 + 0.9 * s
        pts = np.stack([r * np.cos(th), r * np.sin(th),
                        np.full(C, 0.1 * s)], 1).astype(np.float32)
        slab[s] = pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)
    q = slab.reshape(-1, 3)[rng.choice(S * C, Q, replace=False)]
    slab_t = np.ascontiguousarray(np.swapaxes(slab, 1, 2))
    return torch.from_numpy(q).to(device), torch.from_numpy(slab_t).to(device)


def check(queries: torch.Tensor, slab_t: torch.Tensor) -> None:
    """Raise unless the three kernels equal the plain versions bit for bit."""
    want = ring_min2_plain(queries, slab_t)
    got = {"ring_min2": kernels.ring_min2(queries, slab_t),
           "ring_argmin2": kernels.ring_argmin2(queries, slab_t),
           "ring_min1": kernels.ring_min1(queries, slab_t)}
    torch.cuda.synchronize()
    for name, outs in got.items():
        for k, (g, w) in enumerate(zip(outs, want)):
            if not torch.equal(g, w):
                raise RuntimeError(
                    f"{name} output {k} differs from the plain version at "
                    f"{int((g != w).sum())} entries")


def run(shapes=SHAPES, runs: int = 30) -> dict:
    """Check, then time every variant at each shape; returns
    {shape: {variant: ms}}."""
    require_cuda()
    out = {}
    for name, S, C, Q in shapes:
        q, slab_t = make(S, C, Q)
        check(q, slab_t)
        variants = {
            "ring_min2": (4, lambda: kernels.ring_min2(q, slab_t)),
            "ring_argmin2": (4, lambda: kernels.ring_argmin2(q, slab_t)),
            "ring_min1": (2, lambda: kernels.ring_min1(q, slab_t)),
            "plain min2": (4, lambda: ring_min2_plain(q, slab_t)),
            "plain min1": (2, lambda: ring_min1_plain(q, slab_t)),
        }
        out[name] = {}
        for label, (n_out, fn) in variants.items():
            ms = device_ms(fn, runs, cold=False)
            bound, by = ring_reduce_bound(Q, S, C, n_out)
            out[name][label] = ms
            print(f"{name:6s} {Q} x [{S},3,{C}] {label:13s} {ms * 1e3:9.1f} "
                  f"us (bound by {by} {bound * 1e3:.2f} us)", flush=True)
    return out


def main() -> None:
    require_cuda()
    print(card_line(), flush=True)
    run()


if __name__ == "__main__":
    main()
