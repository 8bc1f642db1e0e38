"""The per-ring reductions behind LO association beside each other on the
GPU: K2 (ring_min2: several queries a thread over a packed slab tile, the two
best chunks tracked in the main loop and resolved to slots at the end), its
argmin-then-mask formulation (ring_argmin2), the min-only variant corner
association uses (ring_min1) and the plain PyTorch version.

    python -m vloam_tpu_torch.tools.profile_ring_variants [--shapes]

The counterpart of scripts/profile_ring_variants.py, at its two shapes
(corner 64 x 128 slots x 1024 queries, surf 64 x 512 x 2048) and on its
synthetic rings. Every variant is checked against the plain version (slots
and distances identical) before it is timed. It also prints ``update_share``
at each shape: how often a warp of K2 would have to enter an ordered top-2
update if it skipped the chunks that cannot change a query's second minimum
(the reason K2 tracks chunks without branches instead). With --shapes it
also builds ring_min2.cu with other block shapes (threads a group, queries a
thread, slots a chunk), checks each against the plain version and times it
at the engines' two shapes (768 and 1536 queries). Needs a GPU.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..kernels import build
from ..lidar.ring_assoc import SENTINEL, ring_min1_plain, ring_min2_plain
from .timing import card_line, device_ms, require_cuda, ring_reduce_bound

SHAPES = (("corner", 64, 128, 1024), ("surf", 64, 512, 2048))
# what LO association gives the reductions at kitti_hdl64 (768 sharp and
# 1536 flat queries): the shapes a block shape has to fit
ENGINE_SHAPES = (("corner", 64, 128, 768), ("surf", 64, 512, 1536))


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


def update_share(queries: torch.Tensor, slab_t: torch.Tensor, chunk: int = 8,
                 threads: int = 64, qpt: int = 4) -> tuple[float, float]:
    """Walking the slots in chunks of `chunk`, a query needs an ordered
    top-2 update in a chunk only if the chunk's smallest distance is below
    its running second minimum. Returns the share of (query, chunk) steps
    that need one, and the share of (warp, chunk) steps in which any query of
    the warp does, for warps that hold 32 x qpt queries strided over blocks
    of `threads` threads (K2's layout)."""
    S, _, C = slab_t.shape
    Q = queries.shape[0]
    diff = queries[None, :, :, None] - slab_t[:, None, :, :]  # [S, Q, 3, C]
    d = (diff * diff).sum(2)
    top = torch.full((S, Q, 2), float("inf"), device=d.device)
    needs = []
    for c0 in range(0, C, chunk):
        part = d[:, :, c0:c0 + chunk]
        needs.append(part.amin(-1) < top[..., 1])
        top = torch.topk(torch.cat([top, part], -1), 2, largest=False).values
    needs = torch.stack(needs, -1)  # [S, Q, n_chunks]
    per_block = threads * qpt
    pad = -Q % per_block
    warp = torch.cat([needs, needs.new_zeros((S, pad, needs.shape[-1]))], 1)
    warp = warp.reshape(S, -1, qpt, threads // 32, 32, needs.shape[-1])
    return float(needs.float().mean()), float(warp.any(4).any(2).float().mean())


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
        per_query, per_warp = update_share(q, slab_t)
        print(f"{name:6s} {Q} x [{S},3,{C}] chunks of 8 slots whose minimum is "
              f"below the running second minimum: {per_query:.1%} per query, "
              f"{per_warp:.1%} per warp of 128 queries", flush=True)
        for label, (n_out, fn) in variants.items():
            ms = device_ms(fn, runs, cold=False)
            bound, by = ring_reduce_bound(Q, S, C, n_out)
            out[name][label] = ms
            print(f"{name:6s} {Q} x [{S},3,{C}] {label:13s} {ms * 1e3:9.1f} "
                  f"us (bound by {by} {bound * 1e3:.2f} us)", flush=True)
    return out


# (threads a group, queries a thread, slots a chunk); the first is the
# kernel's own
BLOCK_SHAPES = ((64, 4, 8), (128, 4, 8), (32, 4, 8), (64, 2, 8), (128, 2, 8),
                (64, 6, 8), (64, 4, 4), (64, 4, 16))


def run_block_shapes(block_shapes=BLOCK_SHAPES, shapes=ENGINE_SHAPES,
                     runs: int = 30) -> None:
    """K2 built with other constants, each held to the plain version and
    timed at the engines' shapes (on the synthetic rings of make())."""
    require_cuda()
    src = str(build.CSRC / "ring_min2.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    inputs = {name: make(S, C, Q) for name, S, C, Q in shapes}
    want = {name: ring_min2_plain(*qs) for name, qs in inputs.items()}
    with tempfile.TemporaryDirectory() as tmp:
        libs = [str(Path(tmp) / f"k2_{g}_{q}_{c}.so")
                for g, q, c in block_shapes]
        procs = [subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
             f"-DVLOAM_K2_GROUP={g}", f"-DVLOAM_K2_QPT={q}",
             f"-DVLOAM_K2_CHUNK={c}", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for (g, q, c), so in zip(block_shapes, libs)]
        for (g, q, c), so, proc in zip(block_shapes, libs, procs):
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed:\n{log}")
            used = [ln.split("Used ")[1] for ln in log.splitlines()
                    if "Used " in ln]
            lib = ctypes.CDLL(so)
            lib.vloam_ring_min2.argtypes = [p, p, p, p, p, p, i, i, i, p]
            lib.vloam_ring_min2.restype = i
            line = []
            for name, (queries, slab_t) in inputs.items():
                Q, S, C = queries.shape[0], slab_t.shape[0], slab_t.shape[2]

                def launch():
                    outs = [torch.empty((S, Q), device=queries.device,
                                        dtype=torch.int32 if k % 2
                                        else torch.float32) for k in range(4)]
                    err = lib.vloam_ring_min2(
                        queries.data_ptr(), slab_t.data_ptr(),
                        *(o.data_ptr() for o in outs), Q, S, C,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                    return outs

                got = launch()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b)
                           for a, b in zip(got, want[name])):
                    raise RuntimeError(
                        f"block shape {(g, q, c)} differs from the plain "
                        f"version at the {name} shape")
                ms = device_ms(launch, runs, cold=False)
                line.append(f"{name} {ms * 1e3:.1f} us")
            print(f"ring_min2 with {g} threads a group, {q} queries a thread,"
                  f" chunks of {c}: " + ", ".join(line)
                  + f" ({'; '.join(used)})", flush=True)


def main() -> None:
    require_cuda()
    print(card_line(), flush=True)
    run()
    if "--shapes" in sys.argv[1:]:
        run_block_shapes()


if __name__ == "__main__":
    main()
