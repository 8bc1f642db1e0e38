"""The per-ring reductions behind LO association beside each other on the
GPU: K2 (ring_min2: several queries a thread over a packed slab tile, the two
best chunks tracked in the main loop and resolved to slots at the end), its
argmin-then-mask formulation (ring_argmin2), the min-only variant
(ring_min1), the packed-key minimum of the engines' association
(ring_min1_packed, impl "mxu", and its difference form, impl "packed") and
the plain PyTorch version.

    python -m vloam_tpu_torch.tools.profile_ring_variants [--shapes]
        [--parent DIR]

The counterpart of scripts/profile_ring_variants.py, at its two shapes
(corner 64 x 128 slots x 1024 queries, surf 64 x 512 x 2048) and on its
synthetic rings. Every variant is checked against the plain version (slots
and distances identical) before it is timed. It also prints ``update_share``
at each shape: how often a warp of K2 would have to enter an ordered top-2
update if it skipped the chunks that cannot change a query's second minimum
(the reason K2 tracks chunks without branches instead). With --shapes it
also builds ring_min2.cu (threads a group, queries a thread, slots a chunk),
ring_min1.cu's ring_min1 (the same and groups a block) and its
ring_min1_packed (queries a thread, warps a block, slots an unrolled step)
with other block shapes, checks each against the plain version and times
it at the engines' two shapes (768 and 1536 queries; ring_min1_packed in
both forms, with the machine code's instructions a pair), times ring_min1
and ring_min1_packed with parts of their work switched off (launch only;
all but the slot loop), and ring_argmin2 with other shared-memory budgets
for its segment minima (longer or shorter segments) at the entry point's
two shapes. With --parent DIR it builds DIR's ring_min1.cu (the S1 source
of another checkout, e.g. the parent commit unpacked beside the tree) and
times its ring_argmin2 at the entry point's shapes and its
ring_min1_packed in both forms at the engines' shapes beside the tree's,
in turns (parent, tree, tree, parent), each checked against the plain
version first. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..kernels import build
from ..lidar.ring_assoc import (SENTINEL, _quant, ring_min1_mxu_plain,
                                 ring_min1_packed_plain, ring_min1_plain,
                                 ring_min2_plain)
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


def packed(queries: torch.Tensor, slab_t: torch.Tensor, product: bool):
    """The tree's ring_min1_packed at the association's quantization."""
    return kernels.ring_min1_packed(queries, slab_t, product,
                                    *_quant(slab_t.shape[2]))


def packed_plain(product: bool):
    """The plain version of ring_min1_packed's product or difference form."""
    return ring_min1_mxu_plain if product else ring_min1_packed_plain


def check(queries: torch.Tensor, slab_t: torch.Tensor) -> None:
    """Raise unless the four kernels equal the plain versions bit for bit
    (ring_min1_packed in both forms)."""
    want = ring_min2_plain(queries, slab_t)
    got = {"ring_min2": (kernels.ring_min2(queries, slab_t), want),
           "ring_argmin2": (kernels.ring_argmin2(queries, slab_t), want),
           "ring_min1": (kernels.ring_min1(queries, slab_t), want)}
    for product in (True, False):
        got[f"ring_min1_packed product={product}"] = (
            packed(queries, slab_t, product),
            packed_plain(product)(queries, slab_t))
    torch.cuda.synchronize()
    for name, (outs, ref) in got.items():
        for k, (g, w) in enumerate(zip(outs, ref)):
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
            "packed mxu": (2, lambda: packed(q, slab_t, True)),
            "packed diff": (2, lambda: packed(q, slab_t, False)),
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


# K2 (ring_min2.cu): (threads a group, queries a thread, slots a chunk);
# the first is the kernel's own
BLOCK_SHAPES = ((64, 4, 8), (128, 4, 8), (32, 4, 8), (64, 2, 8), (128, 2, 8),
                (64, 6, 8), (64, 4, 4), (64, 4, 16))
# ring_min1 (ring_min1.cu): (threads a group, queries a thread, groups a
# block, slots a chunk); the first is the kernel's own
MIN1_BLOCK_SHAPES = ((32, 4, 4, 4), (32, 4, 4, 8), (32, 4, 4, 2),
                     (32, 2, 4, 4), (64, 4, 4, 4), (64, 2, 4, 4),
                     (64, 2, 2, 4), (64, 2, 2, 8), (64, 4, 2, 4),
                     (32, 4, 2, 4), (32, 8, 4, 4), (64, 4, 1, 8))
# ring_min1's and ring_min1_packed's own shapes with parts of their work
# switched off (VLOAM_S1_PART)
MIN1_PARTS = ((1, "launch only"), (2, "no slot loop"))
# ring_argmin2 (ring_min1.cu): bytes of pass 1's segment minima a block; the
# first is the kernel's own
ARGMIN2_STORES = ((32768,), (16384,), (8192,), (65536,))
# ring_min1_packed (ring_min1.cu): (queries a thread, warps a block, slots
# an unrolled step); the first is the kernel's own
PACKED_BLOCK_SHAPES = ((4, 4, 8), (4, 4, 4), (2, 4, 4), (1, 4, 4),
                       (2, 4, 8), (2, 8, 4), (4, 4, 2), (4, 4, 16),
                       (4, 8, 8), (4, 2, 8), (8, 4, 4), (8, 4, 8),
                       (2, 2, 4), (8, 2, 4))
_I, _F = ctypes.c_int, ctypes.c_float
_SWEEPS = {
    "ring_min2": ("ring_min2.cu", ("VLOAM_K2_GROUP", "VLOAM_K2_QPT",
                                   "VLOAM_K2_CHUNK"), 4, ring_min2_plain,
                  "threads a group, queries a thread, slots a chunk"),
    "ring_min1": ("ring_min1.cu", ("VLOAM_S1_GROUP", "VLOAM_S1_QPT",
                                   "VLOAM_S1_SPLIT", "VLOAM_S1_CHUNK"), 2,
                  ring_min1_plain, "threads a group, queries a thread, "
                  "groups a block, slots a chunk"),
    "ring_argmin2": ("ring_min1.cu", ("VLOAM_A2_STORE",), 4, ring_min2_plain,
                     "bytes of segment minima a block"),
    "ring_min1_packed": ("ring_min1.cu", ("VLOAM_PK_QPT", "VLOAM_PK_WARPS",
                                          "VLOAM_PK_UNROLL"), 2, None,
                         "queries a thread, warps a block, slots an "
                         "unrolled step"),
}
# the C function's arguments after (Q, S, C), per form of the packed kernel
_PACKED_FORMS = {"mxu": True, "packed": False}


def _forms(name: str, C: int) -> dict:
    """{form: (extra C arguments, their ctypes, plain version)}: one form
    (no extra arguments) for the exact reductions, both for the packed."""
    if name != "ring_min1_packed":
        return {"": ((), [], _SWEEPS[name][3])}
    bits, scale, clip = _quant(C)
    return {form: ((int(product), bits, scale, clip), [_I, _I, _F, _F],
                   packed_plain(product))
            for form, product in _PACKED_FORMS.items()}


def _launcher(lib, name: str, n_out: int, queries, slab_t, extra, types):
    """A launch of vloam_<name> from a library built by build_variants, on
    the given inputs, returning its outputs."""
    p = ctypes.c_void_p
    fn = getattr(lib, f"vloam_{name}")
    fn.argtypes = [p, p] + [p] * n_out + [_I, _I, _I] + types + [p]
    fn.restype = _I
    Q, S, C = queries.shape[0], slab_t.shape[0], slab_t.shape[2]

    def launch():
        outs = [torch.empty((S, Q), device=queries.device,
                            dtype=torch.int32 if k % 2 else torch.float32)
                for k in range(n_out)]
        err = fn(queries.data_ptr(), slab_t.data_ptr(),
                 *(o.data_ptr() for o in outs), Q, S, C, *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return outs
    return launch


def run_block_shapes(name: str = "ring_min2", block_shapes=BLOCK_SHAPES,
                     parts=(), shapes=ENGINE_SHAPES, runs: int = 30) -> dict:
    """K2, ring_min1 or ring_min1_packed built with other block-shape
    constants, each held to the plain version and timed at the engines'
    shapes (on the synthetic rings of make(); the packed kernel in both
    forms, with its machine code's instructions a pair), then the first
    shape with each of `parts` ((code, label): VLOAM_S1_PART, not checked);
    returns {(label, shape name, form): ms}."""
    require_cuda()
    source, keys, n_out, _, what = _SWEEPS[name]
    inputs = {shape: make(S, C, Q) for shape, S, C, Q in shapes}
    forms = {shape: _forms(name, qs[1].shape[2])
             for shape, qs in inputs.items()}
    want = {(shape, form): plain(*inputs[shape])
            for shape, fs in forms.items()
            for form, (_, _, plain) in fs.items()}
    variants = [(f"block shape {b} ({what})", dict(zip(keys, b)), True)
                for b in block_shapes]
    variants += [(f"block shape {block_shapes[0]}, {label}",
                  {**dict(zip(keys, block_shapes[0])), "VLOAM_S1_PART": code},
                  False) for code, label in parts]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build.build_variants(build.CSRC / source,
                                    [d for _, d, _ in variants], tmp)
        for (label, _, checked), (so, log) in zip(variants, libs):
            lib = ctypes.CDLL(so)
            line = []
            for shape, (queries, slab_t) in inputs.items():
                for form, (extra, types, _) in forms[shape].items():
                    launch = _launcher(lib, name, n_out, queries, slab_t,
                                       extra, types)
                    got = launch()
                    torch.cuda.synchronize()
                    if checked and not all(
                            torch.equal(a, w)
                            for a, w in zip(got, want[shape, form])):
                        raise RuntimeError(
                            f"{name} {label} {form} differs from the plain "
                            f"version at the {shape} shape")
                    ms = device_ms(launch, runs, cold=False)
                    out[label, shape, form] = ms
                    line.append(f"{shape}{' ' + form if form else ''} "
                                f"{ms * 1e3:.1f} us")
            usage = "; ".join(
                f"{k} {u['registers']} registers, {u['spill_stores']} B "
                f"spilled, {u['smem']} B shared"
                for k, u in build.parse_report(log).items() if name in k)
            print(f"{name} {label}: " + ", ".join(line) + f" ({usage})",
                  flush=True)
            if name == "ring_min1_packed":
                lines, converting = build.packed_sass(build.sass(so))
                print("  sass: " + "; ".join(lines), flush=True)
                if converting:
                    raise RuntimeError(f"{label}: F2I in the fast path of "
                                       f"{converting}")
    return out


def run_parent(parent: str, runs: int = 30) -> dict:
    """Another checkout's ring_min1.cu beside the tree's: its ring_argmin2
    at the entry point's shapes and its ring_min1_packed in both forms at
    the engines' shapes, timed in turns (parent, tree, tree, parent) after
    both are held to the plain version; returns {(label, kernel, shape
    name): [ms]}."""
    require_cuda()
    src = Path(parent) / "vloam_tpu_torch" / "kernels" / "csrc" / "ring_min1.cu"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        (so, _), = build.build_variants(src, [{}], tmp)
        lib = ctypes.CDLL(so)
        runs_of = [("ring_argmin2", 4, SHAPES)]
        runs_of += [("ring_min1_packed", 2, ENGINE_SHAPES)]
        for name, n_out, shapes in runs_of:
            for shape, S, C, Q in shapes:
                q, slab_t = make(S, C, Q)
                for form, (extra, types, plain) in _forms(name, C).items():
                    what = f"{name}{' ' + form if form else ''}"
                    tree = (lambda: kernels.ring_argmin2(q, slab_t)) \
                        if name == "ring_argmin2" else \
                        (lambda p=extra[0]: packed(q, slab_t, bool(p)))
                    sides = {"parent": _launcher(lib, name, n_out, q, slab_t,
                                                 extra, types),
                             "tree": tree}
                    want = plain(q, slab_t)
                    for label, f in sides.items():
                        got = f()
                        torch.cuda.synchronize()
                        if not all(torch.equal(a, w)
                                   for a, w in zip(got, want)):
                            raise RuntimeError(
                                f"the {label}'s {what} differs from the "
                                f"plain version ({shape})")
                    for label in ("parent", "tree", "tree", "parent"):
                        out.setdefault((label, what, shape), []).append(
                            device_ms(sides[label], runs, cold=False))
                    print(f"{shape:6s} {Q} x [{S},3,{C}] {what} " + ", ".join(
                        f"{label} " + " / ".join(
                            f"{t * 1e3:.2f}"
                            for t in out[label, what, shape]) + " us"
                        for label in ("parent", "tree"))
                        + " (in turns: parent, tree, tree, parent)",
                        flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", action="store_true",
                    help="also time K2, ring_min1 and ring_min1_packed with "
                    "other block shapes")
    ap.add_argument("--parent", help="root of another checkout whose "
                    "ring_argmin2 and ring_min1_packed are timed beside the "
                    "tree's")
    args = ap.parse_args()
    require_cuda()
    print(card_line(), flush=True)
    run()
    if args.parent:
        run_parent(args.parent)
    if args.shapes:
        run_block_shapes("ring_min1_packed", PACKED_BLOCK_SHAPES, MIN1_PARTS)
        run_block_shapes("ring_argmin2", ARGMIN2_STORES, shapes=SHAPES)
        run_block_shapes("ring_min2", BLOCK_SHAPES)
        run_block_shapes("ring_min1", MIN1_BLOCK_SHAPES, MIN1_PARTS)


if __name__ == "__main__":
    main()
