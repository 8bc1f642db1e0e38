"""Row gather from a float32 table resident in device memory: the
hand-written kernel (kernels/csrc/row_gather.cu) beside ``table[idx]`` and
``torch.index_select`` on the same inputs.

    python -m vloam_tpu_torch.tools.profile_row_gather [--shapes]
        [--parent DIR]

The counterpart of scripts/profile_pallas_gather.py, at its shape: 65536
random rows of 384 B (the corner grid's row) from [2^17, 96]; and at the
engines' gathers: a frame's surf and corner inserts, from [2^17, W], and
the 4-stream lockstep frame's, from [4 x 2^17, W], whose rows repeat as
inserted points crowd into few buckets (as many distinct rows as
chip_smoke.py's phase S2 counted on a real drive); and the mesh frame's
window gathers, 4096 distinct rows of a one-rank block [2^17, W] for each
grid (parallel/mesh_fused.py). Prints device time per
call with a cold and with a warm L2 and the least time the card could take.
With --shapes it also builds row_gather.cu with other block shapes
(threads a block, 16-byte words a thread), checks each and times it at the
engines' shapes, and times its own shape with parts of its work switched
off (launch only; index loads and stores without the row loads); with
--parent DIR it builds DIR's row_gather.cu (another checkout, e.g. the
parent commit unpacked beside the tree) and times it beside the tree's at
those shapes, in turns (parent, tree, tree, parent), each checked against
table[idx] first. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import tempfile
from pathlib import Path

import torch

from .. import kernels
from ..kernels import build
from ..lidar.gridmap import row_gather_plain
from .timing import card_line, device_ms, require_cuda, row_gather_bound

NB = 1 << 17
W = 3 * 32  # 96 f32 = 384 B rows (the corner grid's row)
N_ROWS = 65536
# the engines' gathers: (label, table rows, width, rows gathered, distinct
# rows), the inserts' distinct counts from a real drive (PERF.md section 6);
# a mesh window holds each of its rows once (mesh_window_rows 4096)
ENGINE_SHAPES = (("frame surf insert", NB, 48, 6144, 874),
                 ("frame corner insert", NB, 96, 2048, 439),
                 ("batch surf insert", 4 * NB, 48, 24576, 3514),
                 ("batch corner insert", 4 * NB, 96, 8192, 1896),
                 ("mesh surf window", NB, 48, 4096, 4096),
                 ("mesh corner window", NB, 96, 4096, 4096))
# row_gather.cu's block shapes: (threads a block, 16-byte words a thread);
# the first is the kernel's own
BLOCK_SHAPES = ((256, 2), (128, 2), (128, 1), (128, 4), (256, 1), (256, 4),
                (64, 2), (64, 4), (512, 2))
# the kernel's own shape with parts of its work switched off (VLOAM_RG_PART)
PARTS = ((1, "launch only"), (2, "index loads and stores, no row loads"))


def make(nb: int = NB, width: int = W, n_rows: int = N_ROWS,
         distinct: int | None = None, seed: int = 0, device="cuda"):
    """A random table [nb, width] and int64 row ids [n_rows] in range,
    drawn from `distinct` random rows if given (each once if `distinct` is
    n_rows)."""
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((nb, width), generator=g)
    if distinct is None:
        idx = torch.randint(0, nb, (n_rows,), generator=g)
    else:
        idx = torch.randperm(nb, generator=g)[:distinct]
        if distinct != n_rows:
            idx = idx[torch.randint(0, distinct, (n_rows,), generator=g)]
    return table.to(device), idx.to(device)


def run(nb: int = NB, width: int = W, n_rows: int = N_ROWS,
        runs: int = 30) -> dict:
    """Check the kernel against the plain version (bit-identical) and time
    kernel, ``table[idx]`` and ``index_select``; returns the times in ms."""
    require_cuda()
    table, idx = make(nb, width, n_rows)
    got = kernels.row_gather(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, row_gather_plain(table, idx)):
        raise RuntimeError("row_gather differs from table[idx]")
    variants = {
        "row_gather kernel": lambda: kernels.row_gather(table, idx),
        "table[idx]": lambda: row_gather_plain(table, idx),
        "torch.index_select": lambda: torch.index_select(table, 0, idx),
    }
    bound, by = row_gather_bound(n_rows, width, len(torch.unique(idx)))
    out = {"bound_ms": bound}
    for name, fn in variants.items():
        cold = device_ms(fn, runs, cold=True)
        warm = device_ms(fn, runs, cold=False)
        out[name] = cold
        print(f"{name:20s} [{nb} x {width}] x {n_rows}: {cold * 1e3:8.1f} us "
              f"cold L2, {warm * 1e3:8.1f} us warm ({cold * 1e6 / n_rows:.2f}"
              f" ns/row; bound by {by} {bound * 1e3:.1f} us)", flush=True)
    return out


def _launcher(so: str, table: torch.Tensor, idx: torch.Tensor):
    """A launch of vloam_row_gather from a library built by build_variants."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(so).vloam_row_gather
    fn.argtypes = [p, p, p, i, i, p]
    fn.restype = i

    def launch():
        out = torch.empty((idx.shape[0], table.shape[1]), device=table.device)
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 idx.shape[0], table.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return launch


def _checked(label: str, launch, table, idx) -> None:
    got = launch()
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32),
                       row_gather_plain(table, idx).view(torch.int32)):
        raise RuntimeError(f"{label} differs from table[idx]")


def run_engine_shapes(runs: int = 30) -> dict:
    """The tree's kernel and index_select at the engines' shapes,
    cold L2; returns {(label, shape): ms}."""
    require_cuda()
    out = {}
    for shape, nb, width, n, distinct in ENGINE_SHAPES:
        table, idx = make(nb, width, n, distinct)
        _checked("the tree's row_gather", lambda: kernels.row_gather(
            table, idx), table, idx)
        bound = row_gather_bound(n, width, distinct)[0]
        for label, fn in (("kernel", lambda: kernels.row_gather(table, idx)),
                          ("index_select",
                           lambda: torch.index_select(table, 0, idx))):
            out[label, shape] = device_ms(fn, runs)
        print(f"{shape} {n} x {width} of {nb} ({distinct} distinct rows): "
              f"kernel {out['kernel', shape] * 1e3:.2f} us cold L2, "
              f"index_select {out['index_select', shape] * 1e3:.2f}, bound "
              f"{bound * 1e3:.2f}", flush=True)
    return out


def run_block_shapes(block_shapes=BLOCK_SHAPES, parts=PARTS,
                     runs: int = 30) -> dict:
    """row_gather.cu built with other block shapes, each held to table[idx]
    and timed at the engines' shapes, cold L2, then the first shape with
    each of `parts` ((code, label): VLOAM_RG_PART, not checked); returns
    {(label, shape): ms}."""
    require_cuda()
    inputs = {shape: make(nb, width, n, distinct)
              for shape, nb, width, n, distinct in ENGINE_SHAPES}
    variants = [(f"block shape {b}", {"VLOAM_RG_THREADS": b[0],
                                      "VLOAM_RG_VEC": b[1]}, True)
                for b in block_shapes]
    variants += [(f"block shape {block_shapes[0]}, {label}",
                  {"VLOAM_RG_THREADS": block_shapes[0][0],
                   "VLOAM_RG_VEC": block_shapes[0][1], "VLOAM_RG_PART": code},
                  False) for code, label in parts]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build.build_variants(build.CSRC / "row_gather.cu",
                                    [d for _, d, _ in variants], tmp)
        for (label, _, checked), (so, log) in zip(variants, libs):
            line = []
            for shape, (table, idx) in inputs.items():
                launch = _launcher(so, table, idx)
                if checked:
                    _checked(label, launch, table, idx)
                out[label, shape] = device_ms(launch, runs)
                line.append(f"{shape} {out[label, shape] * 1e3:.2f} us")
            usage = "; ".join(
                f"{k} {u['registers']} registers, {u['spill_stores']} B "
                "spilled" for k, u in build.parse_report(log).items())
            print(f"row_gather {label} (threads a block, 16-byte words a "
                  "thread): " + ", ".join(line) + f" ({usage})", flush=True)
    return out


def run_parent(parent: str, runs: int = 30) -> dict:
    """Another checkout's row_gather.cu beside the tree's at the engines'
    shapes and the measurement shape, cold L2, in turns (parent, tree,
    tree, parent); returns {(label, shape): [ms]}."""
    require_cuda()
    src = Path(parent) / "vloam_tpu_torch" / "kernels" / "csrc" / \
        "row_gather.cu"
    shapes = ENGINE_SHAPES + (("random", NB, W, N_ROWS, None),)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        (so, _), = build.build_variants(src, [{}], tmp)
        for shape, nb, width, n, distinct in shapes:
            table, idx = make(nb, width, n, distinct)
            sides = {"parent": _launcher(so, table, idx),
                     "tree": lambda: kernels.row_gather(table, idx)}
            for label, f in sides.items():
                _checked(f"the {label}'s row_gather", f, table, idx)
            for label in ("parent", "tree", "tree", "parent"):
                out.setdefault((label, shape), []).append(
                    device_ms(sides[label], runs))
            print(f"{shape} {n} x {width} of {nb}: row_gather " + ", ".join(
                f"{label} " + " / ".join(f"{t * 1e3:.2f}"
                                         for t in out[label, shape]) + " us"
                for label in ("parent", "tree"))
                + " cold L2 (in turns: parent, tree, tree, parent)",
                flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", action="store_true",
                    help="also time the kernel with other block shapes")
    ap.add_argument("--parent", help="root of another checkout whose "
                    "row_gather is timed beside the tree's")
    args = ap.parse_args()
    require_cuda()
    print(card_line(), flush=True)
    run()
    run_engine_shapes()
    if args.parent:
        run_parent(args.parent)
    if args.shapes:
        run_block_shapes()


if __name__ == "__main__":
    main()
