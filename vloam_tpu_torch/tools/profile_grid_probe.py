"""The map's 8-cell probe of both grids on the GPU: the hand-written kernel
(kernels/csrc/grid_probe.cu, one launch for the corner and the surf grid)
beside the plain pair (per grid 8 hashes, a row gather and a permute copy)
and the plain pair's parts, at the engines' shapes.

    python -m vloam_tpu_torch.tools.profile_grid_probe [--parent DIR]

Shapes: 2048 corner queries into [2^17, 96] and 6144 surf queries into
[2^17, 48] float32 bucket tables (cells 2.0 and 2.4 m), once for the single
engine and with 4 streams in flat [4 * 2^17, W] tables for the batch
engine; queries uniform in an 80 m street box, tables half empty. The kernel
is held to the plain pair bit for bit before it is timed. With --parent DIR
it also builds DIR's row_gather.cu (the S2 source of another checkout, e.g.
the parent commit unpacked beside the tree) and times the parent's probe of
both grids (its own composition around its own row gather), in turns
(parent, tree, tree, parent). Prints device times with a cold L2 (the compositions of
hundreds of small kernels also replayed from a CUDA graph: their device
time, where device_ms of the call itself is the host's time to queue them)
and the least time the card could take. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..kernels import build
from ..lidar import batch_mapping as bm
from ..lidar import gridmap
from .kernel_cases import _probe_table
from .timing import (card_line, device_ms, graphed, grid_probe_bound,
                     require_cuda)

NB = 1 << 17
CAPS = (32, 16)
CELLS = (2.0, 2.4)
QUERIES = (2048, 6144)
STREAMS = (1, 4)


def make(streams: int, seed: int = 0, device="cuda"):
    """Per grid (table [streams * NB, 3*cap], queries [streams, Q, 3],
    cell)."""
    rng = np.random.default_rng(seed)
    out = []
    for cap, Q, cell in zip(CAPS, QUERIES, CELLS):
        table = _probe_table(rng, streams * NB, cap, 0.5)
        q = rng.uniform([-80, -80, -3], [80, 80, 5], (streams, Q, 3))
        out.append((torch.from_numpy(table).to(device),
                    torch.from_numpy(q.astype(np.float32)).to(device), cell))
    return out


def _grids(jobs):
    return [bm.BatchFeatureGrid(t, None) for t, _, _ in jobs]


def tree_probe(jobs, streams):
    (gc, gs), ((_, qc, cc), (_, qs, cs)) = _grids(jobs), jobs
    return bm.batch_grid_gather_pair(gc, qc, cc, gs, qs, cs, streams)


def plain_probe(jobs, streams):
    return [bm.batch_grid_gather_plain(g, q, cell, streams)
            for g, (_, q, cell) in zip(_grids(jobs), jobs)]


def parent_probe(jobs, streams, row_gather):
    """The parent's probe: q / cell, the side from the rounded s - c, 8
    hashes, its row gather, the permute copy; per grid."""
    out = []
    for table, q, cell in jobs:
        cap = table.shape[1] // 3
        s = q / cell
        c = torch.floor(s).to(torch.int32)
        off = torch.where(s - c < 0.5, -1, 1).to(torch.int32)
        soff = (torch.arange(streams, device=q.device) * NB)[:, None]
        hs = [gridmap._hash_cell(c[..., 0] + sx * off[..., 0],
                                 c[..., 1] + sy * off[..., 1],
                                 c[..., 2] + sz * off[..., 2], NB) + soff
              for sx in (0, 1) for sy in (0, 1) for sz in (0, 1)]
        rows = row_gather(table, torch.stack(hs, dim=-1).reshape(-1))
        out.append(rows.reshape(-1, 8, 3, cap).permute(2, 0, 1, 3)
                   .reshape(3, -1, 8 * cap))
    return out


def _parent_row_gather(parent: str, tmp: str):
    src = Path(parent) / "vloam_tpu_torch" / "kernels" / "csrc" / \
        "row_gather.cu"
    (so, _), = build.build_variants(src, [{}], tmp)
    fn = ctypes.CDLL(so).vloam_row_gather
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, p]
    fn.restype = i

    def row_gather(table, idx):
        out = torch.empty((len(idx), table.shape[1]), device=table.device)
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), len(idx),
                 table.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    return row_gather


def _equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def run(parent: str | None = None, runs: int = 20) -> dict:
    require_cuda()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        row_gather = _parent_row_gather(parent, tmp) if parent else None
        for streams in STREAMS:
            jobs = make(streams)
            got = tree_probe(jobs, streams)
            torch.cuda.synchronize()
            if not _equal(got, plain_probe(jobs, streams)):
                raise RuntimeError("grid_probe differs from the plain pair")
            ids = [gridmap.probe_buckets(q, cell, NB)
                   + (torch.arange(streams, device=q.device) * NB)[:, None,
                                                                   None]
                   for _, q, cell in jobs]
            bound, by = grid_probe_bound(
                [(q.numel() // 3, cap, len(torch.unique(i)))
                 for (_, q, _), cap, i in zip(jobs, CAPS, ids)])
            rows = [gridmap.row_gather(t, i.reshape(-1))
                    for (t, _, _), i in zip(jobs, ids)]
            variants = {
                "grid_probe kernel": lambda: tree_probe(jobs, streams),
                "plain pair": lambda: plain_probe(jobs, streams),
                "plain pair, graphed": graphed(
                    lambda: plain_probe(jobs, streams)),
                "its row_gather x2": lambda: [
                    gridmap.row_gather(t, i.reshape(-1))
                    for (t, _, _), i in zip(jobs, ids)],
                "its permute copy x2": lambda: [
                    r.reshape(-1, 8, 3, cap).permute(2, 0, 1, 3)
                    .reshape(3, -1, 8 * cap) for r, cap in zip(rows, CAPS)],
            }
            order = list(variants)
            if row_gather:
                variants["parent's probe"] = lambda: parent_probe(
                    jobs, streams, row_gather)
                if not _equal(variants["parent's probe"](), got):
                    print("the parent's probe differs from the kernel's on "
                          "these queries (its neighbour side rounds s - c)",
                          flush=True)
                variants["parent's probe, graphed"] = graphed(
                    variants["parent's probe"])
                order = ["parent's probe", "grid_probe kernel",
                         "grid_probe kernel", "parent's probe",
                         "parent's probe, graphed"] + order[1:]
            what = (f"{streams} stream(s): " + ", ".join(
                f"{streams * Q} queries x 8 cells of cap {cap}"
                for Q, cap in zip(QUERIES, CAPS)))
            for label in order:
                ms = device_ms(variants[label], runs)
                out.setdefault((label, streams), []).append(ms)
                print(f"{what}: {label:20s} {ms * 1e3:8.1f} us cold L2 "
                      f"(bound by {by} {bound * 1e3:.1f} us)", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose probe "
                    "(with its row_gather.cu) is timed beside the tree's")
    args = ap.parse_args()
    require_cuda()
    print(card_line(), flush=True)
    run(args.parent)


if __name__ == "__main__":
    main()
