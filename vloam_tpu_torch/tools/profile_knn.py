"""The mesh window sweep's k-NN: the hand-written kernel
(kernels/csrc/knn.cu) beside its plain version, by the parts of its design,
at other slice counts and with its queries ordered in space.

    python -m vloam_tpu_torch.tools.profile_knn [--parent DIR]

Windows laid out as parallel/mesh_fused.py::_window_block lays them out
(kernel_cases.knn_window: the rows nearest the centre first, ~1400 of 4096
rows live, each row one 2 m cell of 1-12 points, the rest masked at the
map's 1e6): corner 2048 queries x 4096 * 32 slots, surf 6144 x 4096 * 16,
k = 5. knn.cu is built two ways (build_variants): as the library is
built, and the main loop alone with no examination (VLOAM_KNN_PART=1: a
measurement, its output is not the k-NN). --parent DIR adds DIR's knn.cu
(another checkout, an earlier design of the kernel) as built there. Each
is timed at 2, 4, 6, 8, 12 and 16 slice blocks an SM, in two turns, all
but the main loop checked bit for bit against the plain version first;
beside them the plain version's time, the bound and the issue floor at
the machine code's instructions a pair (kernels.build.knn_sass), over
every slot and over the live pairs, and the kernel as built with every
slot masked (its staging, merge and launches alone).

Then the queries ordered by their 2 m cell (a sort, the kernel on the
permuted queries, the results scattered back: three more launches) against
the kernel as built, at the two windows and at tools/bench_knn.py's four
shapes, at the wrapper's slices; the ordered results checked identical.
Needs a GPU.
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
from ..lidar.knn import _padding, masked_knn, masked_knn_plain
from . import bench_knn
from .kernel_cases import knn_window
from .timing import (card_line, device_ms, knn_bound, knn_issue_floor,
                     require_cuda)

SHAPES = (("corner", 2048, 32), ("surf", 6144, 16))  # (grid, Q, slots a row)
BLOCKS_PER_SM = (2, 4, 6, 8, 12, 16)
K = 5
# (label, macros, checked against the plain version)
VARIANTS = (("as built", {}, True),
            ("main loop alone", {"VLOAM_KNN_PART": 1}, False))
CELL = 2.0  # m: the mesh map's cell, the queries' order


def launcher(so: str, k: int = K):
    """vloam_masked_knn from a library built by build_variants (or
    build.build), called as kernels.masked_knn calls the package's: (q, c,
    m, pad, blocks_per_sm) -> (d, idx), or at `slices` slices where given.
    The scratch holds the shared bounds too (an older kernel reads only its
    first part)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(so).vloam_masked_knn
    fn.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p]
    fn.restype = i

    def launch(q, c, m, pad, blocks_per_sm, slices=None):
        Q, C = q.shape[0], c.shape[0]
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        if slices is None:
            slices = kernels.knn_slices(Q, C + pad, n_sm, blocks_per_sm)
        scratch = torch.empty(kernels.knn_scratch(slices, k, Q),
                              dtype=torch.int32, device=q.device)
        d = torch.empty((Q, k), device=q.device)
        idx = torch.empty((Q, k), dtype=torch.int64, device=q.device)
        err = fn(q.data_ptr(), c.data_ptr(), m.data_ptr(), Q, C, k, pad,
                 slices, scratch.data_ptr(), d.data_ptr(), idx.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return d, idx
    return launch


def cell_order(q: torch.Tensor) -> torch.Tensor:
    """The permutation that orders queries [Q, 3] by their CELL-metre cell
    (x cell, then y, then z)."""
    cell = torch.floor(q / CELL).to(torch.int64) + (1 << 20)
    key = (cell[:, 0] << 42) | (cell[:, 1] << 21) | cell[:, 2]
    return torch.argsort(key)


def ordered_knn(q, c, m, k: int = K):
    """masked_knn with the queries ordered by cell_order and the results
    scattered back to the callers' order."""
    perm = cell_order(q)
    d, i = masked_knn(q[perm], c, m, k=k)
    out_d, out_i = torch.empty_like(d), torch.empty_like(i)
    out_d[perm] = d
    out_i[perm] = i
    return out_d, out_i


def _same(a, b) -> bool:
    return torch.equal(a[1], b[1]) and torch.equal(
        a[0].view(torch.int32), b[0].view(torch.int32))


def _bounds(Q: int, C: int, live: int, per_pair: float) -> str:
    (b_all, by_all), (b_live, by_live) = (knn_bound(Q, C, K),
                                          knn_bound(Q, C, K, live=live))
    return (f"bound {b_all * 1e3:.1f} us ({by_all}) over every slot, "
            f"{b_live * 1e3:.1f} us ({by_live}) over the live pairs; issue "
            f"floor {knn_issue_floor(Q, C, per_pair) * 1e3:.1f} / "
            f"{knn_issue_floor(Q, C, per_pair, live=live) * 1e3:.1f} us at "
            f"{per_pair:.2f} instructions a pair")


def _windows(dev, rng, variants, launches, per_pair, n_sm) -> None:
    for name, Q, cap in SHAPES:
        case = knn_window(rng, Q=Q, cap=cap)
        q, c, m = (torch.from_numpy(a).to(dev)
                   for a in (case.queries, case.cands, case.mask))
        C, live = c.shape[0], int(case.mask.sum())
        pad = _padding(C, K)
        want = masked_knn_plain(q, c, m, K)
        for (label, _, checked), launch in zip(variants, launches):
            for b in BLOCKS_PER_SM if checked else ():
                if not _same(launch(q, c, m, pad, b), want):
                    raise RuntimeError(f"{name}: {label} at {b} blocks an "
                                       "SM differs from the plain version")
        times = {}
        for turn in (0, 1):
            for v, launch in enumerate(launches):
                for b in BLOCKS_PER_SM[::1 - 2 * turn]:
                    times.setdefault((v, b), []).append(device_ms(
                        lambda: launch(q, c, m, pad, b), runs=20,
                        cold=False))
        plain = device_ms(lambda: masked_knn_plain(q, c, m, K), runs=5,
                          cold=False)
        none = torch.zeros_like(m)  # every slot masked: staging and merge
        empty = [device_ms(lambda: launch(q, c, none, pad, b), runs=20,
                           cold=False) for launch in launches[:1]
                 for b in BLOCKS_PER_SM]
        print(f"{name} {Q} x {C} ({live} live), k = {K}; plain version "
              f"{plain:.3f} ms; " + _bounds(Q, C, live, per_pair)
              + "; as built with every slot masked (staging, merge, "
              "launches) by slice blocks an SM: " + "; ".join(
                  f"{b} {t * 1e3:.1f} us" for b, t in zip(BLOCKS_PER_SM,
                                                          empty)),
              flush=True)
        for v, (label, _, checked) in enumerate(variants):
            print(f"  {label}"
                  + (" (identical to the plain version)" if checked
                     else "") + ": us a call by slice blocks an SM "
                  "(slices; two turns): " + "; ".join(
                      f"{b} ({kernels.knn_slices(Q, C + pad, n_sm, b)}): "
                      + " / ".join(f"{t * 1e3:.1f}" for t in times[v, b])
                      for b in BLOCKS_PER_SM), flush=True)


def _query_order(dev, rng, per_pair) -> None:
    """The kernel as built against ordered_knn, in turns, at the windows
    and at bench_knn's shapes."""
    cases = []
    for name, Q, cap in SHAPES:
        case = knn_window(rng, Q=Q, cap=cap)
        cases.append((f"{name} window", case.queries, case.cands, case.mask))
    for name, _, _, q, c, m in bench_knn.inputs():
        cases.append((f"bench_knn {name}", q, c, m))
    for name, *arrays in cases:
        q, c, m = (torch.from_numpy(a).to(dev) for a in arrays)
        Q, C, live = q.shape[0], c.shape[0], int(m.sum())
        same = _same(ordered_knn(q, c, m), masked_knn(q, c, m, k=K))
        ms = {"as built": [], "ordered": []}
        for turn in range(4):  # as built, ordered, ordered, as built
            label = ("as built", "ordered")[turn in (1, 2)]
            fn = (lambda: masked_knn(q, c, m, k=K)) if label == "as built" \
                else (lambda: ordered_knn(q, c, m))
            ms[label].append(device_ms(fn, runs=20, cold=False))
        sort_ms = device_ms(lambda: cell_order(q), runs=20, cold=False)
        print(f"queries by {CELL:g} m cell, {name} {Q} x {C} ({live} live): "
              f"as built {' / '.join(f'{t * 1e3:.1f}' for t in ms['as built'])}"
              f" us, ordered (sort, kernel, scatter) "
              f"{' / '.join(f'{t * 1e3:.1f}' for t in ms['ordered'])} us, "
              f"the sort alone {sort_ms * 1e3:.1f} us; ordered results "
              + ("identical" if same else "DIFFER") + "; "
              + _bounds(Q, C, live, per_pair), flush=True)
        if not same:
            raise RuntimeError(f"{name}: the ordered queries' k-NN differs")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="profile_knn",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout: its knn.cu as built")
    args = ap.parse_args(argv)
    dev = require_cuda()
    print(card_line(), flush=True)
    lines, per_pair = build.knn_sass(build.sass(build.build()))
    print("; ".join(lines), flush=True)
    rng = np.random.default_rng(16837)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    variants = list(VARIANTS)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build.build_variants(build.CSRC / "knn.cu",
                                    [d for _, d, _ in variants], tmp)
        if args.parent:
            src = (Path(args.parent) / "vloam_tpu_torch" / "kernels" / "csrc"
                   / "knn.cu")
            libs += build.build_variants(src, [{}], tmp)
            variants.append((f"{args.parent}'s knn.cu", {}, True))
        for (label, _, _), (so, log) in zip(variants, libs):
            _, pairs = build.knn_sass(build.sass(so))
            usage = build.parse_report(log).get("knn_slice_kernel<5>", {})
            print(f"{label}: knn_slice_kernel<5> {usage.get('registers')} "
                  f"registers, {usage.get('spill_stores')} B spilled, "
                  f"{usage.get('smem')} B shared, main loop {pairs[K]:.2f} "
                  "instructions a pair", flush=True)
        launches = [launcher(so) for so, _ in libs]
        _windows(dev, rng, variants, launches, per_pair[K], n_sm)
    _query_order(dev, rng, per_pair[K])


if __name__ == "__main__":
    main()
