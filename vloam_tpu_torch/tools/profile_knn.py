"""The mesh window sweep's k-NN: the hand-written kernel
(kernels/csrc/knn.cu) beside its plain version, at the mesh engine's window
shapes, at other slice counts and main-loop steps.

    python -m vloam_tpu_torch.tools.profile_knn

Windows laid out as parallel/mesh_fused.py::_window_block lays them out
(kernel_cases.knn_window: the rows nearest the centre first, ~1400 of 4096
rows live, each row one 2 m cell of 1-12 points, the rest masked at the
map's 1e6): corner 2048 queries x 4096 * 32 slots, surf 6144 x 4096 * 16,
k = 5. knn.cu is built four ways (build_variants): as the library is
built (16 slots a main-loop step), with steps of 8 and of 4 slots
(VLOAM_KNN_STEP), and its main loop alone with no examination
(VLOAM_KNN_PART=1: a measurement, its output is not the k-NN). Each is
timed at 2, 3, 4, 6 and 8 slice blocks an SM, in two turns, all but the
last checked bit for bit against the plain version first; beside them the
plain version's time, the bound and the issue floor at the machine code's
instructions a pair (kernels.build.knn_sass). Needs a GPU.
"""

from __future__ import annotations

import ctypes
import tempfile

import numpy as np
import torch

from .. import kernels
from ..kernels import build
from ..lidar.knn import _padding, masked_knn_plain
from .kernel_cases import knn_window
from .timing import (card_line, device_ms, knn_bound, knn_issue_floor,
                     require_cuda)

SHAPES = (("corner", 2048, 32), ("surf", 6144, 16))  # (grid, Q, slots a row)
BLOCKS_PER_SM = (2, 3, 4, 6, 8)
K = 5
# (label, macros, checked against the plain version)
VARIANTS = (("as built", {}, True),
            ("steps of 8 slots", {"VLOAM_KNN_STEP": 8}, True),
            ("steps of 4 slots", {"VLOAM_KNN_STEP": 4}, True),
            ("main loop alone", {"VLOAM_KNN_PART": 1}, False))


def _launcher(so: str):
    """vloam_masked_knn from a library built by build_variants, called as
    kernels.masked_knn calls the package's: (q, c, m, pad, blocks_per_sm)
    -> (d, idx)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(so).vloam_masked_knn
    fn.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p]
    fn.restype = i

    def launch(q, c, m, pad, blocks_per_sm):
        Q, C = q.shape[0], c.shape[0]
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        slices = kernels.knn_slices(Q, C + pad, n_sm, blocks_per_sm)
        scratch = torch.empty(2 * slices * K * Q, dtype=torch.int32,
                              device=q.device)
        d = torch.empty((Q, K), device=q.device)
        idx = torch.empty((Q, K), dtype=torch.int64, device=q.device)
        err = fn(q.data_ptr(), c.data_ptr(), m.data_ptr(), Q, C, K, pad,
                 slices, scratch.data_ptr(), d.data_ptr(), idx.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return d, idx
    return launch


def main() -> None:
    dev = require_cuda()
    print(card_line(), flush=True)
    lines, per_pair = build.knn_sass(build.sass(build.build()))
    print("; ".join(lines), flush=True)
    rng = np.random.default_rng(16837)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        libs = build.build_variants(build.CSRC / "knn.cu",
                                    [d for _, d, _ in VARIANTS], tmp)
        for (label, defs, _), (so, log) in zip(VARIANTS, libs):
            _, pairs = build.knn_sass(build.sass(so))
            step = defs.get("VLOAM_KNN_STEP", build.KNN_STEP)
            usage = build.parse_report(log).get("knn_slice_kernel<5>", {})
            print(f"{label}: knn_slice_kernel<5> {usage.get('registers')} "
                  f"registers, {usage.get('spill_stores')} B spilled, main "
                  f"loop {pairs[K] * build.KNN_STEP / step:.2f} instructions "
                  "a pair", flush=True)
        launches = [_launcher(so) for so, _ in libs]
        for name, Q, cap in SHAPES:
            case = knn_window(rng, Q=Q, cap=cap)
            q, c, m = (torch.from_numpy(a).to(dev)
                       for a in (case.queries, case.cands, case.mask))
            C = c.shape[0]
            pad = _padding(C, K)
            d_p, i_p = masked_knn_plain(q, c, m, K)
            for (label, _, checked), launch in zip(VARIANTS, launches):
                for b in BLOCKS_PER_SM if checked else ():
                    d, i = launch(q, c, m, pad, b)
                    if not (torch.equal(i, i_p) and torch.equal(
                            d.view(torch.int32), d_p.view(torch.int32))):
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
            bound, by = knn_bound(Q, C, K)
            floor = knn_issue_floor(Q, C, per_pair[K])
            print(f"{name} {Q} x {C} ({int(m.sum())} live), k = {K}; plain "
                  f"version {plain:.3f} ms; bound {bound * 1e3:.1f} us ({by});"
                  f" issue floor {floor * 1e3:.1f} us at {per_pair[K]:.2f} "
                  "instructions a pair", flush=True)
            for v, (label, _, checked) in enumerate(VARIANTS):
                print(f"  {label}"
                      + (" (identical to the plain version)" if checked
                         else "") + ": us a call by slice blocks an SM "
                      "(slices; two turns): " + "; ".join(
                          f"{b} ({kernels.knn_slices(Q, C + pad, n_sm, b)}): "
                          + " / ".join(f"{t * 1e3:.1f}" for t in times[v, b])
                          for b in BLOCKS_PER_SM), flush=True)


if __name__ == "__main__":
    main()
