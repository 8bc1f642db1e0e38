"""Row gather from a [2^17, 96] float32 table resident in device memory: the
hand-written kernel (kernels/csrc/row_gather.cu) beside ``table[idx]`` and
``torch.index_select`` on the same inputs.

    python -m vloam_tpu_torch.tools.profile_row_gather

The counterpart of scripts/profile_pallas_gather.py, at its shapes: 65536 rows
of 384 B (the corner grid's row; about one frame's mapping probes). Prints
device time per call with a cold and with a warm L2 and the least time the
card could take. Needs a GPU.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..lidar.gridmap import row_gather_plain
from .timing import card_line, device_ms, require_cuda, row_gather_bound

NB = 1 << 17
W = 3 * 32  # 96 f32 = 384 B rows (the corner grid's row)
N_ROWS = 65536


def make(nb: int = NB, width: int = W, n_rows: int = N_ROWS, seed: int = 0,
         device="cuda"):
    """A random table [nb, width] and int64 row ids [n_rows] in range."""
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((nb, width), generator=g)
    idx = torch.randint(0, nb, (n_rows,), generator=g)
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


def main() -> None:
    require_cuda()
    print(card_line(), flush=True)
    run()


if __name__ == "__main__":
    main()
