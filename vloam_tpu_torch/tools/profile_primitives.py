"""What the kernels' building blocks cost on the GPU: latencies of the warp
primitives behind K1's pick round (redux.sync, shuffles, ballot, a
shared-memory load, dependent float ops, a divergent branch), in SM cycles,
and the rate of unfused float multiply + add (K2's distance loop) per SM
scheduler.

    python -m vloam_tpu_torch.tools.profile_primitives

Compiles tools/csrc/primitives.cu with nvcc into a temporary directory (with
-fmad=false, as the kernels are built) and runs it. Needs a GPU and nvcc.
"""

from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

from ..kernels import build
from .timing import card_line, require_cuda

SOURCE = Path(__file__).resolve().parent / "csrc" / "primitives.cu"


def main() -> None:
    require_cuda()
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        exe = str(Path(tmp) / "primitives")
        subprocess.run([build.find_nvcc(), *build.ARCH, "-std=c++17", "-O3",
                        "-fmad=false", "-o", exe, str(SOURCE)], check=True)
        subprocess.run([exe], check=True)


if __name__ == "__main__":
    main()
