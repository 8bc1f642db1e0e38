"""Build and load the hand-written CUDA kernels (kernels/csrc/*.cu).

The sources are compiled with nvcc for Hopper (sm_90a), one nvcc process per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ctypes. The build happens at first use, from
the package's own sources, into kernels/build/; the library name carries a
hash of the sources, the headers they may include (csrc/*.cuh) and the flags,
so an edited source or header is rebuilt and a stale library is never loaded.
There is no fallback: without nvcc the build raises.

Run ``python -m vloam_tpu_torch.kernels.build`` to build ahead of time and
print ptxas' register / shared-memory report; ``resource_usage()`` gives the
same per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# -fmad=false: the ring reductions' distances (ring_min2.cu, ring_min1.cu)
# must round like the plain PyTorch versions (separately rounded products and
# sums) for their argmins to match exactly.
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v"]

DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's own prefix

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, then PATH, then the toolkit's
    default install prefix. Raises if none exists."""
    candidates = [Path(os.environ[v]) / "bin" / "nvcc"
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of vloam_tpu_torch are compiled "
        "from kernels/csrc at first use and need the CUDA toolkit (set "
        "CUDA_HOME or put nvcc on PATH). There is no CPU fallback for CUDA "
        "tensors.")


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvloam_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Start every command at once, wait for all; (cmd, rc, output) each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)]


def build() -> Path:
    """Compile the kernels if this source hash has not been built yet;
    returns the library path. ptxas' report goes to a .log beside it."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources()]
        steps = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(src)]
                          for src, o in zip(sources(), objs)])
        if all(rc == 0 for _, rc, _ in steps):
            so = str(Path(tmp) / "lib.so")
            steps += _run_all([[nvcc, *ARCH, "-shared", "-o", so, *objs]])
        report = "".join(" ".join(c) + "\n" + out for c, _, out in steps)
        lib.with_suffix(".log").write_text(report)
        if any(rc != 0 for _, rc, _ in steps):
            raise RuntimeError(f"nvcc failed:\n{report}")
        os.replace(so, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers(.*)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def _kernel_name(mangled: str) -> str:
    """'ring_min2_kernel' or 'select_rings_kernel<10>' from ptxas' mangled
    entry name (its length-prefixed '..._kernel' part and, if it is a
    template, its integer argument)."""
    end = mangled.find("_kernel") + len("_kernel")
    for n in range(len("_kernel"), end):  # the name's length prefix
        if mangled[:end - n].endswith(str(n)):
            arg = re.match(r"ILi(\d+)E", mangled[end:])
            name = mangled[end - n:end]
            return f"{name}<{arg.group(1)}>" if arg else name
    return mangled


def resource_usage(match: str = "") -> dict[str, dict[str, int]]:
    """ptxas' report of the built library, per kernel whose name contains
    `match`: registers a thread, bytes of stack frame, of spill stores and
    loads, and of static shared memory."""
    log = build().with_suffix(".log").read_text()
    out, name = {}, None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            name = _kernel_name(m.group(1))
            out[name] = {"smem": 0}
        elif name and (m := _STACK.search(line)):
            out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                 map(int, m.groups())))
        elif name and (m := _USED.search(line)):
            out[name]["registers"] = int(m.group(1))
            if sm := _SMEM.search(m.group(2)):
                out[name]["smem"] = int(sm.group(1))
    return {k: v for k, v in out.items() if match in k}


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures.
    After the first call this is a dict lookup: the wrappers call it on
    every launch."""
    if _loaded:
        return next(iter(_loaded.values()))
    path = str(build())
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vloam_ring_min2.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.vloam_ring_min2.restype = i
    lib.vloam_ring_min1.argtypes = [p, p, p, p, i, i, i, p]
    lib.vloam_ring_min1.restype = i
    lib.vloam_ring_argmin2.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.vloam_ring_argmin2.restype = i
    lib.vloam_row_gather.argtypes = [p, p, p, i, i, p]
    lib.vloam_row_gather.restype = i
    lib.vloam_select_rings.argtypes = [p, p, p, p, i, i, f, i, i, i, i, p]
    lib.vloam_select_rings.restype = i
    lib.vloam_zncc_describe.argtypes = [p, p, p, i, i, i, i, p]
    lib.vloam_zncc_describe.restype = i
    lib.vloam_error_string.argtypes = [i]
    lib.vloam_error_string.restype = ctypes.c_char_p
    _loaded[path] = lib
    return lib


if __name__ == "__main__":
    out = build()
    print(out)
    print(out.with_suffix(".log").read_text())
