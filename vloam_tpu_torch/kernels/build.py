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
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# -fmad=false: the ring reductions' and the k-NN's distances (ring_min2.cu,
# ring_min1.cu, knn.cu; the packed form's fused multiply-adds are explicit)
# must round like the plain PyTorch versions (separately rounded products
# and sums) for their argmins to match exactly.
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v"]

# a measurement switch (VLOAM_S1_PART, VLOAM_RG_PART, VLOAM_K3_PART,
# VLOAM_KNN_PART) set to anything but 0
_PART = re.compile(r"-DVLOAM_\w+_PART=(?!0$)")

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


def measurement_defines(words) -> list[str]:
    """The words (nvcc flags, or a build log split into words) that set a
    measurement switch: a VLOAM_*_PART macro other than 0, which cuts a
    kernel's work for the measurement tools (build_variants) and must never
    reach the library the wrappers load."""
    return [w for w in words if _PART.match(w)]


def build() -> Path:
    """Compile the kernels if this source hash has not been built yet;
    returns the library path. ptxas' report goes to a .log beside it."""
    if parts := measurement_defines(NVCC_FLAGS):
        raise RuntimeError(f"the kernels' library would be built with "
                           f"measurement switches {parts}: those belong to "
                           "build_variants only")
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


def build_variants(src: Path, defines: list[dict[str, int]],
                   out_dir: str) -> list[tuple[str, str]]:
    """Compile one source alone into a shared library per set of macros
    (`-D<name>=<value>`), all nvcc processes at once, into out_dir; returns
    (library path, nvcc and ptxas output) for each. For the measurement
    tools, which time a kernel with other design constants. Raises if a
    build fails."""
    nvcc = find_nvcc()
    out_dir = tempfile.mkdtemp(dir=out_dir)  # no name clashes between calls
    libs = [str(Path(out_dir) / f"{src.stem}_{i}.so")
            for i in range(len(defines))]
    steps = _run_all([[nvcc, *NVCC_FLAGS, "-shared",
                       *(f"-D{k}={v}" for k, v in d.items()), "-o", so,
                       str(src)] for d, so in zip(defines, libs)])
    for cmd, rc, out in steps:
        if rc:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    return [(so, out) for so, (_, _, out) in zip(libs, steps)]


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers(.*)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def _kernel_name(mangled: str) -> str:
    """'ring_min2_kernel' or 'select_rings_kernel<10>' from ptxas' mangled
    entry name (its length-prefixed '..._kernel' part and, if it is a
    template, its integer and bool arguments:
    'ring_min1_packed_kernel<1,1,4,4,4>')."""
    end = mangled.find("_kernel") + len("_kernel")
    for n in range(len("_kernel"), end):  # the name's length prefix
        if mangled[:end - n].endswith(str(n)):
            args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
            name = mangled[end - n:end]
            if not args:
                return name
            values = re.findall(r"L[ib](\d+)E", args.group(1))
            return f"{name}<{','.join(values)}>"
    return mangled


def resource_usage(match: str = "") -> dict[str, dict[str, int]]:
    """ptxas' report of the built library, per kernel whose name contains
    `match`: registers a thread, bytes of stack frame, of spill stores and
    loads, and of static shared memory."""
    usage = parse_report(build().with_suffix(".log").read_text())
    return {k: v for k, v in usage.items() if match in k}


def parse_report(log: str) -> dict[str, dict[str, int]]:
    """resource_usage's table from the text of a ptxas -v report."""
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
    return out


_SASS_OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9]*)((?:\.[A-Z0-9.]+)?)\s*([^;]*);")


class Ins(NamedTuple):
    """One machine instruction: address, opcode without its modifiers,
    operands, whether a predicate guards it, the modifiers (".128")."""
    addr: int
    op: str
    args: str
    pred: bool
    mods: str


def cuobjdump() -> str:
    """cuobjdump beside the nvcc that builds the kernels."""
    return str(Path(find_nvcc()).parent / "cuobjdump")


def sass(so: str | Path) -> str:
    """The machine code of a built library, as cuobjdump -sass prints it."""
    return subprocess.run([cuobjdump(), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout


def parse_sass(text: str) -> dict[str, list[Ins]]:
    """Per kernel (named as resource_usage names them) its instructions in
    order."""
    out = {}
    for part in text.split("Function : ")[1:]:
        name = _kernel_name(part.split(None, 1)[0])
        out[name] = [Ins(int(a, 16), op, args.strip(), bool(p), mods)
                     for a, p, op, mods, args in _SASS_OP.findall(part)]
    return out


def hottest_loop(ins: list[Ins]) -> list[str]:
    """The opcodes of a kernel's main loop on its hot path: of its loops
    (each a backward branch's target), taken by the shortest way back to
    the head, the one that loads the most bytes from shared memory (LDS,
    LDS.64, LDS.128), and of those the shortest (an inner loop before the
    loop around it). A
    forward branch inside the loop, to an examination that runs only at
    times, is left out wherever the compiler put its target."""
    at = {i.addr: n for n, i in enumerate(ins)}
    succ, heads = [], set()
    for n, i in enumerate(ins):
        nxt = [n + 1] if n + 1 < len(ins) else []
        m = re.match(r"(0x[0-9a-f]+)", i.args)
        if i.op == "BRA" and m and int(m.group(1), 16) in at:
            t = at[int(m.group(1), 16)]
            succ.append([t] + (nxt if i.pred else []))
            if t <= n:
                heads.add(t)
        else:
            succ.append([] if i.op in ("EXIT", "RET") and not i.pred
                        else nxt)
    best, score = [], (0, 0)
    for h in sorted(heads):
        parent, frontier, last = {h: h}, [h], None
        while frontier and last is None:  # breadth first back to h
            step = []
            for n in frontier:
                if h in succ[n]:
                    last = n
                    break
                for s in succ[n]:
                    if s not in parent:
                        parent[s] = n
                        step.append(s)
            frontier = step
        if last is None:
            continue
        cycle = [last]
        while cycle[-1] != h:
            cycle.append(parent[cycle[-1]])
        cycle.reverse()
        lds = sum(_lds_bytes(ins[n]) for n in cycle)
        if (lds, -len(cycle)) > score:
            best, score = [ins[n].op for n in cycle], (lds, -len(cycle))
    return best


def _lds_bytes(i: Ins) -> int:
    if i.op != "LDS":
        return 0
    return 16 if ".128" in i.mods else 8 if ".64" in i.mods else 4


def packed_sass(text: str) -> tuple[list[str], list[str]]:
    """ring_min1_packed_kernel's instantiations in machine code (cuobjdump
    -sass text): per instantiation its instructions in all, in its main slot
    loop and per (query, slot) pair there, and its F2I conversions. Returns
    the lines and the instantiations of the fast path (second template
    argument 1) that convert, which must be none."""
    lines, converting = [], []
    for name, ins in sorted(parse_sass(text).items()):
        if not name.startswith("ring_min1_packed_kernel<"):
            continue
        product, fast, qpt, _, unroll = map(
            int, name[name.index("<") + 1:-1].split(","))
        ops = [i.op for i in ins]
        loop = hottest_loop(ins)
        f2i = ops.count("F2I")
        lines.append(f"{name} ({'product' if product else 'difference'}, "
                     f"{'fast' if fast else 'conversion'}) {len(ops)} "
                     f"instructions, main loop {len(loop)} for {unroll} "
                     f"slots x {qpt} queries = "
                     f"{len(loop) / (unroll * qpt):.2f} a pair, F2I {f2i}")
        if fast and f2i:
            converting.append(name)
    return lines, converting


KNN_STEP = 16  # slots knn.cu's main loop tests a step (kStep)

def knn_sass(text: str) -> tuple[list[str], dict[int, float]]:
    """knn_slice_kernel's instantiations in machine code (cuobjdump -sass
    text): per k its instructions in all and on its main loop's hot path
    (hottest_loop: KNN_STEP slots a step, none passing) and per (query,
    slot) pair there. Returns the lines and the instructions a pair by k."""
    lines, per_pair = [], {}
    for name, ins in parse_sass(text).items():
        if not name.startswith("knn_slice_kernel<"):
            continue
        k = int(name[name.index("<") + 1:-1])
        loop = hottest_loop(ins)
        per_pair[k] = len(loop) / KNN_STEP
        lines.append((k, f"{name} {len(ins)} instructions, main loop "
                      f"{len(loop)} for {KNN_STEP} slots = "
                      f"{per_pair[k]:.2f} a pair"))
    return [line for _, line in sorted(lines)], per_pair


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
    lib.vloam_ring_min1_packed.argtypes = [p, p, p, p, i, i, i, i, i, f, f,
                                           p]
    lib.vloam_ring_min1_packed.restype = i
    lib.vloam_ring_argmin2.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.vloam_ring_argmin2.restype = i
    lib.vloam_row_gather.argtypes = [p, p, p, i, i, p]
    lib.vloam_row_gather.restype = i
    lib.vloam_grid_probe.argtypes = [p, p, p, i, i, i, i, f] * 2 + [p]
    lib.vloam_grid_probe.restype = i
    lib.vloam_select_rings.argtypes = [p, p, p, p, i, i, f, i, i, i, i, p]
    lib.vloam_select_rings.restype = i
    lib.vloam_zncc_describe.argtypes = [p, p, p, i, i, i, i, p]
    lib.vloam_zncc_describe.restype = i
    lib.vloam_masked_knn.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p]
    lib.vloam_masked_knn.restype = i
    lib.vloam_error_string.argtypes = [i]
    lib.vloam_error_string.restype = ctypes.c_char_p
    _loaded[path] = lib
    return lib


if __name__ == "__main__":
    out = build()
    print(out)
    print(out.with_suffix(".log").read_text())
