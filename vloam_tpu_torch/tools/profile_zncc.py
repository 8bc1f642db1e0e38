"""Where K3 zncc_describe spends its time on the GPU, and how other designs
compare: at the combined engine's shape (a rendered 1242 x 375 camera frame
of the synthetic street, its 2048 Shi-Tomasi keypoints from detect_keypoints
with kitti_hdl64's VO settings), p = 24 and 16, cold and warm L2.

    python -m vloam_tpu_torch.tools.profile_zncc [--parent DIR]

- Designs: kernels/csrc/zncc_describe.cu built alone with other block
  sizes (VLOAM_K3_WARPS), each held to zncc_describe_plain (within 1e-5,
  zero rows identical) before it is timed.
- Parts (VLOAM_K3_PART) of the tree's design: the launch alone on the same
  grid, the loads and sums alone (one float written per keypoint), the
  stores of constant rows alone.
- Floors of the method: copy_ of the same 6.6 MB (image and descriptors at
  p = 24), of half of it (6.6 MB moved), and the padded copy of the image a
  TMA tensor map would need (its row stride a multiple of 16 bytes).
- With --parent DIR, the K3 source of another checkout (e.g. the parent
  commit unpacked with git archive) is built and timed beside the same
  inputs.
- The shape of the p = 24 kernel's machine code, the tree's and, with
  --parent, the other checkout's (cuobjdump -sass): how many global loads,
  float adds, branches and stores it has, and in what order the loads and
  the adds that consume them come.

Times are tools/timing.py::device_ms (cold: the L2 flushed before each
call). Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..config import kitti_hdl64
from ..data import synthetic
from ..kernels import build
from ..vision import features
from .timing import card_line, device_ms, require_cuda, zncc_bound

IMG_W, IMG_H = 1242, 375
SOURCE = build.CSRC / "zncc_describe.cu"

# (label, macros); the first is the tree's design
DESIGNS = (
    ("tree: 4 warps a block", {}),
    ("2 warps a block", {"VLOAM_K3_WARPS": 2}),
    ("8 warps a block", {"VLOAM_K3_WARPS": 8}),
)
PARTS = (("launch only", 1), ("loads and sums", 2), ("stores only", 3))


def frame(seed: int = 0):
    """A rendered camera frame on the card ([375, 1242] f32 in [0, 1],
    uint8-quantized as the engines see it) and its keypoints [2048, 2]."""
    scene = synthetic.urban_scene(seed, extent=80.0)
    K, _, _, velo_T_cam = synthetic.default_cam_calib(IMG_W, IMG_H)
    T = synthetic.drive_trajectory(1, speed=1.1, yaw_rate=0.01)[0]
    img = synthetic.render_camera(scene, T @ velo_T_cam, K, IMG_W, IMG_H)
    u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    img = torch.from_numpy(u8).cuda().to(torch.float32) / 255.0
    xy, _, _ = features.detect_keypoints(img, kitti_hdl64().vo)
    return img.contiguous(), xy.contiguous()


def _launcher(so: str, img, xy, p: int):
    lib = ctypes.CDLL(so)
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.vloam_zncc_describe.argtypes = [v, v, v, i, i, i, i, v]
    lib.vloam_zncc_describe.restype = i
    out = torch.empty((xy.shape[0], p * p), device=img.device)
    H, W = img.shape

    def launch():
        err = lib.vloam_zncc_describe(
            img.data_ptr(), xy.data_ptr(), out.data_ptr(), xy.shape[0], H, W,
            p, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    return launch


def check(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Raise unless got is within 1e-5 of want with the same zero rows;
    returns the largest difference."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (torch.equal((got == 0).all(1), (want == 0).all(1))
            and err <= 1e-5):
        raise RuntimeError(f"{what}: max |err| {err}, zero rows "
                           f"{int((got == 0).all(1).sum())} against "
                           f"{int((want == 0).all(1).sum())}")
    return err


_SHOWN = ("LDG", "FADD", "BRA", "SHFL", "STG", "MUFU", "CALL")


def sass_summary(so: str, match: str) -> str:
    """Counts of global loads, float adds, branches, shuffles, stores,
    special-function and call instructions in the machine code of the
    kernel whose name (as kernels.build.parse_sass gives it) contains
    `match`, and its first 48 of them in order, runs collapsed (LDG x18
    FADD x17 ...)."""
    for name, ins in build.parse_sass(build.sass(so)).items():
        if match not in name:
            continue
        ops = [i.op for i in ins if i.op in _SHOWN]
        runs = []
        for o in ops[:48]:
            if runs and runs[-1][0] == o:
                runs[-1][1] += 1
            else:
                runs.append([o, 1])
        counts = ", ".join(f"{o} {ops.count(o)}" for o in _SHOWN)
        return counts + "; in order: " + " ".join(
            f"{o}{f' x{n}' if n > 1 else ''}" for o, n in runs)
    return f"no kernel matching {match}"


def _times(fn) -> tuple[float, float]:
    return device_ms(fn), device_ms(fn, cold=False)


def run(parent: str | None = None, runs: int = 20) -> dict:
    require_cuda()
    img, xy = frame()
    want = {p: features.zncc_describe_plain(img, xy, p) for p in (24, 16)}
    builds = list(DESIGNS)
    builds += [(f"{DESIGNS[0][0]}, {part}", {"VLOAM_K3_PART": code})
               for part, code in PARTS]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build.build_variants(SOURCE, [d for _, d in builds], tmp)
        print("sass of the tree's p = 24 kernel: "
              + sass_summary(libs[0][0], "zncc_describe_kernel<24>"),
              flush=True)
        if parent:
            src = (Path(parent) / "vloam_tpu_torch" / "kernels" / "csrc"
                   / "zncc_describe.cu")
            builds.append(("parent's kernel", {}))
            libs += build.build_variants(src, [{}], tmp)
            print("sass of the parent's kernel: "
                  + sass_summary(libs[-1][0], "zncc_describe_kernel<24>"),
                  flush=True)
        for (label, d), (so, log) in zip(builds, libs):
            usage = ", ".join(
                f"{name} {u['registers']} registers, {u['spill_stores']} B "
                "spilled" for name, u in build.parse_report(log).items()
                if "<0" not in name)
            line = []
            for p in (24, 16):
                launch = _launcher(so, img, xy, p)
                if "VLOAM_K3_PART" not in d:
                    check(launch(), want[p], f"{label} p={p}")
                out[label, p] = _times(launch)
                line.append(f"p={p} {out[label, p][0] * 1e3:.1f} us cold, "
                            f"{out[label, p][1] * 1e3:.1f} warm")
            print(f"zncc {label}: " + "; ".join(line) + f" ({usage})",
                  flush=True)

    n = img.numel() + xy.shape[0] * 24 * 24
    for label, numel in (("copy_ of 6.6 MB (13.2 MB moved)", n),
                         ("copy_ of 3.3 MB (6.6 MB moved)", n // 2)):
        src = torch.empty(numel, device=img.device)
        dst = torch.empty_like(src)
        out[label] = _times(lambda: dst.copy_(src))
    padded = torch.empty((IMG_H, IMG_W + 2), device=img.device)
    out["padded copy of the image (TMA row stride)"] = _times(
        lambda: padded[:, :IMG_W].copy_(img))
    for label in list(out)[-3:]:
        print(f"floor {label}: {out[label][0] * 1e3:.1f} us cold, "
              f"{out[label][1] * 1e3:.1f} warm", flush=True)
    for p in (24, 16):
        b, by = zncc_bound(xy.shape[0], p, IMG_H, IMG_W)
        print(f"bound p={p}: {b * 1e3:.2f} us by {by}; plain version "
              f"{device_ms(lambda: features.zncc_describe_plain(img, xy, p)) * 1e3:.1f}"
              " us cold", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose K3 "
                    "source is timed beside the tree's")
    args = ap.parse_args()
    require_cuda()
    print(card_line(), flush=True)
    run(args.parent)


if __name__ == "__main__":
    main()
