"""Hand-written Hopper kernels and their launch wrappers.

K1 select_rings  (csrc/select_rings.cu) <- scan_registration.py::
                 _select_rings_pallas_kernel (strict sector selection)
K2 ring_min2     (csrc/ring_min2.cu)    <- ring_assoc.py::_ring_min2_kernel
                 (per-ring min-2 behind LO association)
K3 zncc_describe (csrc/zncc_describe.cu) <- vision/features.py::
                 _describe_zncc_pallas (ZNCC patch descriptors)

The wrappers here accept CUDA tensors only: they check device, dtype, shape
and contiguity, allocate outputs with torch.empty, launch on PyTorch's
current stream and raise if the launch is refused. The CPU dispatch to the
plain PyTorch versions lives in the callers (lidar/scan_registration.py,
lidar/ring_assoc.py, vision/features.py) and is taken only for CPU
tensors.

``LAUNCHES`` counts launches per kernel; each wrapper adds one exactly
where its kernel is launched.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = {"select_rings": 0, "ring_min2": 0, "zncc_describe": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {dtype} required, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {ndim}-d tensor required, got {t.shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor required")


def _check(lib, err: int, kernel: str) -> None:
    if err != 0:
        msg = lib.vloam_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def ring_min2(queries: torch.Tensor, slab_t: torch.Tensor):
    """K2 on the card: queries [Q, 3] f32, slab_t [S, 3, C] f32 ->
    (dmin [S, Q] f32, amin [S, Q] int32, d2 [S, Q] f32, a2 [S, Q] int32)."""
    _require(queries, "queries", torch.float32, 2)
    _require(slab_t, "slab_t", torch.float32, 3)
    Q, S, C = queries.shape[0], slab_t.shape[0], slab_t.shape[2]
    if queries.shape[1] != 3 or slab_t.shape[1] != 3:
        raise ValueError(f"ring_min2: bad shapes {queries.shape} "
                         f"{slab_t.shape}")
    if C < 2:
        raise ValueError("ring_min2: a ring needs at least 2 slots")
    if queries.device != slab_t.device:
        raise ValueError("ring_min2: inputs on different devices")
    lib = build.load()
    dev = queries.device
    dmin = torch.empty((S, Q), dtype=torch.float32, device=dev)
    amin = torch.empty((S, Q), dtype=torch.int32, device=dev)
    d2 = torch.empty((S, Q), dtype=torch.float32, device=dev)
    a2 = torch.empty((S, Q), dtype=torch.int32, device=dev)
    if Q == 0 or S == 0:
        return dmin, amin, d2, a2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vloam_ring_min2(
            queries.data_ptr(), slab_t.data_ptr(), dmin.data_ptr(),
            amin.data_ptr(), d2.data_ptr(), a2.data_ptr(), Q, S, C, stream)
    _check(lib, err, "ring_min2")
    LAUNCHES["ring_min2"] += 1
    return dmin, amin, d2, a2


def select_rings(curv: torch.Tensor, bf: torch.Tensor, counts: torch.Tensor,
                 thr: float, n_sectors: int, n_sharp: int, n_corner: int,
                 n_flat: int) -> torch.Tensor:
    """K1 on the card: curv [S, R] f32, bf [S, R] int32 (break prefix),
    counts [S] int32 -> label [S, R] int32 (2 / 1 / -1 / 0)."""
    _require(curv, "curv", torch.float32, 2)
    _require(bf, "bf", torch.int32, 2)
    _require(counts, "counts", torch.int32, 1)
    S, R = curv.shape
    if bf.shape != curv.shape or counts.shape[0] != S:
        raise ValueError(f"select_rings: bad shapes {curv.shape} {bf.shape} "
                         f"{counts.shape}")
    if not (curv.device == bf.device == counts.device):
        raise ValueError("select_rings: inputs on different devices")
    lib = build.load()
    label = torch.empty((S, R), dtype=torch.int32, device=curv.device)
    if S == 0 or R == 0:
        return label
    with torch.cuda.device(curv.device):
        stream = torch.cuda.current_stream(curv.device).cuda_stream
        err = lib.vloam_select_rings(
            curv.data_ptr(), bf.data_ptr(), counts.data_ptr(),
            label.data_ptr(), S, R, float(thr), n_sectors, n_sharp, n_corner,
            n_flat, stream)
    _check(lib, err, "select_rings")
    LAUNCHES["select_rings"] += 1
    return label


def zncc_describe(img: torch.Tensor, xy: torch.Tensor, p: int) -> torch.Tensor:
    """K3 on the card: img [H, W] f32, xy [K, 2] f32 pixel coordinates
    (x, y) -> descriptors [K, p*p] f32 (zero rows for patches whose centred
    norm is below 1e-3). 1 <= p <= 32 and p <= H, W."""
    _require(img, "img", torch.float32, 2)
    _require(xy, "xy", torch.float32, 2)
    H, W = img.shape
    K = xy.shape[0]
    if xy.shape[1] != 2:
        raise ValueError(f"zncc_describe: xy must be [K, 2], got {xy.shape}")
    if not 1 <= p <= min(32, H, W):
        raise ValueError(f"zncc_describe: patch {p} needs 1 <= p <= "
                         f"min(32, H, W) for an image {tuple(img.shape)}")
    if img.device != xy.device:
        raise ValueError("zncc_describe: inputs on different devices")
    lib = build.load()
    out = torch.empty((K, p * p), dtype=torch.float32, device=img.device)
    if K == 0:
        return out
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.vloam_zncc_describe(img.data_ptr(), xy.data_ptr(),
                                      out.data_ptr(), K, H, W, p, stream)
    _check(lib, err, "zncc_describe")
    LAUNCHES["zncc_describe"] += 1
    return out
