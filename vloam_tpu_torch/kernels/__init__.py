"""Hand-written Hopper kernels and their launch wrappers.

K1 select_rings  (csrc/select_rings.cu) <- scan_registration.py::
                 _select_rings_pallas_kernel (strict sector selection)
K2 ring_min2     (csrc/ring_min2.cu)    <- ring_assoc.py::_ring_min2_kernel
                 (per-ring min-2 behind LO association)
K3 zncc_describe (csrc/zncc_describe.cu) <- vision/features.py::
                 _describe_zncc_pallas (ZNCC patch descriptors)
S1 ring_min1, ring_argmin2 (csrc/ring_min1.cu) <- scripts/
                 profile_ring_variants.py::_kern_min1, _kern_argmin (the
                 exact min-only reduction, impl "xla"; K2's outputs by two
                 argmin passes)
   ring_min1_packed (csrc/ring_min1.cu) <- ring_assoc.py::ring_min1_mxu,
                 ring_min1_packed (XLA in the reference): the packed-key
                 minimum of the engines' LO association (impl "mxu")
S2 grid_probe    (csrc/grid_probe.cu)   <- scripts/profile_pallas_gather.py::
                 make_pallas_gather[_tiled] under the map's 8-cell probe:
                 hashes, row gather and planar layout of both grids of a
                 frame in one launch
   row_gather    (csrc/row_gather.cu)   <- the same, the bucket-row gather
                 under the map's inserts
   masked_knn    (csrc/knn.cu)          <- lidar/knn.py::masked_knn (XLA in
                 the reference): the mesh chunk's window sweep, the k
                 nearest live candidates by (distance, index), masked slots
                 packed out of the sweep, one bound a query across slices

The wrappers here accept CUDA tensors only: they check device, dtype, shape
and contiguity, allocate outputs with torch.empty, launch on PyTorch's
current stream and raise if the launch is refused. The CPU dispatch to the
plain PyTorch versions lives in the callers (lidar/scan_registration.py,
lidar/ring_assoc.py, lidar/gridmap.py, lidar/knn.py, vision/features.py)
and is taken only for CPU tensors.

``LAUNCHES`` counts launches per kernel; each wrapper adds one exactly
where its kernel is launched (masked_knn's is one call of its C entry
point, which zeroes the shared bounds and launches the slice kernel and
the merge behind it).
"""

from __future__ import annotations

import functools

import torch

from . import build

LAUNCHES = {"select_rings": 0, "ring_min2": 0, "zncc_describe": 0,
            "row_gather": 0, "grid_probe": 0, "ring_min1": 0,
            "ring_argmin2": 0, "ring_min1_packed": 0, "masked_knn": 0}

KNN_THREADS = 128  # queries a block of knn.cu's slice kernel (kThreads)
KNN_TILE = 256  # candidate slots a shared-memory tile (kTile)
KNN_MAX_K = 8  # knn.cu instantiates k = 1 .. 8
KNN_BLOCKS_PER_SM = 8  # slice blocks a masked_knn launch aims at per SM


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


def _ring_reduce(name: str, n_out: int, queries: torch.Tensor,
                 slab_t: torch.Tensor, *extra):
    """Launch one of the per-ring reductions (vloam_<name>): queries [Q, 3]
    f32, slab_t [S, 3, C] f32 (and `extra` arguments after the shape) ->
    n_out // 2 pairs of ([S, Q] f32 distance, [S, Q] int32 slot)."""
    _require(queries, "queries", torch.float32, 2)
    _require(slab_t, "slab_t", torch.float32, 3)
    Q, S, C = queries.shape[0], slab_t.shape[0], slab_t.shape[2]
    if queries.shape[1] != 3 or slab_t.shape[1] != 3:
        raise ValueError(f"{name}: bad shapes {queries.shape} "
                         f"{slab_t.shape}")
    if C < 2:
        raise ValueError(f"{name}: a ring needs at least 2 slots")
    if queries.device != slab_t.device:
        raise ValueError(f"{name}: inputs on different devices")
    lib = build.load()
    dev = queries.device
    outs = tuple(torch.empty((S, Q), device=dev,
                             dtype=torch.int32 if k % 2 else torch.float32)
                 for k in range(n_out))
    if Q == 0 or S == 0:
        return outs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"vloam_{name}")(
            queries.data_ptr(), slab_t.data_ptr(),
            *(o.data_ptr() for o in outs), Q, S, C, *extra, stream)
    _check(lib, err, name)
    LAUNCHES[name] += 1
    return outs


def ring_min2(queries: torch.Tensor, slab_t: torch.Tensor):
    """K2 on the card: queries [Q, 3] f32, slab_t [S, 3, C] f32 ->
    (dmin [S, Q] f32, amin [S, Q] int32, d2 [S, Q] f32, a2 [S, Q] int32)."""
    return _ring_reduce("ring_min2", 4, queries, slab_t)


def ring_min1(queries: torch.Tensor, slab_t: torch.Tensor):
    """S1's min-only variant on the card: K2's inputs ->
    (dmin [S, Q] f32, amin [S, Q] int32), equal to K2's first two outputs."""
    return _ring_reduce("ring_min1", 2, queries, slab_t)


def ring_argmin2(queries: torch.Tensor, slab_t: torch.Tensor):
    """S1's argmin variant on the card: K2's inputs and K2's four outputs,
    computed by two argmin passes with the winner's slot masked."""
    return _ring_reduce("ring_argmin2", 4, queries, slab_t)


def ring_min1_packed(queries: torch.Tensor, slab_t: torch.Tensor,
                     product: bool, bits: int, scale: float, clip: float):
    """The packed-key per-ring minimum on the card: K2's inputs -> (d [S, Q]
    f32 dequantized, slot [S, Q] int32), over max(|q|^2 + |c|^2 - 2 q.c, 0)
    (product) or the exact (q - c)^2; bits, scale, clip as
    lidar.ring_assoc._quant gives them (2^bits >= C, scale a power of
    two). Inputs must be finite."""
    C = slab_t.shape[-1]
    if not (1 <= bits <= 29 and C <= 1 << bits):
        raise ValueError(f"ring_min1_packed: {bits} slot bits do not hold "
                         f"{C} slots")
    return _ring_reduce("ring_min1_packed", 2, queries, slab_t, int(product),
                        bits, float(scale), float(clip))


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """S2 on the card: table [NB, W] f32, idx [N] int64 -> table[idx]
    [N, W] f32, bit-identical. W must be a multiple of 4 (rows move as
    16-byte words). Every index must lie in [0, NB): values cannot be checked
    here without waiting for the device, so callers clamp."""
    _require(table, "table", torch.float32, 2)
    _require(idx, "idx", torch.int64, 1)
    NB, W = table.shape
    N = idx.shape[0]
    if W == 0 or W % 4:
        raise ValueError(f"row_gather: row width {W} is not a positive "
                         "multiple of 4 floats (rows move as 16-byte words)")
    if table.data_ptr() % 16:
        raise ValueError("row_gather: table is not 16-byte aligned")
    if NB == 0 and N > 0:
        raise ValueError("row_gather: empty table")
    if N * (W // 4) >= 2**31:
        raise ValueError(f"row_gather: {N} rows of {W} floats do not fit "
                         "the kernel's 32-bit count of 16-byte words")
    if table.device != idx.device:
        raise ValueError("row_gather: inputs on different devices")
    lib = build.load()
    out = torch.empty((N, W), dtype=torch.float32, device=table.device)
    if N == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.vloam_row_gather(table.data_ptr(), idx.data_ptr(),
                                   out.data_ptr(), N, W, stream)
    _check(lib, err, "row_gather")
    LAUNCHES["row_gather"] += 1
    return out


def grid_probe(jobs) -> list[torch.Tensor]:
    """S2's map probe on the card: up to two jobs (the corner and the surf
    grid of a frame) in one launch. A job is (table [NB, 3*cap] f32,
    queries [Q, 3] f32, inv_cell, n_buckets, n_streams): the queries are
    n_streams equal runs, stream s's over its table rows [s*n_buckets,
    (s+1)*n_buckets); inv_cell is voxel.reciprocal_f32(cell). Returns per
    job the planar candidates [3, Q, 8*cap] f32: out[a, i, k*cap + j] =
    table[row_k(i), a*cap + j], row_k the k-th of the query's 8 probed
    cells (gridmap.probe_buckets) plus its stream's offset, bit-identical
    to gridmap.grid_gather_plain / batch_mapping.batch_grid_gather_plain.
    cap must be a multiple of 4 (16-byte words), n_buckets a power of two."""
    if not 1 <= len(jobs) <= 2:
        raise ValueError(f"grid_probe: 1 or 2 jobs, got {len(jobs)}")
    args, outs = [], []
    for table, queries, inv_cell, n_buckets, n_streams in jobs:
        _require(table, "table", torch.float32, 2)
        _require(queries, "queries", torch.float32, 2)
        NB, W = table.shape
        Q = queries.shape[0]
        cap = W // 3
        if queries.shape[1] != 3 or W != 3 * cap or cap % 4 or cap == 0:
            raise ValueError(f"grid_probe: bad shapes {table.shape} "
                             f"{queries.shape} (rows of 3*cap floats, cap a "
                             "positive multiple of 4)")
        if table.data_ptr() % 16:
            raise ValueError("grid_probe: table is not 16-byte aligned")
        if n_buckets < 1 or n_buckets & (n_buckets - 1):
            raise ValueError(f"grid_probe: n_buckets {n_buckets} is not a "
                             "power of two")
        if n_streams < 1 or Q % n_streams or n_streams * n_buckets > NB:
            raise ValueError(f"grid_probe: {Q} queries in {n_streams} "
                             f"streams of {n_buckets} buckets do not fit a "
                             f"table of {NB} rows")
        if NB >= 2**31 or Q >= 2**31:
            raise ValueError("grid_probe: too large for the kernel's "
                             "32-bit row and query ids")
        if table.device != queries.device or (
                outs and table.device != outs[0].device):
            raise ValueError("grid_probe: inputs on different devices")
        out = torch.empty((3, Q, 8 * cap), dtype=torch.float32,
                          device=table.device)
        outs.append(out)
        args += [table.data_ptr(), queries.data_ptr(), out.data_ptr(), Q,
                 cap, n_buckets, Q // n_streams, float(inv_cell)]
    if not any(o.shape[1] for o in outs):
        return outs
    if len(jobs) == 1:
        args += [None, None, None, 0, 4, 1, 1, 1.0]
    lib = build.load()
    dev = outs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vloam_grid_probe(*args, stream)
    _check(lib, err, "grid_probe")
    LAUNCHES["grid_probe"] += 1
    return outs


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


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def knn_slices(Q: int, n_slots: int, n_sm: int,
               blocks_per_sm: int) -> int:
    """Into how many slices masked_knn deals the KNN_TILE-slot tiles of
    n_slots candidate slots for Q queries: enough that the slice kernel's
    ceil(Q / KNN_THREADS) x slices blocks come near blocks_per_sm an SM,
    and no more than there are tiles."""
    q_blocks = -(-Q // KNN_THREADS)
    want = max(1, -(-blocks_per_sm * n_sm // q_blocks))
    return min(want, -(-n_slots // KNN_TILE))


def knn_scratch(slices: int, k: int, Q: int) -> int:
    """The int32 words of masked_knn's scratch: each slice's k (distance
    bits, index) pairs a query, and a query's shared bound."""
    return (2 * slices * k + 1) * Q


def masked_knn(queries: torch.Tensor, cands: torch.Tensor, mask: torch.Tensor,
               k: int, pad: int):
    """The k-NN sweep on the card: queries [Q, 3] f32, cands [C, 3] f32,
    mask [C] bool -> (d [Q, k] f32 ascending, idx [Q, k] int64), the k
    smallest (distance bits, index) keys over the C candidates and `pad`
    masked padding slots after them (lidar.knn._padding), bit-identical to
    lidar.knn.masked_knn_plain. 1 <= k <= 8; C >= 1 and C + pad >= k."""
    _require(queries, "queries", torch.float32, 2)
    _require(cands, "cands", torch.float32, 2)
    _require(mask, "mask", torch.bool, 1)
    Q, C = queries.shape[0], cands.shape[0]
    if queries.shape[1] != 3 or cands.shape[1] != 3 or mask.shape[0] != C:
        raise ValueError(f"masked_knn: bad shapes {queries.shape} "
                         f"{cands.shape} {mask.shape}")
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"masked_knn: k = {k} outside 1 .. {KNN_MAX_K}")
    if C < 1 or pad < 0 or C + pad < k or C + pad >= 2**30:
        raise ValueError(f"masked_knn: {C} candidates and {pad} padding "
                         f"slots for k = {k}")
    if not queries.device == cands.device == mask.device:
        raise ValueError("masked_knn: inputs on different devices")
    dev = queries.device
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=dev)
    if Q == 0:
        return out_d, out_i
    slices = knn_slices(Q, C + pad, _sm_count(dev), KNN_BLOCKS_PER_SM)
    scratch = torch.empty(knn_scratch(slices, k, Q), dtype=torch.int32,
                          device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vloam_masked_knn(
            queries.data_ptr(), cands.data_ptr(), mask.data_ptr(), Q, C, k,
            pad, slices, scratch.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), stream)
    _check(lib, err, "masked_knn")
    LAUNCHES["masked_knn"] += 1
    return out_d, out_i
