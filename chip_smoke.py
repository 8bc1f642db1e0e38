"""Drive the PyTorch port's main paths once on one NVIDIA GPU: the LiDAR-only
LOAM engine, the combined camera + LiDAR engine, the 4-stream lockstep
batch engine, the host layer around them (command line, sequence runner,
checkpoints, loop closure), the per-stage host engine, the distributed
(mesh) paths, two of the accuracy evaluations (the 100-frame golden
drive, the 500-frame long drive) and the tools of the JAX package's last
measurement scripts.

    python3 chip_smoke.py

Phases (one line each; any failure ends the run with a nonzero exit):
  1. device: the card's name and power limit; CUDA required, TF32 off
  2. build: compile the hand-written kernels from kernels/csrc with nvcc;
     ptxas' registers, spills and shared memory of every kernel (K1, K2,
     K3, ring_min1, ring_argmin2, grid_probe, ring_min1_packed in each
     instantiation, row_gather, masked_knn's slice and merge kernels); none
     may spill. The machine code of ring_min1_packed (cuobjdump -sass):
     instructions a (query, slot) pair in each instantiation's main loop; no
     F2I in the fast path's. masked_knn's slice kernel: instructions a pair
     in its main loop (the hot path), per k
  frames: a 32-frame synthetic HDL-64 polar drive (64 x 1800) with its
     1242 x 375 camera images, and three more 20-frame polar drives for the
     batch engine's other streams, rendered in worker processes
  G. the ray-direction tables LoamEngine, BatchLoamEngine and VloamEngine
     (full and camera FOV) build at their first push_polar on the card
     (on the host, with the C library's cosf / sinf, then uploaded), and
     frame 0's polar layout (points, rel_time, counts), equal to the CPU
     build bit for bit; how many table elements the old build on the card
     (torch.cos / torch.sin) differed by
  warm-up: ~3 s of matmuls so that the timed phases start on a busy card
  3. K1 select_rings vs its plain PyTorch version on real frame layouts and
     on the crafted cases of vloam_tpu_torch/tools/kernel_cases.py (windows
     that cross a sector's end, chains of such, equal curvatures, short
     rings, NaN, widths up to 7000)
  4. K2 ring_min2, S1 ring_min1 / ring_argmin2 and ring_min1_packed (the
     engines' LO association, impl "mxu"; in its product form and in the
     difference form of impl "packed") vs their plain versions, bit for
     bit, at the corner and surf LO shapes on real frame features, on
     crafted ties,
     on K2's crafted cases (duplicates across chunk and tile boundaries,
     SENTINEL slots between live ones, counts that fit no tile), on the
     min-only slab shapes (counts ring_min1's block shape divides unevenly,
     equal minima across its groups), on ring_argmin2's (the runner-up at
     the winner's distance, the winner in the last slot, slot counts no tile
     divides, rings all SENTINEL), on the packed minimum's (quantized ties
     broken by the lower slot, clipped rings, dense clouds) and at the two
     shapes of the ring-variants measurement; times beside those of the
     kernels before their redesign
  4b. ring_slab_assoc under each of the reference's impls (mxu, packed,
     xla, pallas), corner and surf, at the LO shapes of real features:
     every output identical card vs CPU; K2 (pallas) and ring_min1 (xla),
     which no engine launches, are counted on this path
  5. end to end: LoamEngine(kitti_hdl64(), chunk=16, device="cuda") over the
     drive; frames/s, kernel launch counts, MO error against ground truth,
     no host sync in the timed frames; then, after the launch counts were
     read, a counting pass over the drive (tools/work.count_frames): the
     timed frames' operations and bytes a frame, their bound on an H100 and
     the share of it the phase's frames/s reaches (it fails on a count that
     is not positive or a share over 1)
  EIG. the mapping's closed-form eig3 (solver/eig3.py) on 4 x 5000 seeded
     covariances (kernel_cases.eig3_covariances: near-planar, line-like at
     5 m and 0.5 m, isotropic; centred 0-80 m out), card against CPU: the
     line decision (kitti_hdl64's eigen_ratio) identical, the principal
     direction within 1e-4 on the line rows, both devices' eigenvalues
     within 2.5e-4 of the spectrum's scale of LAPACK's in float64; eig3's
     divisions by 3 and 6 on the card bit for bit the CPU's true divisions;
     the eigenvalues that differ bit for bit card vs CPU printed
  6. the first 6 frames again on the CPU (plain versions): trajectories agree
  7. K3 zncc_describe vs its plain version on keypoints of rendered frames
     plus crafted rows (image corners, a constant patch), p = 24 and 16, and
     on the crafted cases of kernel_cases.zncc_cases (edges, flat patches
     either side of the 1e-3 floor, p = 24, 16 and 7); cold and warm L2
     times beside the kernel's before its redesign
  8. end to end: VloamEngine(kitti_hdl64() with detach_VO_LO=False,
     chunk=16, device="cuda") over the drive and its images; frames/s, kernel
     launch counts, LO / MO error and VO ATE against ground truth, no host
     sync
  9. the depth grid of one more real frame of phase 8's engine built twice
     on the card: identical (it fails otherwise), and beside the CPU's; the
     first 4 frames of phase 8 again on the CPU: LO, MO and VO agree
  10. batch end to end: BatchLoamEngine(kitti_hdl64(), 4, chunk=4,
     device="cuda") over 20 lockstep frames of 4 drives; aggregate frames/s
     beside the single engine's on the same frames, launches per lockstep
     frame, MO error per stream, each stream against its single-engine run,
     no host sync
  11. the first 2 lockstep frames of 2 streams again on the CPU
  S2. grid_probe vs the plain pair (bit-identical) on the probe of a real
     frame of the single engine (2048 corner queries into [2^17, 96], 6144
     surf queries into [2^17, 48], one launch) and of a lockstep frame of
     the batch engine (4x the queries, flat [4 * 2^17, W] tables, rows up to
     the last stream); times beside the parent's composition (the plain
     pair: 8 hashes, row_gather, permute copy, each grid) and its parts;
     row_gather vs table[idx] (bit-identical) and torch.index_select on the
     two insert gathers of each of those frames (2048 and 6144 rows, 4x in
     the batch) and at [2^17, 96] x 65536 random
  P. pack12 on the card: the first 4 range images of phases 5 and 8 and
     of phase 10's 4 streams requantized to 3 cm (round(r x 0.005 / 0.03),
     clipped at 4095), through LoamEngine, VloamEngine and BatchLoamEngine
     at chunk 4 with pack12 on and off: rows identical, each hand kernel's
     launches identical and as phases 5, 8 and 10 count them a frame; the
     batch engine's pack12 rows of the first 2 lockstep frames of 2 streams
     on the CPU within phase 11's bounds; MO max error against ground truth
     at 3 cm beside the 5 mm runs' (printed, not gated); the phase's seconds
  12. the ring-variants measurement entry point (ring_argmin2's path): its
     check against the plain version and its times, beside ring_argmin2's
     before its redesign
  13. launches per frame: torch.profiler over steady frames of each engine
     (the LO association: ring_min1_packed, 4 launches a frame),
     with the device time per launch of each hand-written kernel there (K3's
     in VloamEngine: the L2 the engine leaves it); printed, not gated: the
     profiler can lose records. The smoke's one pass that traces the
     device: it records the device's activity and the runtime's calls, no
     host operator (tests/test_torch_loam_engine.py holds the smoke to it)
  T. the stage profilers (vloam_tpu_torch.tools.profile_stages,
     profile_vision_stages, profile_batch_stages) at full width, one host
     call and 5 graph replays a stage, chunks of 1, on the drive's first
     frames and images: their tables printed. Every stage of the
     LoamEngine polar frame captures into a CUDA graph; each frame split
     (LoamEngine polar and xyz, VloamEngine, the single stream and the
     4-stream lockstep frame) has its stages' kernel nodes summing exactly
     to its whole frame's; each stage's hand-written kernels are as phases
     5, 8 and 10 count them (K1 1 in registration, ring_min1_packed 4 in
     LO, grid_probe 1 and row_gather 2 in the mapping stage, K3 1 in the
     combined frame; B times the first two in the lockstep frame). Printed
     beside each other for each engine: the whole frame's graph-replayed
     device ms, phase 13's profiler device ms and wall, and the end-to-end
     phase's wall (5, 8, 10); the phase's seconds
  14. the host layer (vloam_tpu_torch.cli, pipeline, runtime, backend):
     a. the drive written as a KITTI odometry layout (velodyne/*.bin,
        calib.txt, times.txt, ground truth), run by `python -m
        vloam_tpu_torch run --polar-ingest --save-map` in a subprocess with
        no --device (the default must be the card), scored by its `eval`
        command: 32 finite LO / MO poses, MO error < 0.15 m, one published
        map, the kernel launches the CLI prints; the range images it reads
        hold rings 0-50, one row per written ring (the reference's HDL-64
        ring formula drops the 13 lowest beams, as on a real KITTI scan)
     b. run_sequence_fused in combined mode on the card with map
        publication: VO / LO / MO errors as phase 8's, no host sync in
        frames 1-15
     c. resume: LoamEngine over frames 0-15, save_state, load_state into a
        fresh engine, frames 16-31: the state round-trips bit for bit and
        the rows equal phase 5's uninterrupted run's
     d. close_loops on 14b's MO trajectory twice on the card (identical)
        and once on the CPU (within 1e-3 m / 1e-3 rad), within 1 m of MO;
        loops accepted, time and launches printed (the second card run's
        launches counted by a host-only torch.profiler)
  15. the host engine (vloam_tpu_torch.pipeline.run_sequence, the per-stage
     classes, --engine host) and the vision options:
     a. run_sequence(kitti_hdl64 with detach_VO_LO=False) on the card over
        the drive decoded to xyz and its images as float [0, 1]: finite VO /
        LO / MO, MO error < 0.15 m, LO / MO within 0.05 m of 14b's fused
        run, K1, K2, K3, ring_min1, grid_probe and row_gather each launched;
        frames/s, host syncs a frame and the stage timings printed
     b. its first 4 frames again on the CPU: LO, MO and VO agree
     c. lk_flow at full width (2048 keypoints, window 15, 3 levels, 10
        iterations) on one frame pair, card against CPU (status on >= 99%,
        xy1 within 0.01 px on >= 99%); VloamEngine over the drive with
        optical_flow_match and with lowtex_fallback at chunk 4: no host
        sync in frames 8-31, MO < 0.15 m, frames/s beside phase 8's
     d. python -m vloam_tpu_torch run --synthetic 4 --mode combined
        --engine host --viz DIR with no --device, and with --optical-flow,
        side by side: match (flow) and depth PNGs (frame 1), the timing
        summary and the kernel launches they print
  V. the other VO options and the batched sector selection, at full width:
     1. detect_keypoints with the fast, orb, brisk, sift and akaze
        detectors on frame 0's image, card against CPU: masks equal, >= 99%
        of positions equal; keypoints, the largest response difference and
        the device time a call printed. Where the config's FAST threshold
        (100/255) finds fewer than 50 corners on the synthetic image, the
        FAST-based detectors run at 0.06 (tests/test_vision.py's), and the
        line says so
     2. orb_describe of frame 0's 2048 keypoint rows, card against CPU (>=
        99.9% of bits equal); match_descriptors with matcher="flann"
        against "bf" on the card: idx and valid identical
     3. VloamEngine over the first 16 frames at chunk 4 with (a) ORB
        detector, ORB descriptors and FLANN, (b) the SIFT detector: finite
        rows, MO error < 0.15 m, 0 host syncs in frames 8-15, each
        hand-written kernel's launches (K3 0 in (a)); frames/s beside phase
        8's default options
     4. LoamEngine with strict_sector_order=False over the first 16 frames
        at chunk 4: K1 0 launches, frames/s beside phase 5's strict engine,
        labels per frame that differ from the strict selection, 0 host
        syncs, MO error < 0.15 m, the first 6 frames on the CPU within phase
        6's bounds
     5. essential-matrix RANSAC on 2048 synthetic correspondences with 30%
        outliers, one set of 256 minimal samples drawn from a seeded CPU
        generator: inlier masks identical card vs CPU, R within 1e-3 rad
        and t within 1e-3 of the truth on both; time a call
  M. the distributed paths (vloam_tpu_torch.parallel, torch.distributed):
     2. LoamEngine(kitti_hdl64(), chunk=16, mesh=<one NCCL rank>,
        mesh_window_rows=4096) over phase 5's drive: LO rows within 1e-5 of
        phase 5's, MO within 0.01 m of them and < 0.15 m from ground truth,
        peak active map rows within the window, 0 host syncs in the timed
        frames, K1 / ring_min1_packed / row_gather / masked_knn launched and
        grid_probe not, masked_knn 4 times a frame (2 rounds x 2 grids) in
        the timed frames; frames/s, launches a frame (a chunk of 4 on
        another engine, counted by a host-only torch.profiler); the MO
        difference from phase 5 frame by frame
     1. the windows of M2's final map (_window_block: 4096 rows gathered by
        row_gather from each grid's [2^17, W] block) bit-identical to the
        plain gather's on the CPU; masked_knn (kernels/csrc/knn.cu) at that
        engine's shapes (the last frame's 2048 corner and 6144 surf stack
        points against those windows of 4096 x 32 and 4096 x 16 slots):
        indices and distance bits identical to masked_knn_plain on the card,
        indices identical to the CPU's; the kernel's device time a call
        beside knn.cu's first design's (MASKED_KNN_BEFORE_US) and the plain
        version's, launches a call, the bound and the issue floor at phase
        2's instructions a pair over every slot and over the live pairs
     3. the first 16 frames at 2 gloo ranks sharing the card (processes
        started by parallel/launch.py; the ring hop through host memory):
        MO within 0.01 m of M2, host syncs printed; with 2 or more cards
        also min(4, cards) NCCL ranks
     4. VloamEngine(mesh=<one NCCL rank>) over the first 16 frames: VO and
        LO within 1e-5 of phase 8's, MO within 0.01 m
     5. close_loops(mesh=<one NCCL rank>) on 14b's trajectory: 14d's loops,
        poses within 1e-3 m; `python -m vloam_tpu_torch run --synthetic 4
        --mesh 1` with no --device
     S. vloam_tpu_torch.tools.model_mesh_scaling on that rank: the D = 1
        mesh chunk over 8 frames and one frame of it by stages (windows,
        the masked_knn sweeps, the LM chains, inserts and evicts), the
        stages' kernel launches summed equal to the one-frame chunk's and
        the stages in order bit for bit with it; the model's D = 2, 4, 8
        rows (the link an assumption, printed as one)
     B. vloam_tpu_torch.tools.bench_mesh: scripts/bench_mesh.py's frame
        through mesh_solve_mapping at D = 1 (this NCCL rank) and at D = 2
        gloo ranks sharing the card: each pose within 0.01 m of the
        single-device solve, each rank's accepted count, ms a solve
  E. the accuracy evaluations (vloam_tpu_torch.tools.eval_*, the
     counterparts of scripts/eval_*.py), frames made in 8 spawned worker
     processes:
     1. the 100-frame golden drive: tools.eval_synthetic's lidar_only mode
        (xyz ingest, run_sequence_fused with chunk 10) once: MO max error
        against ground truth < 0.15 m; each hand kernel's launches over the
        run as phase 5's for as many frames (select_rings, ring_min1_packed,
        grid_probe, row_gather 1 / 4 / 1 / 2 a frame, the others 0); the LO
        / MO metrics beside the JAX package's tests/golden/
        synthetic_metrics.json and the MO gap to its
        synthetic_lidar_MO.npy frame by frame (both made on a TPU: printed,
        not gated)
     2. the 500-frame long drive (~600 m): tools.eval_long (LoamEngine,
        chunk 16, a last chunk of 4): 500 finite LO / MO rows, MO t_rel <=
        0.885 % and ATE rmse <= 4.90 m (1.5x the JAX package's, RESULTS.md),
        0 degraded frames; crossings, each map grid's live slots and full
        buckets at the end, frames/s
  B. vloam_tpu_torch.tools.bench (the port's bench.py), one window of 16
     frames (of 8 combined frames), its batch part (scripts/bench_extras.py's
     streams, uint16 at 5 mm and pack12 at 3 cm) on 4 streams at chunk 4,
     one window of 4 lockstep frames: its line parses, with bench.py's keys
     (the roofline keys among them, a share in (0, 1]) and the port's (the
     batch keys among them, both modes' rates > 0), finite numbers and the
     card's name
  U. vloam_tpu_torch.tools.profile_upload_overlap: the polar chunk staged
     four ways (one upload a chunk or a frame, with and without pack12), one
     turn of 1 timed chunk of 16: rows identical across the modes;
     frames/s, host enqueue and the copies' device ms a frame
  DV. vloam_tpu_torch.tools.diag_vo's main entry, base variant, over the
     first 4 pairs of the 100-frame drive on the card and on the CPU:
     matches, n32 / n22, match reprojection, rotation and translation
     errors side by side; finite solves with n32 > 0 on the card
  L2. vloam_tpu_torch.tools.profile_lo2 at full width (solve_lo, the
     shortlist association, the distance product in float32, TF32 and
     bf16, top-k shortlists), and the shortlist association's picks and
     distances card = CPU bit for bit, corner and surf; TF32 off again
  BK. vloam_tpu_torch.tools.bench_knn: masked_knn (knn.cu) and its plain
     version at scripts/bench_knn.py's four shapes (16384 x 307200 down to
     1024 x 8192), bit for bit on the first 1024 queries of each; the bound
     and the issue floor over every slot and over the live pairs
The frames of U, DV, L2, MS, the accuracy phases and B's batch streams
are rendered by a `chip_smoke.py prerender` process (6 workers) started
after phase 11, beside the phases that follow; the smoke waits for it after
M5 and ends its process group on exit. Every phase prints its seconds ([time])
and a [seconds] line lists them all before [done].
Timed phases end with the SM clock, its maximum, the power draw and the
temperature that nvidia-smi reads just after their timed runs. Then the
kernels' JSON line, the card's line and, last, the device line. Each row of
the kernels' line takes its times and its bound at the shapes of the path
that its launches are counted on: the batch drive (phase 10) for
select_rings, ring_min1_packed (per stream: the single engine's shapes),
grid_probe (the lockstep frame's probe of both grids) and row_gather (the
flat surf insert), the association forms (phase 4b) for ring_min2 and
ring_min1, the combined engine (phase 8) for zncc_describe, the
ring-variants entry point (phase 12) for ring_argmin2, the mesh engine (M2)
for masked_knn (its times and bound at M1's corner window; the bound over
the live pairs, the work the kernel has since it skips masked slots).

Kernel times are device times (vloam_tpu_torch.tools.timing.device_ms: CUDA
events around 20 calls queued behind a blocker, so the ~30 us host call of a
wrapper is not in them), with a cold L2 for the memory-bound kernels (K1,
K3, S2; device_ms's default) and a warm one for the ring reductions.

Imports nothing of JAX or of the JAX package: the configuration and the
synthetic scene generator are the port's own (vloam_tpu_torch.config,
vloam_tpu_torch.data.synthetic).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

N_FRAMES = 32
CHUNK = 16
BATCH = 4  # streams of the batch drive
BATCH_FRAMES = 20  # lockstep frames: one warm chunk, then 16 timed
BATCH_CHUNK = 4
BATCH_CPU = (2, 2)  # streams, lockstep frames of the card-vs-CPU check
# batch engine against the single engine per stream, in metres (the bounds of
# tests/test_batch_engine.py), and against its own CPU run (as phase 6)
BATCH_SINGLE_TOL = {"LO": 1e-3, "MO": 1e-2}
BATCH_CPU_TOL = {"LO": 2e-2, "MO": 3e-2}
PACK_FRAMES = 4  # frames (lockstep frames: one chunk) of each phase-P run
N_AZ = 1800
CPU_FRAMES = 6
IMG_W, IMG_H = 1242, 375
VLOAM_CPU_FRAMES = 4
# frames (one chunk) under torch.profiler in phase 13 and counted on the
# host in M2, after as many warm frames: the launches a frame the records
# read are a chunk of 4's (the profiler's post-processing took 119 s of
# phase 13 at 8)
PROFILE_FRAMES = 4
# phase T: host calls, graph replays and chunk frames of the stage tools
STAGE_RUNS, STAGE_REPLAYS, STAGE_CHUNK = 1, 5, 1
# card vs CPU bounds of the combined engine, in metres over the first
# VLOAM_CPU_FRAMES frames: LO and MO as phase 6 (the golden tolerances);
# VO as MO (the VO LM sums in another order on the card)
VLOAM_CPU_TOL = {"LO": 2e-2, "MO": 3e-2, "VO": 3e-2}


S1_REPLACES = "scripts/profile_ring_variants.py:73"
# Device times in us of the first K1 and K2, which the present kernels
# replaced: one block per ring with a block-wide argmax per round, and one
# query per thread (NVIDIA H100 80GB HBM3 at 700 W, the same method and
# shapes as phases 3 and 4; PERF.md section 6). Printed beside the new times.
K1_BEFORE_US = 117.0
K2_BEFORE_US = {"surf": 44.6, "corner": 8.3}
# ... and of the first K3 (one warp a keypoint, a runtime division a pixel)
# and ring_min1 (one query a thread), the same method and shapes as phases 7
# and 4 (PERF.md section 6)
K3_BEFORE_US = 15.4
RING_MIN1_BEFORE_US = {"corner": 6.2, "surf": 31.6}
# ... and of the first ring_min1_packed (an F2I conversion, a shift
# and an OR a pair, ring_min1's block shape), product and difference form,
# the same method and shapes as phase 4 (PERF.md section 6)
RING_MIN1_PACKED_BEFORE_US = {"product": {"corner": 6.4, "surf": 31.4},
                              "difference": {"corner": 5.9, "surf": 28.4}}
# ... and of the first ring_argmin2 (one query a thread, two passes over a
# [3, C] slab read three floats a slot) at the ring-variants entry point's
# surf shape 2048 x [64,3,512], as phase 12 times it (PERF.md section 6)
RING_ARGMIN2_BEFORE_US = 83.39
# ... and of the first masked_knn (every slot swept, masked ones included,
# each slice on its own threshold) at M1's windows, timed in turns with the
# redesign in one run of M1 (PERF.md section 6)
MASKED_KNN_BEFORE_US = {"corner": 258.7, "surf": 330.0}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def clocks() -> str:
    """The card's SM clock / max SM clock, power draw and temperature."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True)
    sm, sm_max, power, temp = smi.stdout.strip().splitlines()[0].split(", ")
    return f"[SM {sm} of {sm_max}, {power}, {temp} C]"


def warm_up(seconds: float = 3.0) -> None:
    """Keep the card busy for `seconds` (f32 matmuls) before timing."""
    a = torch.randn((4096, 4096), device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            b = a @ a
        torch.cuda.synchronize()
    del a, b
    print(f"[warm-up] {seconds:.0f} s of 4096^2 matmuls {clocks()}",
          flush=True)


def kernel_row(name, source, replaces, err, ms, plain_ms, bound,
               library_ms=None) -> dict:
    bound_ms, bound_by = bound
    return {"name": name, "route": "cuda",
            "source": f"vloam_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def device_phase() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from vloam_tpu_torch.tools.timing import card_line

    card = card_line()
    print(card, flush=True)
    # float32 products in full precision (the LM normal equations are
    # einsums over ~10k rows); tolerances below assume it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, TF32 off", flush=True)
    return card


def build_phase() -> dict:
    """Returns masked_knn's slice kernel's main-loop instructions a pair, by
    k."""
    from vloam_tpu_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    if parts := build.measurement_defines(
            lib.with_suffix(".log").read_text().split()):
        fail(f"the kernels' library was built with measurement switches "
             f"{parts}")
    redesigned = {"select_rings_kernel", "ring_min2_kernel",
                  "zncc_describe_kernel", "ring_min1_kernel",
                  "ring_argmin2_kernel", "grid_probe_kernel",
                  "ring_min1_packed_kernel", "row_gather_kernel",
                  "knn_slice_kernel", "knn_merge_kernel"}
    usage = {k: v for k, v in build.resource_usage().items()
             if k.split("<")[0] in redesigned}
    if {k.split("<")[0] for k in usage} != redesigned:
        fail(f"no ptxas report for a kernel: {sorted(usage)}")
    print(f"[2 build] {lib.name} in {time.perf_counter() - t0:.2f} s; ptxas: "
          + "; ".join(
              f"{name} {u['registers']} registers, {u['spill_stores']} + "
              f"{u['spill_loads']} B spilled, {u['stack']} B stack, "
              f"{u['smem']} B static shared"
              for name, u in sorted(usage.items())), flush=True)
    if any(u["spill_stores"] or u["spill_loads"] for u in usage.values()):
        fail("a kernel spills registers")
    text = build.sass(lib)
    lines, converting = build.packed_sass(text)
    print("[2 sass] ring_min1_packed: " + "; ".join(lines), flush=True)
    knn_lines, knn_per_pair = build.knn_sass(text)
    print("[2 sass] masked_knn: " + "; ".join(knn_lines), flush=True)
    if sorted(knn_per_pair) != list(range(1, 9)):
        fail(f"masked_knn: slice kernels for k = {sorted(knn_per_pair)}, "
             "want 1 .. 8")
    if converting:
        fail(f"ring_min1_packed: F2I in the fast path of {converting}")
    if sum(", fast)" in line for line in lines) < 2:
        fail("ring_min1_packed: the fast path's instantiations are missing "
             "from the machine code")
    return knn_per_pair


class Calib:
    """The synthetic rig's calibration: the camera sits at the velodyne
    origin (vloam_tpu_torch.data.synthetic.default_cam_calib)."""

    def __init__(self):
        from vloam_tpu_torch.data import synthetic

        self.K, P_rect0, _, velo_T_cam = synthetic.default_cam_calib(IMG_W,
                                                                     IMG_H)
        self.P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
        self.imu_T_velo = np.eye(4)
        self.imu_T_cam0 = velo_T_cam


def _scan(seed: int, T: np.ndarray) -> np.ndarray:
    """One polar scan of the scene from sensor pose T."""
    from vloam_tpu_torch.data import synthetic

    return synthetic.simulate_scan_polar(
        synthetic.urban_scene(0, extent=80.0), T, n_scans=64, n_azimuth=N_AZ,
        noise=0.01, seed=seed)


def _render(k: int, T: np.ndarray):
    """Frame k: the polar scan and the camera image from sensor pose T."""
    from vloam_tpu_torch.data import synthetic

    calib = Calib()
    img = synthetic.render_camera(synthetic.urban_scene(0, extent=80.0),
                                  T @ calib.imu_T_cam0, calib.K, IMG_W, IMG_H)
    return _scan(k, T), np.clip(img * 255.0, 0, 255).astype(np.uint8)


def make_frames():
    from vloam_tpu_torch.data import synthetic

    poses = synthetic.drive_trajectory(N_FRAMES, speed=1.1, yaw_rate=0.01)
    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    # spawned workers: the parent already holds a CUDA context
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        out = list(pool.map(_render, range(N_FRAMES), poses))
        frames = [f for f, _ in out]
        images = [im for _, im in out]
        # the batch engine's other streams: other yaw rates, other noise
        streams, stream_poses = [frames[:BATCH_FRAMES]], [poses[:BATCH_FRAMES]]
        for b in range(1, BATCH):
            ps = synthetic.drive_trajectory(
                BATCH_FRAMES, speed=1.1 - 0.1 * b,
                yaw_rate=0.01 * (-1) ** b * (b + 1))
            streams.append(list(pool.map(
                _scan, range(1000 * b, 1000 * b + BATCH_FRAMES), ps)))
            stream_poses.append(ps)
    print(f"[frames] {N_FRAMES} polar frames 64x{N_AZ} and {IMG_W}x{IMG_H} "
          f"camera images, {BATCH - 1} x {BATCH_FRAMES} more polar frames in "
          f"{time.perf_counter() - t0:.1f} s (host, {workers} processes)",
          flush=True)
    return frames, images, poses, streams, stream_poses


def frame_features(cfg, frames, dirs):
    """Per frame: the K1 inputs (curv, bf, counts) and the features."""
    from vloam_tpu_torch.lidar import scan_registration as sr

    out = []
    for img in frames:
        r = torch.from_numpy(img.astype(np.int32)).cuda()
        pts, _, counts = sr.polar_layout(r, dirs, cfg.lidar)
        curv = sr._curvature(pts)
        bf = sr._break_prefix(pts, cfg.scanreg.neighbor_suppress_gap_sq)
        feats = sr.register_scan_polar(r, dirs, cfg.lidar, cfg.scanreg)
        out.append((curv, bf, counts, feats))
    return out


def geometry_phase(cfg, cfg_v, calib, frames, images) -> None:
    """G: the direction tables each engine builds at its first push_polar
    on the card, and a frame's polar layout (points, rel_time), equal to
    the CPU build bit for bit; how many elements the old build on the card
    (torch.cos / torch.sin of the device's azimuths) differed by."""
    import math

    from vloam_tpu_torch.data.synthetic import hdl64_elevations
    from vloam_tpu_torch.lidar.loam_step import (BatchLoamEngine, LoamEngine,
                                                 _polar_dirs)
    from vloam_tpu_torch.lidar.scan_registration import polar_layout
    from vloam_tpu_torch.vloam_step import PolarGeometry, VloamEngine

    def bits(t):
        return t.detach().cpu().contiguous().view(torch.int32)

    def same(a, b) -> bool:
        return a.shape == b.shape and torch.equal(bits(a), bits(b))

    elev = np.radians(hdl64_elevations(64)).astype(np.float32)
    frac = cfg_v.vo.polar_fov_fraction
    geom = PolarGeometry.create(elev, N_AZ, frac, "cpu")
    want = {"LoamEngine": _polar_dirs(cfg, N_AZ, None, "cpu"),
            "VloamEngine FOV": geom.fov_dirs}
    want["BatchLoamEngine"] = want["VloamEngine"] = geom.dirs
    eng = LoamEngine(cfg, chunk=2)
    eng.push_polar(frames[0])  # under the chunk: builds the table only
    beng = BatchLoamEngine(cfg, BATCH, chunk=2)
    beng.push_polar(0, frames[0])
    veng = VloamEngine(cfg_v, calib, chunk=2)
    veng.push_polar(frames[0], images[0])
    got = {"LoamEngine": eng._dirs, "BatchLoamEngine": beng._dirs,
           "VloamEngine": veng._geom.dirs,
           "VloamEngine FOV": veng._geom.fov_dirs}
    del eng, beng, veng
    for name, t in got.items():
        if t.device.type != "cuda" or not same(t, want[name]):
            fail(f"{name}'s direction table on the card is not the CPU "
                 f"build's")
    img = torch.from_numpy(frames[0].astype(np.int32))
    lay = [polar_layout(img.to(dev), dirs, cfg.lidar)
           for dev, dirs in (("cuda", got["LoamEngine"]),
                             ("cpu", want["LoamEngine"]))]
    for name, a, b in zip(("points", "rel_time", "counts"), *lay):
        if not same(a, b):
            fail(f"the polar layout's {name} differ card vs CPU")
    # the build that ray_directions on the host replaced, on the card
    el = torch.from_numpy(elev).cuda()
    step = float(np.float32(2.0 * math.pi) / np.float32(N_AZ))

    def old_table(az):
        ce, se, ca, sa = torch.cos(el), torch.sin(el), torch.cos(az), \
            torch.sin(az)
        return torch.stack([ce[:, None] * ca[None, :],
                            ce[:, None] * sa[None, :],
                            se[:, None].expand(64, az.shape[0])], dim=-1)

    col = torch.arange(N_AZ, dtype=torch.float32, device="cuda")
    az_fov = -(col * (2.0 * math.pi / N_AZ))
    if geom.half:
        az_fov = torch.cat([az_fov[:geom.half], az_fov[N_AZ - geom.half:]])
    for name, old, new in (("full", old_table(-(col * step)), geom.dirs),
                           ("FOV", old_table(az_fov), geom.fov_dirs)):
        n = int((bits(old) != bits(new)).sum())
        print(f"[G] {name} table 64 x {new.shape[1]}: the old build on the "
              f"card (torch.cos / torch.sin) differs from the host build on "
              f"{n} of {new.numel()} elements ({100.0 * n / new.numel():.2f} "
              f"%)", flush=True)
    print(f"[G] direction tables of LoamEngine, BatchLoamEngine and "
          f"VloamEngine (full, FOV) and frame 0's polar layout (points, "
          f"rel_time, counts): card = CPU bit for bit", flush=True)


def k1_phase(cfg, ff) -> dict:
    from vloam_tpu_torch.lidar import scan_registration as sr
    from vloam_tpu_torch.tools import kernel_cases, timing

    err = 0
    for curv, bf, counts, _ in ff:
        got = sr.select_rings(curv, bf, counts, cfg.scanreg)
        want = sr.select_rings_plain(curv, bf, counts, cfg.scanreg)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K1 labels differ at {int((got != want).sum())} points")
        err = max(err, int((got - want).abs().max()))
    n_lab = int((got != 0).sum())
    cases = kernel_cases.select_rings_cases()
    for case in cases:
        c, b, n = (torch.from_numpy(a).cuda()
                   for a in (case.curv, case.bf, case.counts))
        got_c = sr.select_rings(c, b, n, cfg.scanreg)
        want_c = sr.select_rings_plain(c, b, n, cfg.scanreg)
        torch.cuda.synchronize()
        if not torch.equal(got_c, want_c):
            fail(f"K1 labels differ at {int((got_c != want_c).sum())} points "
                 f"of the crafted case {case.name}")
    curv, bf, counts, _ = ff[0]
    ms = timing.device_ms(
        lambda: sr.select_rings(curv, bf, counts, cfg.scanreg))
    plain_ms = timing.device_ms(
        lambda: sr.select_rings_plain(curv, bf, counts, cfg.scanreg), runs=5,
        cold=False)
    # tools/work.select_rings: curv, bf and the labels once a point, the
    # counts once a ring; 2 x 24 pick rounds of one compare a point
    bound = timing.select_rings_bound(curv.numel(), curv.shape[0],
                                      cfg.scanreg)
    print(f"[3 K1 select_rings] {len(ff)} frames [64,{N_AZ}] labels "
          f"identical ({n_lab} labelled), and on {len(cases)} crafted cases ("
          + ", ".join(c.name for c in cases) + f"); kernel {ms * 1e3:.1f} us "
          f"({K1_BEFORE_US} us before the redesign), plain "
          f"{plain_ms * 1e3:.1f} us, bound by {bound[1]} "
          f"{bound[0] * 1e3:.2f} us {clocks()}", flush=True)
    return kernel_row("select_rings", "select_rings.cu",
                      "vloam_tpu/lidar/scan_registration.py:261", err, ms,
                      plain_ms, bound)


def _ring_check(q, slab_t, what, errs) -> None:
    """K2 and both S1 kernels against the plain versions on the card: every
    slot and every distance identical (all round (dx^2 + dy^2) + dz^2 alike),
    so ring_argmin2 equals K2 and ring_min1 its first half; and the packed
    minimum in both forms (impl "mxu", "packed") against its plain versions,
    every output identical (both round the reference's fused multiply-adds).
    Raises each kernel's entry of errs to its largest |difference| over all
    outputs."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar import ring_assoc as ra

    want = ra.ring_min2_plain(q, slab_t)
    want1 = ra.ring_min1_plain(q, slab_t)
    got = {"ring_min2": [(ra.ring_min2(q, slab_t), want)],
           "ring_argmin2": [(kernels.ring_argmin2(q, slab_t), want)],
           "ring_min1": [(ra.ring_min1(q, slab_t), want1)],
           "ring_min1_packed": [
               (ra.ring_min1_packed(q, slab_t, product),
                (ra.ring_min1_mxu_plain if product
                 else ra.ring_min1_packed_plain)(q, slab_t))
               for product in (True, False)]}
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(want1, want[:2])):
        fail(f"{what}: ring_min1_plain is not ring_min2_plain's first half")
    for name, pairs in got.items():
        for outs, ref in pairs:
            for i, (g, w) in enumerate(zip(outs, ref)):
                errs[name] = max(errs[name], float((g - w).abs().max()))
                if not torch.equal(g, w):
                    fail(f"{name} {what}: output {i} differs at "
                         f"{int((g != w).sum())} entries, max {errs[name]}")


def ring_phase(ff) -> tuple[list, dict]:
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar import ring_assoc as ra
    from vloam_tpu_torch.tools import kernel_cases, timing
    from vloam_tpu_torch.tools import profile_ring_variants as prv

    shapes = {}
    errs = {"ring_min2": 0.0, "ring_min1": 0.0, "ring_argmin2": 0.0,
            "ring_min1_packed": 0.0}
    for k in (1, 2):
        prev, cur = ff[k - 1][3], ff[k][3]
        for what, q, slab in (("corner", cur.sharp.xyz, prev.less_sharp_slab),
                              ("surf", cur.flat.xyz, prev.less_flat_slab)):
            q = q.contiguous()
            slab_t = slab.xyz.transpose(1, 2).contiguous()
            _ring_check(q, slab_t, what, errs)
            shapes[what] = (q, slab_t)
    # crafted: duplicate points (exact ties) and all-SENTINEL rings
    g = torch.Generator().manual_seed(0)
    slab = torch.full((64, 128, 3), ra.SENTINEL)
    slab[::2, :100] = torch.rand((32, 100, 3), generator=g) * 80 - 40
    slab[::4, 50] = slab[::4, 7]
    q = torch.cat([slab[0, 7:8], torch.rand((199, 3), generator=g) * 80 - 40])
    slab_t = slab.transpose(1, 2).contiguous().cuda()
    _ring_check(q.cuda(), slab_t, "ties", errs)
    for fn in (ra.ring_min2, kernels.ring_argmin2):
        got = fn(q.cuda(), slab_t)
        if int(got[1][0, 0]) != 7 or int(got[3][0, 0]) != 50 or \
                int(got[1][1, 5]) != 0 or int(got[3][1, 5]) != 1:
            fail(f"{fn.__name__} tie rules")
    for fn in (ra.ring_min1, lambda *a: ra.ring_min1_packed(*a, True),
               lambda *a: ra.ring_min1_packed(*a, False)):
        got = fn(q.cuda(), slab_t)
        if int(got[1][0, 0]) != 7 or int(got[1][1, 5]) != 0:
            fail("ring_min1 / ring_min1_packed tie rules")
    cases = (kernel_cases.ring_min2_cases() + kernel_cases.ring_min1_cases()
             + kernel_cases.ring_argmin2_cases()
             + kernel_cases.ring_packed_cases())
    for case in cases:
        _ring_check(torch.from_numpy(case.queries).cuda(),
                    torch.from_numpy(case.slab_t).cuda(),
                    f"crafted case {case.name}", errs)
    for name, S, C, Q in prv.SHAPES:
        _ring_check(*prv.make(S, C, Q), f"measurement shape {name}", errs)

    fns = {"ring_min2": (ra.ring_min2, ra.ring_min2_plain, 4),
           "ring_min1": (ra.ring_min1, ra.ring_min1_plain, 2),
           "ring_argmin2": (kernels.ring_argmin2, ra.ring_min2_plain, 4),
           "ring_min1_packed": (lambda *a: ra.ring_min1_packed(*a, True),
                                ra.ring_min1_mxu_plain, 2),
           "ring_min1_packed difference": (
               lambda *a: ra.ring_min1_packed(*a, False),
               ra.ring_min1_packed_plain, 2)}
    res, line = {}, []
    for what, (q, slab_t) in shapes.items():
        Q, S, C = q.shape[0], slab_t.shape[0], slab_t.shape[2]
        for name, (fn, plain, n_out) in fns.items():
            res[name, what] = (
                timing.device_ms(lambda: fn(q, slab_t), cold=False),
                timing.device_ms(lambda: plain(q, slab_t), runs=10,
                                 cold=False),
                timing.ring_reduce_bound(Q, S, C, n_out))
        line.append(f"{what} {Q}x[{S},3,{C}] " + ", ".join(
            f"{name} {res[name, what][0] * 1e3:.1f} us (plain "
            f"{res[name, what][1] * 1e3:.1f}, bound "
            f"{res[name, what][2][0] * 1e3:.2f})" for name in fns))
    clk = clocks()
    share = prv.update_share(*shapes["surf"])
    print("[4 K2 ring_min2, S1 ring_min1 / ring_argmin2, ring_min1_packed] "
          "slots and distances identical to the plain versions (real "
          f"features, ties, {len(cases)} crafted cases: "
          + ", ".join(c.name for c in cases) + "; measurement shapes; the "
          "packed minimum in the product form of impl mxu and the difference "
          "form of impl packed); device time " + "; ".join(line)
          + "; before the redesign ring_min2 " + ", ".join(
              f"{w} {t} us" for w, t in K2_BEFORE_US.items())
          + ", ring_min1 " + ", ".join(f"{w} {t} us" for w, t in
                                       RING_MIN1_BEFORE_US.items())
          + ", ring_min1_packed " + ", ".join(
              f"{form} " + ", ".join(f"{w} {t} us" for w, t in ts.items())
              for form, ts in RING_MIN1_PACKED_BEFORE_US.items())
          + "; chunks of 8 surf slots whose minimum is below the running "
          f"second minimum: {share[0]:.1%} per query, {share[1]:.1%} per "
          f"warp of 128 queries {clk}", flush=True)
    # each kernel's row at the shape its path gives it: the packed minimum
    # (the engines' mxu form) and K2 at surf, ring_min1 at corner.
    # ring_argmin2's times come from its own path, the ring-variants entry
    # point (phase 12), which gets its |difference| from here
    return [
        kernel_row("ring_min2", "ring_min2.cu",
                   "vloam_tpu/lidar/ring_assoc.py:86", errs["ring_min2"],
                   *res["ring_min2", "surf"]),
        kernel_row("ring_min1", "ring_min1.cu", S1_REPLACES,
                   errs["ring_min1"], *res["ring_min1", "corner"]),
        kernel_row("ring_min1_packed", "ring_min1.cu",
                   "vloam_tpu/lidar/ring_assoc.py:217",
                   errs["ring_min1_packed"],
                   *res["ring_min1_packed", "surf"]),
        errs["ring_argmin2"]], shapes


def assoc_phase(shapes) -> dict:
    """ring_slab_assoc under each of the reference's four impls at the LO
    shapes of real features (frame 1 against frame 2): every output on the
    card identical to the CPU's. This is the path of K2 (impl "pallas") and
    ring_min1 (impl "xla"), which no engine takes: their launches are
    counted here."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar import ring_assoc as ra

    kernels.reset_launches()
    for what, (q, slab_t) in shapes.items():
        slab = ra.RingSlab(slab_t.transpose(1, 2).contiguous())
        slab_cpu = ra.RingSlab(slab.xyz.cpu())
        for impl in ("mxu", "packed", "xla", "pallas"):
            got = ra.ring_slab_assoc(q, slab, 2.5, what, impl)
            want = ra.ring_slab_assoc(q.cpu(), slab_cpu, 2.5, what, impl)
            for k in want:
                if not torch.equal(got[k].cpu(), want[k]):
                    fail(f"ring_slab_assoc impl {impl} {what}: {k} differs "
                         "card vs CPU")
    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in launches}
    want.update(ring_min2=2, ring_min1=2, ring_min1_packed=4)
    print("[4b association forms] ring_slab_assoc impl mxu, packed, xla, "
          "pallas, corner and surf at the LO shapes: every output identical "
          f"card vs CPU; launches {launches}", flush=True)
    if launches != want:
        fail(f"the association forms launched {launches}, want {want}")
    return launches


BENCH_WINDOWS = 1  # phase B checks the line's keys, not its rates
BENCH_BATCH_WINDOW = 4  # lockstep frames a window of B's batch part


def bench_phase(card: str, frames, images) -> None:
    """vloam_tpu_torch.tools.bench at a few frames a window on the drive's
    frames (bench.py's drive: the same scene, trajectory and seeds), the
    batch part on 4 streams of bench_extras.bench_batch's drives at chunk 4
    and 4 lockstep frames a window: its line parses and holds bench.py's
    keys and the port's, with finite numbers."""
    from vloam_tpu_torch.tools import bench

    t0 = time.perf_counter()
    rec = json.loads(json.dumps(bench.run(
        "cuda", window=16, windows=BENCH_WINDOWS, combined=(8, 8),
        batch=(BATCH, BATCH_CHUNK, BENCH_BATCH_WINDOW), n_poses=256,
        frames=frames[:32], images=images[:16])))
    keys = {"metric", "value", "unit", "vs_baseline", "value_median",
            "window_rates", "window_frames", "fence_ms",
            "device_ms_per_frame", "upload_mbps", "upload_ms_per_frame",
            "device", "host_cpu", "combined_fps", "combined_vs_baseline",
            "combined_fps_median", "pose_graph_gn_iters_per_sec",
            "flops_per_frame", "hbm_bytes_per_frame", "device_kind",
            "power_limit_w", "hbm_util", "flop_util", "roofline_bound",
            "batch_streams", "batch_fps", "batch_fps_median",
            "batch_pack12_fps", "batch_pack12_fps_median"}
    print(f"[B bench] tools/bench.run, {BENCH_WINDOWS} window of 16 "
          f"frames, of 8 combined frames and of {BENCH_BATCH_WINDOW} lockstep "
          f"frames of the batch engine's {BATCH} streams at chunk "
          f"{BATCH_CHUNK} (streams made by the prerender) "
          f"({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(rec)}", flush=True)
    if set(rec) != keys or rec["device"] != card or not card.startswith(
            rec["device_kind"]):
        fail(f"the bench line's keys {sorted(rec)} or device "
             f"{rec.get('device')}")
    if not all(np.isfinite(rec[k]) and rec[k] > 0 for k in (
            "value", "combined_fps", "pose_graph_gn_iters_per_sec",
            "device_ms_per_frame", "upload_mbps", "flops_per_frame",
            "hbm_bytes_per_frame", "power_limit_w", "batch_fps",
            "batch_fps_median", "batch_pack12_fps",
            "batch_pack12_fps_median")) or rec["batch_streams"] != BATCH:
        fail(f"the bench line's numbers: {rec}")
    if not 0 < max(rec["hbm_util"], rec["flop_util"]) <= 1.0:
        fail(f"the bench line's roofline share: {rec}")


def _sync_free(push, ks):
    """Run push(k) for k in ks with every host sync recorded; returns (host
    enqueue seconds, the sync warnings)."""
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for k in ks:
            push(k)
        torch.cuda.set_sync_debug_mode("default")
    host = time.perf_counter() - t0
    return host, [str(w.message) for w in caught
                  if "synchronizing CUDA operation" in str(w.message)]


def lidar_launches(n: int, **more) -> dict:
    """Launches of n single-stream frames: K1 once; LO associates twice per
    frame, corner and surf each time, at the reference's impl="mxu" (the
    packed minimum, ring_min1_packed; K2 and ring_min1 not at all); the
    mapping stage probes both grids in one launch and gathers rows for its
    2 inserts."""
    return {"select_rings": n, "ring_min2": 0, "ring_min1": 0,
            "ring_min1_packed": 4 * n, "row_gather": 2 * n, "grid_probe": n,
            "zncc_describe": 0, "ring_argmin2": 0, "masked_knn": 0, **more}


def e2e_phase(cfg, frames, poses, card, walls):
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar.loam_step import LoamEngine, unpack_outputs

    eng = LoamEngine(cfg, chunk=CHUNK, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for k in range(CHUNK):
        eng.push_polar(frames[k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the frame loop must never wait on the device: every host sync the
    # timed frames make is recorded and fails the phase
    host, syncs = _sync_free(lambda k: eng.push_polar(frames[k]),
                             range(CHUNK, N_FRAMES))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    clk = clocks()
    outs = eng.finish()
    launches = dict(kernels.LAUNCHES)
    res = unpack_outputs(outs)
    fps = (N_FRAMES - CHUNK) / dt
    walls["LoamEngine"] = dt * 1e3 / (N_FRAMES - CHUNK)
    gt = np.stack([T[:3, 3] for T in poses])
    err = float(np.linalg.norm(res["t_w_mo"] - gt, axis=1).max())
    err_lo = float(np.linalg.norm(res["t_w_lo"] - gt, axis=1).max())
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"[5 end to end] {N_FRAMES} frames kitti_hdl64 64x{N_AZ}: "
          f"{fps:.2f} frames/s over frames {CHUNK}-{N_FRAMES - 1} "
          f"({dt * 1e3 / (N_FRAMES - CHUNK):.2f} ms/frame, host clock "
          f"between synchronizes; host enqueue "
          f"{host * 1e3 / (N_FRAMES - CHUNK):.2f} ms/frame); launches "
          f"{launches}; max err vs GT LO {err_lo:.4f} m, MO "
          f"{err:.4f} m; peak device memory {peak:.0f} MiB; host syncs in "
          f"the timed frames {len(syncs)} {clk}", flush=True)
    if outs.shape != (N_FRAMES, 24) or not np.isfinite(outs).all():
        fail(f"outputs {outs.shape} not finite")
    want = lidar_launches(N_FRAMES)
    if launches != want:
        fail(f"kernel launch counts {launches}, want {want}")
    if syncs:
        fail(f"the frame loop synchronized with the device: {syncs[:3]}")
    if not err < 0.15:
        fail(f"MO error {err} m >= 0.15 m")
    roofline_phase(cfg, frames, fps, card)
    return res, eng, outs


def roofline_phase(cfg, frames, fps, card) -> None:
    """The roofline of phase 5's timed frames: a counting pass over the
    drive (tools/work.count_frames, untimed, after the launch counts were
    read) gives each frame's live counts; the mean work of frames
    CHUNK..N_FRAMES-1, the bound of an H100 for it and the share of that
    bound phase 5's frames/s reaches. Fails on a count that is not positive
    or a share over 1, which no card can give: a fault in the count."""
    from vloam_tpu_torch.tools import bench, timing

    t0 = time.perf_counter()
    w = bench.frame_work(cfg, frames[:N_FRAMES], "cuda", CHUNK)
    r = timing.roofline(w["ops"], w["ops_f64"], w["bytes"], fps)
    share = max(r["hbm_util"], r["flop_util"])
    print(f"[5 roofline] frames {CHUNK}-{N_FRAMES - 1} (counting pass "
          f"{time.perf_counter() - t0:.1f} s): {w['ops']:.6g} float32 and "
          f"{w['ops_f64']:.6g} float64 operations, {w['bytes']:.6g} bytes a "
          f"frame; bound {r['bound_ms'] * 1e3:.3f} us a frame by "
          f"{r['roofline_bound']}; share {share:.4g} at {fps:.2f} frames/s "
          f"(hbm_util {r['hbm_util']:.4g}, flop_util {r['flop_util']:.4g}); "
          "by stage (ops, bytes in + out): " + ", ".join(
              f"{n} {st['ops'] + st['ops_f64']:.4g}, "
              f"{st['bytes_in'] + st['bytes_out']:.4g}"
              for n, st in w["stages"].items())
          + f"; {card}", flush=True)
    if not (w["ops"] > 0 and w["ops_f64"] > 0 and w["bytes"] > 0
            and all(st["bytes_in"] + st["bytes_out"] > 0
                    for st in w["stages"].values())):
        fail(f"a count of the frame's work is not positive: {w}")
    if not 0 < share <= 1.0:
        fail(f"the roofline share {share} is not in (0, 1]: a fault in the "
             "count")


EIG3_N = 5000  # covariances of each kind (tests/test_torch_eig3.py's)
# solver/eig3.py's float32 error against LAPACK in float64, as a share of
# the spectrum's scale (its largest |eigenvalue|): tests/test_torch_eig3.py's
# bound, 1.35x the largest measured on the CPU (1.855e-4, the jitted JAX
# eigenvalues; the port's 1.709e-4)
EIG3_LAPACK_SHARE = 2.5e-4
EIG3_U_TOL = 1e-4


def eig3_phase(cfg) -> None:
    """EIG: the mapping's closed-form eig3 (solver/eig3.py) on the card
    against the CPU, on kernel_cases.eig3_covariances' 4 x 5000 seeded
    covariances: the line decision identical, the principal direction within
    EIG3_U_TOL on the line rows, the eigenvalues of both within
    EIG3_LAPACK_SHARE of LAPACK's; the eigenvalues that differ bit for bit
    (CUDA's acosf / cosf are not glibc's), and eig3's divisions by 3 and 6
    on the card bit for bit as the CPU's true divisions, where a Python
    divisor would be a product by its float32 reciprocal."""
    from vloam_tpu_torch.lidar.voxel import reciprocal_f32
    from vloam_tpu_torch.solver import eig3
    from vloam_tpu_torch.tools.kernel_cases import (EIG3_KINDS,
                                                    eig3_covariances)

    t0 = time.perf_counter()
    ratio = cfg.mapping.eigen_ratio
    parts, covs = [], []
    for kind in EIG3_KINDS:
        cov = eig3_covariances(kind, EIG3_N)
        covs.append(cov)
        out = {}
        for dev in ("cuda", "cpu"):
            c = torch.from_numpy(cov).to(dev)
            lams = eig3.eigvals_sym3(c)
            u = eig3.principal_eigenvector(c, lams[:, 2])
            out[dev] = (lams.cpu().numpy(), u.cpu().numpy())
        ref = np.linalg.eigvalsh(cov.astype(np.float64))
        scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-30)
        err = {d: float((np.abs(lams - ref) / scale).max())
               for d, (lams, _) in out.items()}
        (lg, ug), (lc, uc) = out["cuda"], out["cpu"]
        line = lc[:, 2] > ratio * lc[:, 1]
        flips = int((line != (lg[:, 2] > ratio * lg[:, 1])).sum())
        sign = np.sign(np.sum(ug * uc, axis=1, keepdims=True))
        du = np.abs(ug * sign - uc).max(axis=1)[line]
        du = float(du.max()) if du.size else 0.0
        bits = int((lg.view(np.int32) != lc.view(np.int32)).sum())
        parts.append(
            f"{kind} {int(line.sum())} lines, {flips} decisions differ, max "
            f"|u diff| on the lines {du:.2e}, eigenvalues vs LAPACK card "
            f"{err['cuda']:.3e} / CPU {err['cpu']:.3e} of the scale, "
            f"{bits} of {lg.size} differ bit for bit card vs CPU "
            f"(max {float((np.abs(lg - lc) / scale).max()):.2e})")
        if flips:
            fail(f"EIG {kind}: {flips} line decisions differ card vs CPU")
        if not du <= EIG3_U_TOL:
            fail(f"EIG {kind}: u differs card vs CPU by {du} on a line row")
        if not max(err.values()) <= EIG3_LAPACK_SHARE:
            fail(f"EIG {kind}: eigenvalues {err} of the scale from LAPACK's, "
                 f"bound {EIG3_LAPACK_SHARE}")
    # eig3's divisors reach the card as tensors: a true division there, bit
    # for bit the CPU's; a Python divisor would multiply by its reciprocal
    cov = torch.from_numpy(np.concatenate(covs))
    divs = []
    for name, x, v, d in (
            ("trace / 3", cov[:, 0, 0] + cov[:, 1, 1] + cov[:, 2, 2], 3.0, 0),
            ("p2 / 6", (cov * cov).sum(dim=(1, 2)), 6.0, 1)):
        true = x / v
        card = (x.cuda() / eig3._divisors(torch.device("cuda", 0),
                                           x.dtype)[d]).cpu()
        scalar = (x.cuda() / v).cpu()
        if not torch.equal(card.view(torch.int32), true.view(torch.int32)):
            fail(f"EIG: eig3's {name} on the card is not the CPU's true "
                 f"division on {int((card != true).sum())} elements")
        product = int((scalar == x * reciprocal_f32(v)).sum())
        divs.append(f"{name} card = CPU bit for bit on {x.numel()} (a Python "
                    f"divisor on the card: {int((scalar != true).sum())} "
                    f"differ, {product} equal to the product by float32(1 / "
                    f"{v:g}))")
    print(f"[EIG eig3 card vs CPU] {len(EIG3_KINDS)} x {EIG3_N} covariances "
          f"(centred 0-80 m out), line test lambda2 > {ratio:g} lambda1, "
          f"bounds u {EIG3_U_TOL:g}, LAPACK {EIG3_LAPACK_SHARE:g} of the "
          "scale: " + "; ".join(parts) + "; divisions: " + ", ".join(divs)
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def cpu_phase(cfg, frames, res_gpu) -> None:
    from vloam_tpu_torch.lidar.loam_step import LoamEngine, unpack_outputs

    t0 = time.perf_counter()
    eng = LoamEngine(cfg, chunk=CPU_FRAMES, device="cpu")
    for k in range(CPU_FRAMES):
        eng.push_polar(frames[k])
    res = unpack_outputs(eng.finish())
    lo = float(np.abs(res["t_w_lo"] - res_gpu["t_w_lo"][:CPU_FRAMES]).max())
    mo = float(np.abs(res["t_w_mo"] - res_gpu["t_w_mo"][:CPU_FRAMES]).max())
    print(f"[6 card vs CPU] first {CPU_FRAMES} frames: max |t_w_lo| diff "
          f"{lo:.2e} m, max |t_w_mo| diff {mo:.2e} m (CPU run "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if not (lo < 2e-2 and mo < 3e-2):
        fail("card and CPU trajectories disagree")


def _capture_gathers(run):
    """What run() gives the map: the (table, idx) of every row gather (the
    inserts; gridmap, and batch_mapping, which binds the dispatcher under
    its own name) and the arguments of every probe pair (mapping's
    grid_gather_pair, batch_mapping's batch_grid_gather_pair)."""
    from vloam_tpu_torch.lidar import batch_mapping, gridmap, mapping

    gathers, probes = [], []
    real = (gridmap.row_gather, mapping.grid_gather_pair,
            batch_mapping.batch_grid_gather_pair)

    def row_gather(table, idx):
        gathers.append((table, idx))
        return real[0](table, idx)

    def pair(*args):
        probes.append(args)
        return real[1](*args)

    def batch_pair(*args):
        probes.append(args)
        return real[2](*args)

    gridmap.row_gather = batch_mapping.row_gather = row_gather
    mapping.grid_gather_pair = pair
    batch_mapping.batch_grid_gather_pair = batch_pair
    try:
        run()
    finally:
        gridmap.row_gather = batch_mapping.row_gather = real[0]
        mapping.grid_gather_pair = real[1]
        batch_mapping.batch_grid_gather_pair = real[2]
    torch.cuda.synchronize()
    return gathers, probes


def _probe_check(who, args, B, nb):
    """grid_probe against the plain pair on one frame's probe arguments:
    bit-identical, or the run fails. Returns the largest |difference| and,
    for the timing, the kernel's call, the plain pair's (the parent's
    composition: the host's time to queue it, which outlasts the device's),
    the plain pair replayed from a CUDA graph (its device time), its row
    gathers and its permute copies alone, and per grid (Q, cap, distinct
    rows)."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar import batch_mapping as bm
    from vloam_tpu_torch.lidar import gridmap
    from vloam_tpu_torch.tools import timing

    g_c, q_c, cell_c, g_s, q_s, cell_s = args[:6]
    if B == 1:
        def kernel():
            return gridmap.grid_gather_pair(*args)

        def plain():
            return (gridmap.grid_gather_plain(g_c, q_c, cell_c),
                    gridmap.grid_gather_plain(g_s, q_s, cell_s))
        want_q = [(2048, 3), (6144, 3)]
    else:
        def kernel():
            return bm.batch_grid_gather_pair(*args)

        def plain():
            return (bm.batch_grid_gather_plain(g_c, q_c, cell_c, B),
                    bm.batch_grid_gather_plain(g_s, q_s, cell_s, B))
        want_q = [(B, 2048, 3), (B, 6144, 3)]
    if [tuple(q.shape) for q in (q_c, q_s)] != want_q:
        fail(f"S2: the {who} probes {q_c.shape} {q_s.shape}, want {want_q}")
    n0 = kernels.LAUNCHES["grid_probe"]
    got = kernel()
    if kernels.LAUNCHES["grid_probe"] != n0 + 1:
        fail(f"S2: the {who} probe pair did not launch grid_probe once")
    want = plain()
    torch.cuda.synchronize()
    err = 0.0
    for g, w, what in zip(got, want, ("corner", "surf")):
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            fail(f"S2 grid_probe {who} {what}: differs from the plain pair "
                 f"at {int((g != w).sum())} elements")
        err = max(err, float((g - w).abs().max()))
    grids, rows, flat = [], [], []
    for g, q, cell in ((g_c, q_c, cell_c), (g_s, q_s, cell_s)):
        ids = gridmap.probe_buckets(q.reshape(B, -1, 3), cell, nb)
        ids = ids + (torch.arange(B, device=q.device) * nb)[:, None, None]
        ids = ids.reshape(-1)
        grids.append((ids.numel() // 8, g.cap, len(torch.unique(ids))))
        rows.append((g.pts, ids))
        flat.append(g.pts.reshape(-1, 3, g.cap))
    if B > 1 and int(rows[1][1].max()) // nb != B - 1:
        fail(f"S2: the {who} surf probe's highest row is not in stream "
             f"{B - 1}")

    def gathers():
        return [kernels.row_gather(t, i) for t, i in rows]

    rowed = gathers()

    def permutes():
        return [r.reshape(-1, 8, 3, f.shape[2]).permute(2, 0, 1, 3)
                .reshape(3, -1, 8 * f.shape[2]) for r, f in zip(rowed, flat)]

    return err, kernel, plain, {"the plain pair as one CUDA graph":
                                timing.graphed(plain),
                                "row_gather x2": gathers,
                                "permute copy x2": permutes}, grids


def s2_phase(eng, frame, beng, streams) -> tuple[dict, dict]:
    """S2 on one more real frame through the phase-5 engine (its map holds
    the whole drive) and one more lockstep frame through the phase-10 batch
    engine (flat tables of all streams, ids with stream offsets):
    grid_probe against the plain pair on the probe of both grids, timed
    beside the plain pair and its parts; row_gather against its plain
    version on the two insert gathers of each, and at the measurement's
    [2^17, 96] x 65536 random shape."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar import gridmap
    from vloam_tpu_torch.tools import profile_row_gather as prg
    from vloam_tpu_torch.tools import timing

    def one_frame():
        eng.push_polar(frame)
        eng.finish()

    def one_lockstep_frame():
        _lockstep(beng, streams, [BATCH_FRAMES - 1])
        beng.finish()

    nb = 1 << 17
    cases, probes = [], {}
    for who, run, B in (("frame", one_frame, 1),
                        ("batch", one_lockstep_frame, BATCH)):
        gathers, pairs = _capture_gathers(run)
        shapes = [(tuple(t.shape), len(i)) for t, i in gathers]
        want = [((B * nb, 96), B * 2048), ((B * nb, 48), B * 6144)]
        if shapes != want or len(pairs) != 1:
            fail(f"S2: the {who} gathers are {shapes} and {len(pairs)} probe "
                 f"pairs, want {want} and 1")
        cases += [(f"{who} {what}", t, i) for what, (t, i) in zip(
            ("corner insert", "surf insert"), gathers)]
        probes[who] = _probe_check(who, pairs[0], B, nb)
    # the batch insert really spans the streams' tables
    top = int(cases[3][2].max()) // nb
    if top != BATCH - 1:
        fail(f"S2: the batch surf insert's highest row is in stream {top}")
    cases.append(("random", *prg.make()))

    line, rows_probe, err_probe = [], {}, 0.0
    for who, (err, kernel, plain, parts, grids) in probes.items():
        err_probe = max(err_probe, err)
        ms = timing.device_ms(kernel)
        warm = timing.device_ms(kernel, cold=False)
        plain_ms = timing.device_ms(plain)
        part_ms = {k: timing.device_ms(f) for k, f in parts.items()}
        bound = timing.grid_probe_bound(grids)
        rows_probe[who] = (ms, plain_ms, bound, None)
        line.append(
            f"{who} probe (" + " + ".join(
                f"{Q} queries x 8 cells of cap {cap}, {n} distinct rows"
                for Q, cap, n in grids)
            + f"): kernel {ms * 1e3:.1f} us ({warm * 1e3:.1f} warm L2), "
            f"plain pair (the parent's composition) {plain_ms * 1e3:.1f}, "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in part_ms.items())
            + f", bound {bound[0] * 1e3:.1f} ({ms / bound[0]:.2f}x)")
    print("[S2 grid_probe] bit-identical to the plain pair; device time, "
          "cold L2: " + "; ".join(line) + f" {clocks()}", flush=True)

    line, rows, err = [], {}, 0.0
    for what, table, idx in cases:
        got = gridmap.row_gather(table, idx)
        want = gridmap.row_gather_plain(table, idx)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            fail(f"S2 {what}: differs from table[idx] at "
                 f"{int((got != want).sum())} elements")
        live = float((got[:, 0] < 1e5).float().mean())
        ms = timing.device_ms(lambda: kernels.row_gather(table, idx))
        warm = timing.device_ms(lambda: kernels.row_gather(table, idx),
                                cold=False)
        plain = timing.device_ms(
            lambda: gridmap.row_gather_plain(table, idx))
        lib = timing.device_ms(lambda: torch.index_select(table, 0, idx))
        n_unique = len(torch.unique(idx))
        bound = timing.row_gather_bound(len(idx), table.shape[1], n_unique)
        rows[what] = (ms, plain, bound, lib)
        line.append(f"{what} {len(idx)} x {table.shape[1]} f32 of "
                    f"{table.shape[0]} ({n_unique} distinct rows, "
                    f"{live:.0%} live): kernel {ms * 1e3:.1f} us "
                    f"({warm * 1e3:.1f} warm L2), table[idx] "
                    f"{plain * 1e3:.1f}, index_select {lib * 1e3:.1f}, "
                    f"bound {bound[0] * 1e3:.1f}")
    print("[S2 row_gather] bit-identical to table[idx]; device time, cold "
          "L2: " + "; ".join(line) + f" {clocks()}", flush=True)
    # the rows: the shapes of the path the launches are counted on, the
    # batch drive: its lockstep frame's probe, its flat surf insert. No one
    # PyTorch call computes the probe (hashes, gather and layout)
    return (kernel_row("grid_probe", "grid_probe.cu",
                       "scripts/profile_pallas_gather.py:55", err_probe,
                       *rows_probe["batch"]),
            kernel_row("row_gather", "row_gather.cu",
                       "scripts/profile_pallas_gather.py:55", err,
                       *rows["batch surf insert"]))


def _lockstep(eng, streams, ks) -> None:
    for k in ks:
        for b, frames in enumerate(streams):
            eng.push_polar(b, frames[k])


def batch_phase(cfg, streams, stream_poses, walls):
    """4 streams in lockstep through BatchLoamEngine, then each stream alone
    through LoamEngine over the same frames, in turns on the same card."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar.loam_step import (BatchLoamEngine, LoamEngine,
                                                 unpack_outputs)

    n_timed = BATCH_FRAMES - BATCH_CHUNK
    eng = BatchLoamEngine(cfg, BATCH, chunk=BATCH_CHUNK, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    _lockstep(eng, streams, range(BATCH_CHUNK))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, syncs = _sync_free(lambda k: _lockstep(eng, streams, [k]),
                             range(BATCH_CHUNK, BATCH_FRAMES))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    clk = clocks()
    outs = eng.finish()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    if outs.shape != (BATCH, BATCH_FRAMES, 24) or not np.isfinite(outs).all():
        fail(f"batch outputs {outs.shape} not finite")

    single_dt, errs, diffs = [], [], []
    for b in range(BATCH):
        one = LoamEngine(cfg, chunk=BATCH_CHUNK, device="cuda")
        for k in range(BATCH_CHUNK):
            one.push_polar(streams[b][k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(BATCH_CHUNK, BATCH_FRAMES):
            one.push_polar(streams[b][k])
        torch.cuda.synchronize()
        single_dt.append(time.perf_counter() - t0)
        ref = unpack_outputs(one.finish())
        res = unpack_outputs(outs[b])
        gt = np.stack([T[:3, 3] for T in stream_poses[b]])
        errs.append(float(np.linalg.norm(res["t_w_mo"] - gt, axis=1).max()))
        diffs.append({w: float(np.abs(res[f"t_w_{w.lower()}"]
                                      - ref[f"t_w_{w.lower()}"]).max())
                      for w in BATCH_SINGLE_TOL})
    fps = BATCH * n_timed / dt
    walls["BatchLoamEngine"] = dt * 1e3 / n_timed
    single_fps = BATCH * n_timed / sum(single_dt)
    per_frame = {k: v / BATCH_FRAMES for k, v in launches.items() if v}
    print(f"[10 batch end to end] {BATCH} streams x {BATCH_FRAMES} lockstep "
          f"frames kitti_hdl64 64x{N_AZ}, chunk {BATCH_CHUNK}: {fps:.2f} "
          f"stream-frames/s over lockstep frames {BATCH_CHUNK}-"
          f"{BATCH_FRAMES - 1} ({dt * 1e3 / n_timed:.2f} ms per lockstep "
          f"frame, host enqueue {host * 1e3 / n_timed:.2f} ms) against "
          f"{single_fps:.2f} frames/s of LoamEngine over the same frames, one "
          f"stream after the other ({fps / single_fps:.2f}x); launches per "
          f"lockstep frame {per_frame}; MO max err vs GT per stream "
          + ", ".join(f"{e:.4f}" for e in errs) + " m; batch vs single max "
          "diff per stream " + ", ".join(
              f"LO {d['LO']:.2e} MO {d['MO']:.2e}" for d in diffs)
          + f" m; peak device memory {peak:.0f} MiB; host syncs in the timed "
          f"frames {len(syncs)} {clk}", flush=True)
    want = lidar_launches(BATCH * BATCH_FRAMES, row_gather=2 * BATCH_FRAMES,
                          grid_probe=BATCH_FRAMES)
    if launches != want:
        fail(f"batch kernel launch counts {launches}, want {want}")
    if syncs:
        fail(f"the batch loop synchronized with the device: {syncs[:3]}")
    if not max(errs) < 0.15:
        fail(f"batch MO error {max(errs)} m >= 0.15 m")
    for d in diffs:
        if any(not d[w] < BATCH_SINGLE_TOL[w] for w in d):
            fail(f"batch and single engines disagree: {diffs}")
    return outs, launches, eng


def batch_cpu_phase(cfg, streams, outs_gpu) -> None:
    from vloam_tpu_torch.lidar.loam_step import (BatchLoamEngine,
                                                 unpack_outputs)

    nb, nf = BATCH_CPU
    t0 = time.perf_counter()
    eng = BatchLoamEngine(cfg, nb, chunk=nf, device="cpu")
    _lockstep(eng, streams[:nb], range(nf))
    outs = eng.finish()
    diff = {"LO": 0.0, "MO": 0.0}
    for b in range(nb):
        res, ref = unpack_outputs(outs[b]), unpack_outputs(outs_gpu[b][:nf])
        for w in diff:
            key = f"t_w_{w.lower()}"
            diff[w] = max(diff[w], float(np.abs(res[key] - ref[key]).max()))
    print(f"[11 batch card vs CPU] first {nf} lockstep frames of {nb} "
          "streams: max position diff "
          + ", ".join(f"{w} {d:.2e} m (bound {BATCH_CPU_TOL[w]:.0e})"
                      for w, d in diff.items())
          + f" (CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    if any(not diff[w] < BATCH_CPU_TOL[w] for w in diff):
        fail("card and CPU trajectories of the batch engine disagree")


def requantize(img: np.ndarray, scale: float) -> np.ndarray:
    """A 5 mm range image in `scale`-metre units, clipped at 4095 (12
    bits)."""
    return np.minimum(np.round(img * (0.005 / scale)), 4095).astype(np.uint16)


def _pack_pair(make, push, n: int) -> tuple[dict, dict]:
    """Rows and hand-kernel launches of the engine make(pack12) over push(
    engine, k) for k < n, with pack12 on (True) and off (False)."""
    from vloam_tpu_torch import kernels

    rows, launches = {}, {}
    for packed in (True, False):
        eng = make(packed)
        kernels.reset_launches()
        for k in range(n):
            push(eng, k)
        rows[packed] = eng.finish()
        launches[packed] = dict(kernels.LAUNCHES)
    return rows, launches


def _mo_err(t_w_mo, poses) -> float:
    gt = np.stack([T[:3, 3] for T in poses])
    return float(np.linalg.norm(t_w_mo - gt, axis=1).max())


def pack12_phase(cfg, cfg_v, frames, images, poses, calib, streams,
                 stream_poses, res5, res8, outs10) -> None:
    """P: pack12 on the card. Phase 5's and 8's range images and phase 10's
    streams requantized to 3 cm through LoamEngine, VloamEngine and
    BatchLoamEngine with pack12 on and off: rows identical (the staging is
    exact) and each hand kernel launched as often; the batch engine's pack12
    rows against the CPU's; MO error against ground truth beside the 5 mm
    runs' (printed, not gated)."""
    from vloam_tpu_torch.lidar.loam_step import (BatchLoamEngine, LoamEngine,
                                                 unpack_outputs)
    from vloam_tpu_torch.tools.bench import PACK12_SCALE as sc
    from vloam_tpu_torch.vloam_step import VloamEngine, unpack_vloam_outputs

    t0 = time.perf_counter()
    n = PACK_FRAMES
    q = [requantize(f, sc) for f in frames[:n]]
    qs = [[requantize(f, sc) for f in st[:n]] for st in streams]

    def push_batch(eng, k):
        for b in range(BATCH):
            eng.push_polar(b, qs[b][k], range_scale=sc)

    runs = {
        "LoamEngine": _pack_pair(
            lambda p: LoamEngine(cfg, chunk=BATCH_CHUNK, pack12=p,
                                 device="cuda"),
            lambda e, k: e.push_polar(q[k], range_scale=sc), n),
        "VloamEngine": _pack_pair(
            lambda p: VloamEngine(cfg_v, calib, chunk=BATCH_CHUNK, pack12=p,
                                  device="cuda"),
            lambda e, k: e.push_polar(q[k], images[k], range_scale=sc), n),
        "BatchLoamEngine": _pack_pair(
            lambda p: BatchLoamEngine(cfg, BATCH, chunk=BATCH_CHUNK,
                                      pack12=p, device="cuda"),
            push_batch, n),
    }
    want = {"LoamEngine": ((n, 24), lidar_launches(n)),
            "VloamEngine": ((n, 33), lidar_launches(n, zncc_describe=n)),
            "BatchLoamEngine": ((BATCH, n, 24), lidar_launches(
                BATCH * n, row_gather=2 * n, grid_probe=n))}
    for name, (rows, launches) in runs.items():
        shape, counts = want[name]
        if rows[True].shape != shape or not np.isfinite(rows[True]).all():
            fail(f"P: {name}'s pack12 rows {rows[True].shape} are not "
                 f"{shape} finite rows")
        if not np.array_equal(rows[True], rows[False]):
            fail(f"P: {name}'s pack12 rows differ from its uint16 rows by "
                 f"{np.abs(rows[True] - rows[False]).max()}")
        if not launches[True] == launches[False] == counts:
            fail(f"P: {name}'s launches {launches[True]} with pack12, "
                 f"{launches[False]} without, want {counts}")

    # MO max error against ground truth: 3 cm (this phase) and 5 mm (the
    # first n rows of phases 5, 8 and 10)
    outs_b = runs["BatchLoamEngine"][0][True]
    errs = {
        "LoamEngine": (
            _mo_err(unpack_outputs(runs["LoamEngine"][0][True])["t_w_mo"],
                    poses[:n]),
            _mo_err(res5["t_w_mo"][:n], poses[:n])),
        "VloamEngine": (
            _mo_err(unpack_vloam_outputs(runs["VloamEngine"][0][True],
                                         calib)["t_w_mo"], poses[:n]),
            _mo_err(res8["t_w_mo"][:n], poses[:n])),
        "BatchLoamEngine": tuple(max(
            _mo_err(unpack_outputs(o[b][:n])["t_w_mo"], stream_poses[b][:n])
            for b in range(BATCH)) for o in (outs_b, outs10)),
    }

    # the batch engine's pack12 rows on the CPU
    nb, nf = BATCH_CPU
    t_cpu = time.perf_counter()
    eng = BatchLoamEngine(cfg, nb, chunk=nf, pack12=True, device="cpu")
    for k in range(nf):
        for b in range(nb):
            eng.push_polar(b, qs[b][k], range_scale=sc)
    outs_cpu = eng.finish()
    t_cpu = time.perf_counter() - t_cpu
    diff = {"LO": 0.0, "MO": 0.0}
    for b in range(nb):
        res = unpack_outputs(outs_cpu[b])
        ref = unpack_outputs(outs_b[b][:nf])
        for w in diff:
            key = f"t_w_{w.lower()}"
            diff[w] = max(diff[w], float(np.abs(res[key] - ref[key]).max()))
    print(f"[P pack12 on the card] phase 5's and 8's range images and phase "
          f"10's {BATCH} streams requantized to {sc * 100:.0f} cm (clipped at "
          f"4095), {n} frames at chunk {BATCH_CHUNK}: LoamEngine, VloamEngine "
          f"and BatchLoamEngine rows identical with pack12 on and off; "
          f"launches identical ("
          + "; ".join(f"{k} {({c: m for c, m in v[1][True].items() if m})}"
                      for k, v in runs.items())
          + "); MO max err vs GT at 3 cm / at 5 mm (phases 5, 8, 10): "
          + ", ".join(f"{k} {a:.4f} / {b:.4f} m" for k, (a, b) in
                      errs.items())
          + f"; batch pack12 card vs CPU, first {nf} lockstep frames of {nb} "
          "streams: " + ", ".join(
              f"{w} {d:.2e} m (bound {BATCH_CPU_TOL[w]:.0e})"
              for w, d in diff.items())
          + f" (CPU run {t_cpu:.1f} s); phase in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if any(not diff[w] < BATCH_CPU_TOL[w] for w in diff):
        fail("P: card and CPU trajectories of the pack12 batch engine "
             "disagree")


def ring_variants_phase(err: float) -> dict:
    """The measurement entry point that launches ring_argmin2: its path. It
    holds every variant against the plain version before it times them;
    ring_argmin2's row takes its times at the entry point's surf shape."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.tools import profile_ring_variants as prv
    from vloam_tpu_torch.tools import timing

    kernels.reset_launches()
    print("[12 ring variants entry point]", flush=True)
    ms = prv.run(runs=10)
    n = kernels.LAUNCHES["ring_argmin2"]
    if not (n > 0 and kernels.LAUNCHES["ring_min1"] > 0
            and kernels.LAUNCHES["ring_min2"] > 0):
        fail(f"the ring-variants entry point launched {kernels.LAUNCHES}")
    name, S, C, Q = prv.SHAPES[1]
    print(f"[12] ring_argmin2 at {Q} x [{S},3,{C}]: "
          f"{ms[name]['ring_argmin2'] * 1e3:.2f} us ({RING_ARGMIN2_BEFORE_US}"
          f" us before the redesign), ring_min2 "
          f"{ms[name]['ring_min2'] * 1e3:.2f} us {clocks()}", flush=True)
    row = kernel_row("ring_argmin2", "ring_min1.cu", S1_REPLACES, err,
                     ms[name]["ring_argmin2"], ms[name]["plain min2"],
                     timing.ring_reduce_bound(Q, S, C, 4))
    row["launches"] = n
    return row


def k3_phase(cfg, images) -> dict:
    """K3 against its plain version on detected keypoints of 3 rendered
    frames, their last 8 rows replaced by crafted ones: the four image
    corners and a negative x (clipped patches), two keypoints on a constant
    patch (the 1e-3 floor) and one in the middle; then on the crafted cases
    of kernel_cases.zncc_cases."""
    from vloam_tpu_torch.tools import kernel_cases, timing
    from vloam_tpu_torch.vision import features as tf

    crafted = torch.tensor([
        [0.0, 0.0], [IMG_W - 0.1, 0.0], [0.0, IMG_H - 0.1],
        [IMG_W - 0.1, IMG_H - 0.1], [-3.5, 7.2], [20.0, 350.0],
        [40.0, 340.0], [620.4, 187.6]], device="cuda")
    err = 0.0
    n_zero = 0
    inputs = {}

    def held(got, want, what) -> float:
        zg, zw = (got == 0).all(1), (want == 0).all(1)
        e = float((got - want).abs().max())
        if not torch.equal(zg, zw):
            fail(f"K3 {what}: zero rows differ ({int(zg.sum())} kernel, "
                 f"{int(zw.sum())} plain)")
        if not e <= 1e-5:
            fail(f"K3 {what}: max |err| {e} > 1e-5")
        return e

    for k, u8 in enumerate(images[:3]):
        img = torch.from_numpy(u8).cuda().to(torch.float32) / 255.0
        img[300:, :80] = 0.25  # a constant patch at the bottom left
        xy, _, mask = tf.detect_keypoints(img, cfg.vo)
        if int(mask.sum()) < 500:
            fail(f"K3: only {int(mask.sum())} keypoints on frame {k}")
        xy = torch.cat([xy[:-len(crafted)], crafted]).contiguous()
        for p in (24, 16):
            got = tf.zncc_describe(img, xy, p)
            want = tf.zncc_describe_plain(img, xy, p)
            torch.cuda.synchronize()
            err = max(err, held(got, want, f"frame {k} p={p}"))
            zg = (got == 0).all(1)
            if not bool(zg[-3:-1].all()):
                fail(f"K3 p={p}: the constant patch is live")
            n_zero = max(n_zero, int(zg.sum()))
            inputs[p] = (img, xy)
    cases = kernel_cases.zncc_cases()
    for case in cases:
        img = torch.from_numpy(case.img).cuda()
        xy = torch.from_numpy(case.xy).cuda()
        for K in (len(xy), len(xy) - 3):  # and a count no grouping divides
            got = tf.zncc_describe(img, xy[:K], case.p)
            want = tf.zncc_describe_plain(img, xy[:K], case.p)
            torch.cuda.synchronize()
            err = max(err, held(got, want, f"case {case.name} K={K}"))
    times = {p: (timing.device_ms(lambda: tf.zncc_describe(img, xy, p)),
                 timing.device_ms(lambda: tf.zncc_describe(img, xy, p),
                                  cold=False),
                 timing.device_ms(
                     lambda: tf.zncc_describe_plain(img, xy, p)))
             for p, (img, xy) in inputs.items()}
    # the main path's patch size (cfg.vo's 24): image, keypoints and
    # descriptors once; per descriptor element an add for the mean, a
    # subtract, a multiply and an add for the norm and the scaling multiply
    img, xy = inputs[24]
    bound = timing.zncc_bound(len(xy), 24, *img.shape)
    print(f"[7 K3 zncc_describe] 3 frames [{IMG_H},{IMG_W}] x "
          f"{len(xy)} keypoints and {len(cases)} crafted cases ("
          + ", ".join(c.name for c in cases) + f"), max |err| {err:.3g} "
          f"(bound 1e-5), zero rows identical (up to {n_zero} a frame); "
          + "; ".join(f"p={p} kernel {k * 1e3:.1f} us cold L2, "
                      f"{w * 1e3:.1f} us warm, plain {q * 1e3:.1f} us"
                      for p, (k, w, q) in times.items())
          + f"; before the redesign {K3_BEFORE_US} us (p=24, cold); bound by "
          f"{bound[1]} {bound[0] * 1e3:.2f} us (p=24) {clocks()}",
          flush=True)
    ms, _, plain_ms = times[24]
    return kernel_row("zncc_describe", "zncc_describe.cu",
                      "vloam_tpu/vision/features.py:411", err, ms, plain_ms,
                      bound)


def vloam_errors(res, poses, calib) -> dict:
    """LO / MO max position error and the VO ATE (position RMSE in the cam0
    start frame, where both trajectories start at the identity, so no
    alignment) against ground truth, and the fewest 3D-2D matches over
    frames >= 1."""
    gt_w = np.stack([T[:3, 3] for T in poses])
    B = calib.imu_T_cam0
    T0 = poses[0] @ B
    gt_c = np.stack([(np.linalg.inv(T0) @ (T @ B))[:3, 3] for T in poses])
    vo = np.linalg.norm(res["traj_VO"][:, :, 3] - gt_c, axis=1)
    return {"LO": float(np.linalg.norm(res["t_w_lo"] - gt_w, axis=1).max()),
            "MO": float(np.linalg.norm(res["t_w_mo"] - gt_w, axis=1).max()),
            "VO": float(np.sqrt(np.mean(vo ** 2))),
            "n32": int(res["n32"][1:].min())}


def vloam_phase(cfg, frames, images, poses, calib, walls):
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.vloam_step import VloamEngine, unpack_vloam_outputs

    eng = VloamEngine(cfg, calib, chunk=CHUNK, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for k in range(CHUNK):
        eng.push_polar(frames[k], images[k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, syncs = _sync_free(lambda k: eng.push_polar(frames[k], images[k]),
                             range(CHUNK, N_FRAMES))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    clk = clocks()
    outs = eng.finish()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    if outs.shape != (N_FRAMES, 33) or not np.isfinite(outs).all():
        fail(f"combined outputs {outs.shape} not finite")
    res = unpack_vloam_outputs(outs, calib)
    err = vloam_errors(res, poses, calib)
    n = N_FRAMES - CHUNK
    walls["VloamEngine"] = dt * 1e3 / n
    print(f"[8 combined end to end] {N_FRAMES} frames kitti_hdl64 "
          f"detach_VO_LO=False 64x{N_AZ} + {IMG_W}x{IMG_H}: {n / dt:.2f} "
          f"frames/s over frames {CHUNK}-{N_FRAMES - 1} ({dt * 1e3 / n:.2f} "
          f"ms/frame, host clock between synchronizes; host enqueue "
          f"{host * 1e3 / n:.2f} ms/frame); launches {launches}; max err vs "
          f"GT LO {err['LO']:.4f} m, MO {err['MO']:.4f} m; VO ATE vs GT "
          f"{err['VO']:.4f} m; min n32 over frames >= 1 {err['n32']}; "
          f"peak device memory {peak:.0f} MiB; host syncs in the timed "
          f"frames {len(syncs)} {clk}", flush=True)
    want = lidar_launches(N_FRAMES, zncc_describe=N_FRAMES)
    if launches != want:
        fail(f"kernel launch counts {launches}, want {want}")
    if syncs:
        fail(f"the frame loop synchronized with the device: {syncs[:3]}")
    if not err["MO"] < 0.15:
        fail(f"MO error {err['MO']} m >= 0.15 m")
    if err["n32"] == 0:
        fail("a frame after the first had no depth-backed VO match")
    return res, launches, depth_grid_check(eng, frames[N_FRAMES - 1],
                                           images[N_FRAMES - 1])


def depth_grid_check(eng, frame, image) -> str:
    """The depth grid of one more real frame through the phase-8 engine,
    built again twice from the inputs the engine gave it: identical, or the
    run fails (its per-cell sums add in a fixed order); and beside the
    CPU's."""
    from vloam_tpu_torch import vloam_step
    from vloam_tpu_torch.vision import depth_map

    seen = []
    real = vloam_step.build_depth_grid

    def recorder(*args):
        seen.append(args)
        return real(*args)

    vloam_step.build_depth_grid = recorder
    try:
        eng.push_polar(frame, image)
        eng.finish()
    finally:
        vloam_step.build_depth_grid = real
    scan, mask, P, vo = seen[0]
    grids = [depth_map.build_depth_grid(scan, mask, P, vo) for _ in range(2)]
    cpu = depth_map.build_depth_grid(scan.cpu(), mask.cpu(), P.cpu(), vo)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*grids)):
        fail("the depth grid differs between two builds on the card")
    same = all(torch.equal(a.cpu(), c) for a, c in zip(grids[0], cpu))
    diff = max(float((a.cpu() - c).abs().max()) for a, c in zip(grids[0],
                                                                 cpu))
    return (f"depth grid of a real frame ({int(mask.sum())} points, "
            f"{int((grids[0].cnt > 0).sum())} cells filled) identical in two "
            f"builds on the card; against the CPU's "
            + ("identical" if same else f"max |diff| {diff:.3g}"))


def vloam_cpu_phase(cfg, frames, images, calib, res_gpu, grid_line) -> None:
    from vloam_tpu_torch.vloam_step import VloamEngine, unpack_vloam_outputs

    t0 = time.perf_counter()
    n = VLOAM_CPU_FRAMES
    eng = VloamEngine(cfg, calib, chunk=n, device="cpu")
    for k in range(n):
        eng.push_polar(frames[k], images[k])
    res = unpack_vloam_outputs(eng.finish(), calib)
    diff = {w: float(np.abs(res[f"traj_{w}"][:, :, 3]
                            - res_gpu[f"traj_{w}"][:n, :, 3]).max())
            for w in VLOAM_CPU_TOL}
    print(f"[9 combined card vs CPU] {grid_line}; first {n} frames: max "
          "position diff "
          + ", ".join(f"{w} {d:.2e} m (bound {VLOAM_CPU_TOL[w]:.0e})"
                      for w, d in diff.items())
          + f"; n32 {res['n32'].tolist()} vs {res_gpu['n32'][:n].tolist()} "
          f"(CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    if any(not diff[w] < VLOAM_CPU_TOL[w] for w in diff):
        fail("card and CPU trajectories of the combined engine disagree")


_KERNELS = ("select_rings_kernel", "ring_min1_packed_kernel",
            "row_gather_kernel", "grid_probe_kernel", "zncc_describe_kernel")


def _profile(push, first: int, n: int = PROFILE_FRAMES) -> dict:
    """torch.profiler over n frames pushed after `first` frames: per frame,
    CUDA kernel launches, device kernels, device kernel
    time, host enqueue and wall time; and the device time per launch of
    each hand-written kernel. Phase 13's alone: the smoke's one pass that
    traces the device, which tests/test_torch_loam_engine.py holds it
    to."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for k in range(first):
        push(k)
    torch.cuda.synchronize()
    # the device's activity and the runtime's calls (the launches) only: no
    # host operator is recorded
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(first, first + n):
            push(k)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    records = _records(prof)
    dev = [(name, us) for name, device, us in records
           if device == DeviceType.CUDA]
    per_launch = {}
    for kernel in _KERNELS:
        hits = [us for name, us in dev if kernel in name]
        if hits:
            per_launch[kernel] = sum(hits) / len(hits)
    return {
        "kernel_us": per_launch,
        "launches": _launch_calls(records) / n,
        "device_kernels": len(dev) / n,
        "device_ms": sum(us for _, us in dev) / 1e3 / n,
        "host_ms": host * 1e3 / n, "wall_ms": wall * 1e3 / n}


def _records(prof) -> list[tuple]:
    """A finished torch.profiler's records as it recorded them, each (name,
    device type, us): read without its post-processing into FunctionEvents
    (key_averages() builds their tree: 5-18 s a chunk of 4 frames of an
    engine on an H100's host, 0.4-0.7 s this way, the same counts and
    times); hidden records left out, as key_averages() leaves them."""
    return [(e.name(), e.device_type(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if not getattr(e, "is_hidden_event", lambda: False)()]


def _launch_calls(records) -> int:
    """The kernel launch calls (cudaLaunchKernel, cuLaunchKernel) among
    records."""
    return sum(name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
               for name, _, _ in records)


def _host_launches(fn) -> int:
    """The kernel launches fn() makes, under a torch.profiler that records
    host activity only: no device trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _launch_calls(_records(prof))


def profile_phase(cfg, cfg_v, frames, images, calib, streams) -> dict:
    from vloam_tpu_torch.lidar.loam_step import BatchLoamEngine, LoamEngine
    from vloam_tpu_torch.vloam_step import VloamEngine

    lo = LoamEngine(cfg, chunk=PROFILE_FRAMES, device="cuda")
    vl = VloamEngine(cfg_v, calib, chunk=PROFILE_FRAMES, device="cuda")
    ba = BatchLoamEngine(cfg, BATCH, chunk=BATCH_CHUNK, device="cuda")
    stats = {
        "LoamEngine": _profile(lambda k: lo.push_polar(frames[k]),
                               PROFILE_FRAMES),
        "VloamEngine": _profile(
            lambda k: vl.push_polar(frames[k], images[k]), PROFILE_FRAMES),
        f"BatchLoamEngine x{BATCH} (per lockstep frame, frames "
        f"{PROFILE_FRAMES}-{PROFILE_FRAMES + BATCH_CHUNK - 1}, chunk "
        f"{BATCH_CHUNK})": _profile(
            lambda k: _lockstep(ba, streams, [k]), PROFILE_FRAMES,
            BATCH_CHUNK)}
    lo.finish()
    vl.finish()
    ba.finish()
    k3 = stats["VloamEngine"]["kernel_us"].get("zncc_describe_kernel")
    print("[13 launches per frame] torch.profiler over frames "
          f"{PROFILE_FRAMES}-{2 * PROFILE_FRAMES - 1}, chunk {PROFILE_FRAMES}"
          " (profiler on): K3 zncc_describe in VloamEngine "
          + (f"{k3:.1f} us per launch" if k3 else "not recorded")
          + "; " + "; ".join(
              f"{name} {s['launches']:.0f} kernel launches, "
              f"{s['device_kernels']:.0f} device kernels, device "
              f"{s['device_ms']:.2f} ms, host enqueue {s['host_ms']:.2f} ms, "
              f"wall {s['wall_ms']:.2f} ms; device us per launch "
              + ", ".join(f"{k.split('_kernel')[0]} {v:.1f}"
                          for k, v in s["kernel_us"].items())
              for name, s in stats.items()), flush=True)
    return stats


def stage_phase(frames, images, stats13, walls) -> None:
    """Phase T: the three stage profilers; gates on capture, on the stage
    splits' launch sums and on each stage's hand-written kernels."""
    from vloam_tpu_torch.tools import (profile_batch_stages,
                                       profile_stages, profile_vision_stages)

    t0 = time.perf_counter()
    kw = {"runs": STAGE_RUNS, "replays": STAGE_REPLAYS, "chunk": STAGE_CHUNK}
    recs = {
        "LoamEngine": profile_stages.run(frames=frames[:3], **kw),
        "VloamEngine": profile_vision_stages.run(
            frames=frames[:3], images=images[:3], **kw),
        "BatchLoamEngine": profile_batch_stages.run(
            frames=frames[:max(3, 2 * STAGE_CHUNK)], **kw)}
    dt = time.perf_counter() - t0
    polar = [r for r in recs["LoamEngine"]["stages"]
             if r["key"].startswith("polar:")]
    bad = [f"{r['key']}: {r['capture_error']}" for r in polar
           if r["capture_error"] or r["device_how"] != "graph replay"]
    if len(polar) != 7 or bad:
        fail(f"LoamEngine polar stages not captured: {bad or polar}")
    sums = {c["name"]: c for rec in recs.values()
            for c in rec["checks"]["sums"]}
    want = {"LoamEngine polar frame", "LoamEngine xyz frame",
            "VloamEngine frame", "single-stream polar frame",
            f"BatchLoamEngine lockstep frame (B={BATCH})"}
    if set(sums) != want or not all(c["ok"] and c["captured"]
                                    for c in sums.values()):
        fail(f"stage launches do not sum to their frame's: {sums}")
    hand = [c for rec in recs.values() for c in rec["checks"]["hand"]]
    if not hand or not all(c["ok"] for c in hand):
        fail("hand-written kernels by stage: "
             f"{[c for c in hand if not c['ok']]}")
    whole = {"LoamEngine": "polar:frame", "VloamEngine": "vloam:frame",
             "BatchLoamEngine": f"{BATCH}:frame"}
    names13 = dict(zip(whole, stats13))
    print("[T stage profilers] tools/profile_stages.py, "
          "profile_vision_stages.py, profile_batch_stages.py at full width "
          f"({STAGE_RUNS} host call, {STAGE_REPLAYS} graph replays a stage, "
          f"chunks of {STAGE_CHUNK}) in {dt:.1f} s: every LoamEngine polar "
          f"stage captured; {len(sums)} frame splits' launches sum to their "
          f"frames'; {len(hand)} stages' hand-written kernels as the "
          "engines'. A frame, whole: " + "; ".join(
              f"{eng} {r['launches']} kernel nodes, device "
              f"{r['device_ms']:.2f} ms (graph replay), host enqueue "
              f"{r['host_ms']:.2f} ms, wall {r['wall_ms']:.2f} ms; phase 13 "
              f"(profiler) device {stats13[names13[eng]]['device_ms']:.2f} "
              f"ms, wall {stats13[names13[eng]]['wall_ms']:.2f} ms; end to "
              f"end (phase {ph}) wall {walls[eng]:.2f} ms"
              for eng, ph in (("LoamEngine", 5), ("VloamEngine", 8),
                              ("BatchLoamEngine", 10))
              for r in [next(x for x in recs[eng]["stages"]
                             if x["key"] == whole[eng])]), flush=True)


def _xyz(frame) -> np.ndarray:
    """A polar frame decoded on the host to its returns [n, 3] float32 (the
    points a KITTI velodyne file holds)."""
    from vloam_tpu_torch.data.synthetic import hdl64_elevations
    from vloam_tpu_torch.lidar.loam_step import polar_to_xyz

    elev = torch.tensor(np.radians(hdl64_elevations(frame.shape[0])),
                        dtype=torch.float32)
    xyz = polar_to_xyz(torch.from_numpy(frame.astype(np.int32)), elev,
                       0.005).numpy()
    return xyz[frame.reshape(-1) > 0]


def write_kitti_layout(root, frames, poses, calib) -> None:
    """The drive as a KITTI odometry sequence 00 under root: velodyne/*.bin
    (float32 x, y, z, reflectance), calib.txt (P0..P3, Tr = velo -> cam0),
    times.txt, and the ground truth as root/poses_00.txt (cam0 poses in the
    first cam0 frame, as tests/fixtures/kitti_mini)."""
    from pathlib import Path

    seq = Path(root) / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    for k, f in enumerate(frames):
        pts = _xyz(f)
        np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).astype(
            np.float32).tofile(seq / "velodyne" / f"{k:06d}.bin")
    P0 = np.hstack([calib.K, np.zeros((3, 1))])
    Tr = np.linalg.inv(calib.imu_T_cam0)[:3]  # velo -> cam0

    def row(m):
        return " ".join(f"{v:.12e}" for v in np.ravel(m))

    (seq / "calib.txt").write_text(
        "".join(f"P{i}: {row(P0)}\n" for i in range(4)) + f"Tr: {row(Tr)}\n")
    (seq / "times.txt").write_text(
        "".join(f"{0.1 * k:.6e}\n" for k in range(len(frames))))
    B = calib.imu_T_cam0
    T0 = np.linalg.inv(poses[0] @ B)
    (Path(root) / "poses_00.txt").write_text("".join(
        row((T0 @ T @ B)[:3]) + "\n" for T in poses))


def _cli(*args, timeout=600) -> str:
    """python -m vloam_tpu_torch ARGS from the checkout's root; its stdout,
    or the run fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", "vloam_tpu_torch", *args],
                          cwd=root, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        fail(f"python -m vloam_tpu_torch {' '.join(args)} exited "
             f"{proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout


def _load_poses(path) -> np.ndarray:
    return np.atleast_2d(np.loadtxt(path)).reshape(-1, 3, 4)


def _projected_rings(data, frames) -> str:
    """The range images the command line reads (--polar-ingest) hold rings
    0-50 only, one row per written ring: the reference's HDL-64 ring formula
    keeps ring ids 0-50 and drops the 13 lowest beams (scan_registration.cpp,
    runtime/native/kitti_io.cpp), as on a real KITTI scan. Fails otherwise;
    returns the line to print."""
    from vloam_tpu_torch.data.kitti import KittiOdometrySequence

    seq = KittiOdometrySequence(str(data), "00", polar_ingest=True)
    kept = [0, N_FRAMES - 1]
    for k in kept:
        img = seq.frame(k)["polar"]
        rows = np.flatnonzero((img > 0).any(axis=1)).tolist()
        if rows != list(range(51)):
            fail(f"frame {k} re-projected onto rings {rows}, want 0-50")
    cells = [int((seq.frame(k)["polar"] > 0).sum()) for k in kept]
    src = [int((frames[k][:51] > 0).sum()) for k in kept]
    return (f"re-projected rings 0-50 of 64 (frames {kept}: {cells} returns, "
            f"{src} in the drive's rings 0-50)")


def host_cli_phase(frames, poses, calib) -> None:
    """14a: the drive written as a KITTI odometry layout, run by the command
    line in a subprocess with no --device (the default must be the card),
    then scored by its eval command against the ground truth."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data, out, maps = (Path(tmp) / d for d in ("kitti", "out", "maps"))
        write_kitti_layout(data, frames, poses, calib)
        t_write = time.perf_counter() - t0
        rings = _projected_rings(data, frames)
        t0 = time.perf_counter()
        stdout = _cli("run", "--odometry-root", str(data), "--seq", "00",
                      "--sensor", "hdl64", "--mode", "lidar-only",
                      "--polar-ingest", "--chunk", str(CHUNK), "--save-map",
                      str(maps), "--out", str(out))
        t_run = time.perf_counter() - t0
        m = json.loads(_cli("eval", "--gt", str(data / "poses_00.txt"),
                            "--pred", str(out / "MO1.txt")))
        trajs = {w: _load_poses(out / f"{w}1.txt") for w in ("LO", "MO")}
        published = sorted(p.name for p in maps.glob("*.npz"))
        sizes = {}
        for name in published:
            with np.load(maps / name) as z:
                sizes[name] = (len(z["corner"]), len(z["surf"]))
    lines = {ln.split(":")[0]: ln for ln in stdout.splitlines()
             if ln.startswith(("kitti io", "throughput", "kernel launches"))}
    launches = json.loads(lines["kernel launches"].split(": ", 1)[1])
    print(f"[14a host layer: CLI] python -m vloam_tpu_torch run "
          f"--polar-ingest --chunk {CHUNK} --save-map over the drive written "
          f"as KITTI odometry sequence 00 ({t_write:.1f} s to write): "
          f"{lines.get('kitti io')}; {rings}; {lines.get('throughput')} "
          f"(whole run, start-up included; the subprocess took {t_run:.1f} "
          f"s); {lines['kernel launches']}; eval MO1 vs GT "
          f"{json.dumps(m)}; published maps {sizes}", flush=True)
    if "on cuda" not in lines.get("throughput", ""):
        fail("the command line did not run on the card by default")
    if launches != lidar_launches(N_FRAMES):
        fail(f"CLI kernel launch counts {launches}, want "
             f"{lidar_launches(N_FRAMES)}")
    for w, tr in trajs.items():
        if tr.shape != (N_FRAMES, 3, 4) or not np.isfinite(tr).all():
            fail(f"{w}1.txt holds {tr.shape}, not {N_FRAMES} finite poses")
    if not m["ate_max_m"] < 0.15:
        fail(f"CLI MO error {m['ate_max_m']} m >= 0.15 m")
    if published != [f"map_{N_FRAMES:06d}.npz"] or not all(
            c > 0 and s > 0 for c, s in sizes.values()):
        fail(f"published maps {sizes}, want one map_{N_FRAMES:06d}.npz with "
             "corner and surf points")


def host_combined_phase(cfg, frames, images, poses, calib) -> dict:
    """14b: run_sequence_fused in combined mode on the card with --save-map's
    publication; no host sync in frames 1-15 (the first chunk; frame 0
    uploads the polar geometry once)."""
    import tempfile
    from pathlib import Path

    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.pipeline import run_sequence_fused

    syncs = []

    def feed():
        yield {"polar": frames[0], "image": images[0]}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            for k in range(1, CHUNK):
                yield {"polar": frames[k], "image": images[k]}
            torch.cuda.set_sync_debug_mode("default")
        syncs.extend(str(w.message) for w in caught
                     if "synchronizing CUDA operation" in str(w.message))
        for k in range(CHUNK, N_FRAMES):
            yield {"polar": frames[k], "image": images[k]}

    torch.cuda.synchronize()
    kernels.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_sequence_fused(cfg, calib, feed(), chunk=CHUNK,
                                 save_map=tmp, device="cuda")
        published = sorted(p.name for p in Path(tmp).glob("*.npz"))
    launches = dict(kernels.LAUNCHES)
    err = vloam_errors(res["raw"], poses, calib)
    print(f"[14b host layer: combined] run_sequence_fused(kitti_hdl64 "
          f"detach_VO_LO=False, chunk {CHUNK}, save_map, device cuda) over "
          f"the drive: {res['fps']:.2f} frames/s (its own clock, all "
          f"{N_FRAMES} frames, start-up included); launches {launches}; max "
          f"err vs GT LO {err['LO']:.4f} m, MO {err['MO']:.4f} m; VO ATE "
          f"{err['VO']:.4f} m; min n32 {err['n32']}; published {published}; "
          f"host syncs in frames 1-{CHUNK - 1} {len(syncs)} {clocks()}",
          flush=True)
    if launches != lidar_launches(N_FRAMES, zncc_describe=N_FRAMES):
        fail(f"kernel launch counts {launches}")
    if syncs:
        fail(f"the first chunk synchronized with the device: {syncs[:3]}")
    if not err["MO"] < 0.15 or err["n32"] == 0:
        fail(f"combined host-layer errors {err}")
    if published != [f"map_{N_FRAMES:06d}.npz"]:
        fail(f"published maps {published}")
    return res


def host_resume_phase(cfg, frames, outs_gpu) -> None:
    """14c: LoamEngine over frames 0-15, its state saved and loaded into a
    fresh engine, which runs frames 16-31: the state round-trips bit for
    bit and the resumed rows equal phase 5's uninterrupted run's."""
    import tempfile
    from pathlib import Path

    from vloam_tpu_torch.lidar.loam_step import LoamEngine
    from vloam_tpu_torch.runtime import checkpoint

    eng = LoamEngine(cfg, chunk=CHUNK, device="cuda")
    for k in range(CHUNK):
        eng.push_polar(frames[k])
    fresh = LoamEngine(cfg, chunk=CHUNK, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "state.npz")
        t0 = time.perf_counter()
        checkpoint.save_state(path, eng.state)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        fresh.state = checkpoint.load_state(path, fresh.state)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    a, b = checkpoint._flatten(eng.state), checkpoint._flatten(fresh.state)
    same_state = a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    first = eng.finish()
    for k in range(CHUNK, N_FRAMES):
        fresh.push_polar(frames[k])
    rows = fresh.finish()
    diff = float(np.abs(rows - outs_gpu[CHUNK:]).max())
    same_rows = np.array_equal(rows, outs_gpu[CHUNK:]) and np.array_equal(
        first, outs_gpu[:CHUNK])
    print(f"[14c host layer: resume] LoamEngine frames 0-{CHUNK - 1}, "
          f"save_state ({size / 2**20:.1f} MiB, {t_save:.2f} s) and "
          f"load_state ({t_load:.2f} s) into a fresh engine, frames "
          f"{CHUNK}-{N_FRAMES - 1}: {len(a)} leaves "
          + ("bit-identical" if same_state else "DIFFER")
          + f"; rows against phase 5's uninterrupted run "
          + ("bit-identical" if same_rows else f"max |diff| {diff:.3g}"),
          flush=True)
    if not same_state:
        fail("the state did not round-trip bit for bit")
    if not same_rows:
        fail(f"resumed rows differ from the uninterrupted run by {diff}")


def host_loop_phase(cfg, frames, res) -> dict:
    """14d: close_loops on 14b's MO trajectory (min_gap 8, radius 50) twice
    on the card (identical) and once on the CPU (within the parity test's
    1e-3 m / 1e-3 rad), the poses within 1 m of MO."""
    from scipy.spatial.transform import Rotation as R

    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.backend.loop_closure import (close_loops,
                                                      find_loop_candidates)
    from vloam_tpu_torch.data.synthetic import pad_scan

    q, t = res["raw"]["q_w_mo"], res["raw"]["t_w_mo"]
    scans = [pad_scan(_xyz(f), cfg.lidar.max_points) for f in frames]
    n_cand = len(find_loop_candidates(t, 50.0, 8))

    def run(device):
        return close_loops(q, t, scans.__getitem__, cfg, radius=50.0,
                           min_gap=8, device=device)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    card = run("cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    again = {}
    total = _host_launches(lambda: again.update(run("cuda")))
    t0 = time.perf_counter()
    cpu = run("cpu")
    dt_cpu = time.perf_counter() - t0
    dp = float(np.abs(card["poses"][:, 4:] - cpu["poses"][:, 4:]).max())
    dr = float((R.from_quat(card["poses"][:, :4]).inv()
                * R.from_quat(cpu["poses"][:, :4])).magnitude().max())
    moved = float(np.linalg.norm(card["poses"][:, 4:] - t, axis=1).max())
    same = (card["loops"] == again["loops"]
            and np.array_equal(card["poses"], again["poses"]))
    cg = max(64, 3 * N_FRAMES)
    print(f"[14d host layer: loop closure] close_loops on 14b's MO "
          f"trajectory (min_gap 8, radius 50): {n_cand} candidates, "
          f"{len(card['loops'])} loops accepted {card['loops']}; "
          f"{dt:.2f} s on the card (CPU {dt_cpu:.2f} s); kernel launches "
          f"{launches}, {total} CUDA kernel launches in all (the second "
          f"run, counted on the host; 6 "
          f"Gauss-Newton rounds x {cg} CG iterations); two card runs "
          + ("identical" if same else "DIFFER")
          + f"; card vs CPU max diff {dp:.2e} m, {dr:.2e} rad (loops "
          + ("equal" if card["loops"] == cpu["loops"] else
             f"differ: CPU {cpu['loops']}")
          + f"); max move from MO {moved:.4f} m", flush=True)
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(select_rings=2 * n_cand, ring_min1_packed=4 * n_cand)
    if launches != want:
        fail(f"close_loops kernel launch counts {launches}, want {want}")
    if not same:
        fail("two card runs of close_loops differ")
    if card["loops"] != cpu["loops"] or not (dp < 1e-3 and dr < 1e-3):
        fail("close_loops on the card and on the CPU disagree")
    if not moved < 1.0 or not card["loops"]:
        fail(f"loop closure moved the trajectory {moved} m or accepted no "
             "loop")
    return card


def _host_frames(frames, images) -> list[dict]:
    """The drive as the host engine reads it: each polar frame decoded to
    its xyz returns, each image as float32 in [0, 1]."""
    return [{"points": _xyz(f), "image": im.astype(np.float32) / 255.0}
            for f, im in zip(frames, images)]


def _cam_errors(trajs, poses, calib) -> dict:
    """LO / MO max position error and VO ATE (position RMSE) of cam0-start
    trajectories [N, 3, 4] against ground truth (as vloam_errors)."""
    B = calib.imu_T_cam0
    T0 = poses[0] @ B
    gt_c = np.stack([(np.linalg.inv(T0) @ (T @ B))[:3, 3] for T in poses])
    d = {w: np.linalg.norm(trajs[w][:, :, 3] - gt_c[:len(trajs[w])], axis=1)
         for w in ("VO", "LO", "MO")}
    return {"LO": float(d["LO"].max()), "MO": float(d["MO"].max()),
            "VO": float(np.sqrt(np.mean(d["VO"] ** 2)))}


def host_engine_phase(cfg, host_frames, poses, calib, res_fused) -> dict:
    """15a: run_sequence (the per-stage host engine) over the drive on the
    card, every host sync counted; errors against ground truth and against
    14b's fused run of the same frames, the kernels it launches."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.pipeline import run_sequence
    from vloam_tpu_torch.runtime.profiling import summarize_timings

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = run_sequence(cfg, calib, host_frames, device="cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    clk = clocks()
    syncs = sum("synchronizing CUDA operation" in str(w.message)
                for w in caught)
    launches = dict(kernels.LAUNCHES)
    err = _cam_errors(res, poses, calib)
    fused = res_fused["raw"]
    vs_fused = {w: float(np.linalg.norm(res[w][:, :, 3]
                                        - fused[f"traj_{w}"][:, :, 3],
                                        axis=1).max()) for w in ("LO", "MO")}
    summary = summarize_timings(res["timings"])
    print(f"[15a host engine] run_sequence(kitti_hdl64 detach_VO_LO=False, "
          f"device cuda) over the drive decoded to xyz + float images: "
          f"{N_FRAMES / dt:.2f} frames/s (its own clock, all {N_FRAMES} "
          f"frames, start-up and sync debug mode included); host syncs "
          f"{syncs / N_FRAMES:.2f} a frame; launches {launches}; max err vs "
          f"GT LO {err['LO']:.4f} m, MO {err['MO']:.4f} m; VO ATE "
          f"{err['VO']:.4f} m; against 14b's fused run LO "
          f"{vs_fused['LO']:.4f} m, MO {vs_fused['MO']:.4f} m; stage ms "
          f"(mean, frames 2 on) "
          + json.dumps({k: round(v, 3) for k, v in summary.items()})
          + f" {clk}", flush=True)
    if not all(np.isfinite(res[w]).all() and res[w].shape == (N_FRAMES, 3, 4)
               for w in ("VO", "LO", "MO")):
        fail("the host engine's trajectories are not finite")
    if not err["MO"] < 0.15:
        fail(f"host engine MO error {err['MO']} m >= 0.15 m")
    if not max(vs_fused.values()) < 0.05:
        fail(f"host engine against the fused engine {vs_fused}")
    path = ("select_rings", "ring_min1_packed", "grid_probe", "row_gather",
            "zncc_describe")
    if not all(launches[k] > 0 for k in path):
        fail(f"the host engine did not launch every kernel of its path: "
             f"{launches}")
    return res


def host_cpu_phase(cfg, host_frames, calib, res_gpu) -> None:
    """15b: the first frames of 15a again on the CPU."""
    from vloam_tpu_torch.pipeline import run_sequence

    n = VLOAM_CPU_FRAMES
    t0 = time.perf_counter()
    res = run_sequence(cfg, calib, host_frames[:n], device="cpu")
    diff = {w: float(np.abs(res[w][:, :, 3] - res_gpu[w][:n, :, 3]).max())
            for w in VLOAM_CPU_TOL}
    print(f"[15b host engine card vs CPU] first {n} frames: max position "
          "diff " + ", ".join(f"{w} {d:.2e} m (bound {VLOAM_CPU_TOL[w]:.0e})"
                              for w, d in diff.items())
          + f" (CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    if any(not diff[w] < VLOAM_CPU_TOL[w] for w in diff):
        fail("card and CPU trajectories of the host engine disagree")


def flow_phase(cfg, frames, images, poses, calib, walls) -> None:
    """15c: lk_flow at full width (2048 keypoints, window 15, 3 levels, 10
    iterations) on one frame pair, card against CPU; then VloamEngine over
    the drive with optical_flow_match and with lowtex_fallback at chunk 4:
    frames 0-7 warm, no host sync in frames 8-31, their frames/s beside
    phase 8's default path's, errors."""
    import dataclasses

    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.tools.timing import device_ms
    from vloam_tpu_torch.vision.features import detect_keypoints
    from vloam_tpu_torch.vision.optical_flow import lk_flow
    from vloam_tpu_torch.vloam_step import VloamEngine, unpack_vloam_outputs

    vo = cfg.vo
    img0, img1 = (torch.from_numpy(images[k]).to("cuda").float() / 255.0
                  for k in (0, 1))
    xy0, _, mask = detect_keypoints(img0, vo)
    gxy, gok = lk_flow(img0, img1, xy0, vo)
    cxy, cok = lk_flow(img0.cpu(), img1.cpu(), xy0.cpu(), vo)
    gxy, gok, mask = gxy.cpu(), gok.cpu(), mask.cpu()
    agree = float((gok == cok)[mask].float().mean())
    both = mask & gok & cok
    close = float(((gxy - cxy).abs().amax(dim=1) <= 0.01)[both].float()
                  .mean())
    ms = device_ms(lambda: lk_flow(img0, img1, xy0, vo), runs=5, cold=False)
    print(f"[15c LK flow] {xy0.shape[0]} keypoint rows ({int(mask.sum())} "
          f"detected) of {IMG_W}x{IMG_H}, "
          f"window {vo.flow_window}, {vo.flow_levels} levels, "
          f"{vo.flow_iterations} iterations: card tracks {int(gok[mask].sum())}"
          f", CPU {int(cok[mask].sum())}; status agrees on {agree:.4f} of "
          f"the keypoints, xy1 within 0.01 px on {close:.4f} of the "
          f"{int(both.sum())} both track (max |diff| "
          f"{float((gxy - cxy).abs()[both].max()):.2e} px); {ms:.3f} ms on "
          f"the card (5 calls queued)", flush=True)
    if not (agree >= 0.99 and close >= 0.99):
        fail("lk_flow on the card and on the CPU disagree")
    for option in ("optical_flow_match", "lowtex_fallback"):
        cfg_o = cfg.replace(vo=dataclasses.replace(vo, **{option: True}))
        eng = VloamEngine(cfg_o, calib, chunk=V_CHUNK, device="cuda")
        kernels.reset_launches()
        fps, host, syncs = _v_drive(
            lambda k: eng.push_polar(frames[k], images[k]), N_FRAMES)
        outs = eng.finish()
        launches = dict(kernels.LAUNCHES)
        if outs.shape != (N_FRAMES, 33) or not np.isfinite(outs).all():
            fail(f"{option}: outputs {outs.shape} not finite")
        err = vloam_errors(unpack_vloam_outputs(outs, calib), poses, calib)
        print(f"[15c VloamEngine {option}=True] {fps:.2f} frames/s, host "
              f"enqueue {host:.2f} ms a frame over frames {2 * V_CHUNK}-"
              f"{N_FRAMES - 1} at chunk {V_CHUNK} (phase 8's default path "
              f"{1e3 / walls['VloamEngine']:.2f} frames/s at chunk {CHUNK}); "
              f"hand-kernel "
              f"launches {launches}; max err vs GT LO {err['LO']:.4f} m, MO "
              f"{err['MO']:.4f} m; VO ATE {err['VO']:.4f} m; min n32 "
              f"{err['n32']}; host syncs {len(syncs)} {clocks()}", flush=True)
        if syncs:
            fail(f"{option}: the frame loop synchronized: {syncs[:3]}")
        if not err["MO"] < 0.15:
            fail(f"{option}: MO error {err['MO']} m >= 0.15 m")


V_FRAMES = 16  # frames of the option engines' drives (V3, V4)
V_CHUNK = 4  # frames 0-7 warm, 8-15 timed (and 15c's 8-31)
V_DETECTORS = ("fast", "orb", "brisk", "sift", "akaze")
V5_POINTS, V5_OUTLIERS, V5_HYP = 2048, 614, 256


def _v_drive(push, n_frames=V_FRAMES):
    """Frames 0-7 warm (two chunks of V_CHUNK), 8..n_frames-1 timed with
    every host sync recorded: (frames/s and host enqueue ms of the timed
    frames, the sync warnings)."""
    for k in range(2 * V_CHUNK):
        push(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, syncs = _sync_free(push, range(2 * V_CHUNK, n_frames))
    torch.cuda.synchronize()
    n = n_frames - 2 * V_CHUNK
    return n / (time.perf_counter() - t0), host * 1e3 / n, syncs


def detector_phase(vo, images, dev="cuda") -> float:
    """V1: detect_keypoints with each alternate detector on frame 0 of the
    combined drive, on the card and on the CPU (the port's plain path).
    Returns the FAST threshold used (the config's, or 0.06 where it finds
    fewer than 50 FAST corners on the synthetic images)."""
    import dataclasses

    from vloam_tpu_torch.tools.timing import device_ms
    from vloam_tpu_torch.vision import features

    img = torch.from_numpy(images[0]).to(dev).float() / 255.0
    thr = vo.fast_threshold
    n_fast = int(features.detect_keypoints(
        img, dataclasses.replace(vo, detector="fast"))[2].sum())
    note = f"fast_threshold {thr:.4f} (the config's)"
    if n_fast < 50:
        thr = 0.06
        note = (f"fast_threshold 0.06: the config's {vo.fast_threshold:.4f} "
                f"finds {n_fast} FAST corners on the synthetic image")
    parts = []
    for det in V_DETECTORS:
        cfg = dataclasses.replace(vo, detector=det, fast_threshold=thr)
        xy, score, mask = (a.cpu() for a in features.detect_keypoints(img,
                                                                      cfg))
        xc, sc, mc = features.detect_keypoints(img.cpu(), cfg)
        resp = features.detector_response(img, cfg).cpu()
        resp_c = features.detector_response(img.cpu(), cfg)
        same = float((xy == xc).all(dim=1)[mask].float().mean())
        ms = device_ms(lambda: features.detect_keypoints(img, cfg), runs=5,
                       cold=False)
        parts.append(
            f"{det} {int(mask.sum())} keypoints, masks "
            f"{'equal' if torch.equal(mask, mc) else 'DIFFER'}, positions "
            f"equal {same:.4f}, max |response diff| "
            f"{float((resp - resp_c).abs().max()):.3g}, max |score diff| "
            f"{float((score - sc).abs().max()):.3g}, {ms:.3f} ms")
        if not (torch.equal(mask, mc) and same >= 0.99 and mask.sum() > 0):
            fail(f"V1: {det} keypoints differ between the card and the CPU")
    print(f"[V1 detectors] frame 0, {IMG_W}x{IMG_H}, "
          f"{vo.max_keypoints} keypoints, {note}; card vs CPU: "
          + "; ".join(parts) + " (device time a call, 5 calls queued) "
          + clocks(), flush=True)
    return thr


def orb_flann_phase(vo, images, thr, dev="cuda") -> None:
    """V2: orb_describe of frame 0's keypoints, card against CPU; FLANN
    against BF on the card on frames 0 and 1."""
    import dataclasses

    from vloam_tpu_torch.tools.timing import device_ms
    from vloam_tpu_torch.vision import features

    cfg = dataclasses.replace(vo, detector="orb", descriptor="orb",
                              fast_threshold=thr)
    imgs = [torch.from_numpy(images[k]).to(dev).float() / 255.0
            for k in (0, 1)]
    kps = [features.detect_keypoints(im, cfg) for im in imgs]
    descs = [features.orb_describe(im, kp[0]) for im, kp in zip(imgs, kps)]
    cpu = features.orb_describe(imgs[0].cpu(), kps[0][0].cpu())
    same = float((descs[0].cpu() == cpu).float().mean())
    m0 = kps[0][2].cpu()
    same_kp = float((descs[0].cpu() == cpu)[m0].float().mean())
    ms = device_ms(lambda: features.orb_describe(imgs[0], kps[0][0]))
    out = {}
    for matcher in ("flann", "bf"):
        out[matcher] = [a.cpu() for a in features.match_descriptors(
            descs[0], kps[0][2], descs[1], kps[1][2], cfg.match_ratio,
            matcher=matcher)]
    identical = all(torch.equal(a, b) for a, b in zip(out["flann"],
                                                      out["bf"]))
    print(f"[V2 ORB and FLANN] orb_describe of {descs[0].shape[0]} keypoint "
          f"rows ({int(m0.sum())} detected) x 256 bits: card vs CPU bits "
          f"equal {same:.6f} (detected rows {same_kp:.6f}); {ms:.4f} ms on "
          f"the card (cold L2, 20 calls queued); FLANN vs BF on the card "
          f"(frames 0 -> 1): idx and valid "
          f"{'identical' if identical else 'DIFFER'}, "
          f"{int(out['flann'][1].sum())} valid matches {clocks()}",
          flush=True)
    if not (same >= 0.999 and identical):
        fail("V2: ORB bits or FLANN matches disagree")


def option_engines_phase(cfg, frames, images, poses, calib, thr,
                         walls) -> None:
    """V3: VloamEngine over the first 16 frames with (a) ORB detector, ORB
    descriptors and FLANN, (b) the SIFT detector (ZNCC, BF); frames/s
    beside phase 8's default options."""
    import dataclasses

    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.vloam_step import VloamEngine, unpack_vloam_outputs

    for name, opts, k3 in (
            ("a: orb / orb / flann", dict(detector="orb", descriptor="orb",
                                          matcher="flann",
                                          fast_threshold=thr), 0),
            ("b: sift / zncc / bf", dict(detector="sift"), V_FRAMES)):
        cfg_o = cfg.replace(vo=dataclasses.replace(cfg.vo, **opts))
        eng = VloamEngine(cfg_o, calib, chunk=V_CHUNK, device="cuda")
        kernels.reset_launches()
        fps, host, syncs = _v_drive(
            lambda k: eng.push_polar(frames[k], images[k]))
        outs = eng.finish()
        launches = dict(kernels.LAUNCHES)
        if outs.shape != (V_FRAMES, 33) or not np.isfinite(outs).all():
            fail(f"V3 {name}: outputs {outs.shape} not finite")
        err = vloam_errors(unpack_vloam_outputs(outs, calib),
                           poses[:V_FRAMES], calib)
        print(f"[V3 VloamEngine {name}] {V_FRAMES} frames: {fps:.2f} "
              f"frames/s over frames {2 * V_CHUNK}-{V_FRAMES - 1} at chunk "
              f"{V_CHUNK} (host enqueue {host:.2f} ms/frame; phase 8's "
              f"default options {1e3 / walls['VloamEngine']:.2f} frames/s at "
              f"chunk {CHUNK}); hand-kernel launches {launches}; "
              f"max err vs GT LO {err['LO']:.4f} m, MO {err['MO']:.4f} m; VO "
              f"ATE {err['VO']:.4f} m; min n32 {err['n32']}; host syncs "
              f"{len(syncs)} {clocks()}", flush=True)
        want = lidar_launches(V_FRAMES, zncc_describe=k3)
        if launches != want:
            fail(f"V3 {name}: launches {launches}, want {want}")
        if syncs:
            fail(f"V3 {name}: the frame loop synchronized: {syncs[:3]}")
        if not err["MO"] < 0.15:
            fail(f"V3 {name}: MO error {err['MO']} m >= 0.15 m")


def batched_selection_phase(cfg, frames, poses, walls) -> None:
    """V4: LoamEngine with strict_sector_order=False over the first 16
    frames, frames/s beside phase 5's strict engine, card against the CPU
    over the first CPU_FRAMES; labels that differ from the strict selection
    on each frame."""
    import dataclasses

    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.data.synthetic import hdl64_elevations
    from vloam_tpu_torch.lidar import scan_registration as sr
    from vloam_tpu_torch.lidar.loam_step import LoamEngine, unpack_outputs

    cfg_b = cfg.replace(scanreg=dataclasses.replace(
        cfg.scanreg, strict_sector_order=False))
    elev = torch.tensor(np.radians(hdl64_elevations(64)),
                        dtype=torch.float32, device="cuda")
    dirs = sr.polar_directions(elev, N_AZ)
    moved, total = [], []
    for img in frames[:V_FRAMES]:
        r = torch.from_numpy(img.astype(np.int32)).cuda()
        pts, _, counts = sr.polar_layout(r, dirs, cfg.lidar)
        curv = sr._curvature(pts)
        bf = sr._break_prefix(pts, cfg.scanreg.neighbor_suppress_gap_sq)
        strict = sr.select_rings(curv, bf, counts, cfg.scanreg)
        batched = sr.select_rings_batched(curv, bf, counts, cfg_b.scanreg)
        moved.append(int((strict != batched).sum()))
        total.append(int((strict != 0).sum()))

    eng = LoamEngine(cfg_b, chunk=V_CHUNK, device="cuda")
    kernels.reset_launches()
    fps, host, syncs = _v_drive(lambda k: eng.push_polar(frames[k]))
    outs = eng.finish()
    launches = dict(kernels.LAUNCHES)
    res = unpack_outputs(outs)
    gt = np.stack([T[:3, 3] for T in poses[:V_FRAMES]])
    err = float(np.linalg.norm(res["t_w_mo"] - gt, axis=1).max())
    ceng = LoamEngine(cfg_b, chunk=CPU_FRAMES, device="cpu")
    for k in range(CPU_FRAMES):
        ceng.push_polar(frames[k])
    rc = unpack_outputs(ceng.finish())
    lo = float(np.abs(rc["t_w_lo"] - res["t_w_lo"][:CPU_FRAMES]).max())
    mo = float(np.abs(rc["t_w_mo"] - res["t_w_mo"][:CPU_FRAMES]).max())
    print(f"[V4 batched sector selection] LoamEngine strict_sector_order="
          f"False, {V_FRAMES} frames: {fps:.2f} frames/s over frames "
          f"{2 * V_CHUNK}-{V_FRAMES - 1} at chunk {V_CHUNK} (host enqueue "
          f"{host:.2f} ms/frame; phase 5's strict engine "
          f"{1e3 / walls['LoamEngine']:.2f} frames/s at chunk {CHUNK}); "
          f"hand-kernel launches {launches}; labels that differ "
          f"from the strict selection per frame {moved} of {total}; MO max "
          f"err vs GT {err:.4f} m; card vs CPU over the first {CPU_FRAMES} "
          f"frames: max |t_w_lo| diff {lo:.2e} m, |t_w_mo| {mo:.2e} m; host "
          f"syncs {len(syncs)} {clocks()}", flush=True)
    want = lidar_launches(V_FRAMES, select_rings=0)
    if launches != want:
        fail(f"V4: launches {launches}, want {want}")
    if syncs:
        fail(f"V4: the frame loop synchronized: {syncs[:3]}")
    if outs.shape != (V_FRAMES, 24) or not np.isfinite(outs).all():
        fail(f"V4: outputs {outs.shape} not finite")
    if not (err < 0.15 and lo < 2e-2 and mo < 3e-2):
        fail("V4: MO error or card vs CPU out of bounds")


def v5_scene():
    """2048 normalized correspondences of a rigid motion (rotation vector
    (0.02, -0.04, 0.01), direction of (0.2, -0.1, 1)), the first 30%
    replaced by uniform outliers: (x0, x1, valid, R, t_unit) as float32
    tensors and float64 numpy truth (tests/test_torch_ransac_se3_factors.py
    holds the reference to it)."""
    from vloam_tpu_torch.geometry import so3

    rng = np.random.default_rng(5)
    X0 = rng.uniform([-10.0, -4.0, 4.0], [10.0, 4.0, 50.0], (V5_POINTS, 3))
    R = so3.axis_angle_to_matrix(torch.tensor(
        [0.02, -0.04, 0.01], dtype=torch.float64)).numpy()
    t = np.array([0.2, -0.1, 1.0])
    X1 = X0 @ R.T + t
    x0 = (X0[:, :2] / X0[:, 2:3]).astype(np.float32)
    x1 = (X1[:, :2] / X1[:, 2:3]).astype(np.float32)
    x1[:V5_OUTLIERS] = rng.uniform(-0.5, 0.5, (V5_OUTLIERS, 2))
    return (torch.from_numpy(x0), torch.from_numpy(x1),
            torch.ones(V5_POINTS, dtype=torch.bool), R,
            t / np.linalg.norm(t))


def ransac_phase(dev="cuda") -> None:
    """V5: essential_ransac_from_samples on the card and on the CPU with one
    set of minimal samples drawn from a seeded CPU torch.Generator."""
    from vloam_tpu_torch.geometry import so3
    from vloam_tpu_torch.vision import ransac

    x0, x1, valid, R, t = v5_scene()
    idx = torch.multinomial(valid.float() / V5_POINTS, V5_HYP * 8,
                            replacement=True,
                            generator=torch.Generator().manual_seed(5))
    idx = idx.reshape(V5_HYP, 8)
    args = [a.to(dev) for a in (idx, x0, x1, valid)]
    out = [a.cpu() for a in ransac.essential_ransac_from_samples(*args)]
    cpu = ransac.essential_ransac_from_samples(idx, x0, x1, valid)
    for _ in range(2):
        ransac.essential_ransac_from_samples(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        ransac.essential_ransac_from_samples(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e2
    errs = []
    for q, tt, _, _ in (out, cpu):
        Rq = so3.quat_to_matrix(q.double()).numpy()
        cos = np.clip((np.trace(Rq.T @ R) - 1.0) / 2.0, -1.0, 1.0)
        errs.append((float(np.arccos(cos)),
                     float(np.abs(tt.double().numpy() - t).max())))
    same = torch.equal(out[2], cpu[2]) and int(out[3]) == int(cpu[3])
    print(f"[V5 RANSAC] {V5_POINTS} correspondences, {V5_OUTLIERS} "
          f"outliers, {V5_HYP} hypotheses: inliers card {int(out[3])}, CPU "
          f"{int(cpu[3])}, masks {'identical' if same else 'DIFFER'}; R / t "
          f"error vs truth card {errs[0][0]:.2e} rad / {errs[0][1]:.2e}, CPU "
          f"{errs[1][0]:.2e} rad / {errs[1][1]:.2e}; {ms:.3f} ms a call on "
          f"the card (host clock over 10 calls between synchronizes: its "
          f"SVDs wait for the device) {clocks()}", flush=True)
    if not (same and all(r < 1e-3 and d < 1e-3 for r, d in errs)):
        fail("V5: RANSAC on the card disagrees with the CPU or the truth")


def _popen_cli(*args) -> subprocess.Popen:
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, "-m", "vloam_tpu_torch", *args],
                            cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


CLI_FRAMES = "4"  # 15d's and M5's --synthetic: --viz writes at frame 1


def host_cli_viz_phase() -> None:
    """15d: python -m vloam_tpu_torch run --synthetic 4 --mode combined
    --engine host --viz DIR with no --device, and the same with
    --optical-flow, as two subprocesses side by side: the debug PNGs, the
    timing summary and the kernel launches each prints."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        t0 = time.perf_counter()
        for name, extra in (("descriptors", []), ("flow", ["--optical-flow"])):
            viz = Path(tmp) / name
            runs[name] = (viz, _popen_cli(
                "run", "--synthetic", CLI_FRAMES, "--mode", "combined",
                "--engine", "host", "--viz", str(viz), *extra))
        results = {}
        try:
            for name, (viz, proc) in runs.items():
                out, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    fail(f"--engine host --viz ({name}) exited "
                         f"{proc.returncode}: {err[-3000:]}")
                results[name] = (sorted(p.name for p in viz.glob("*.png")),
                                 out)
        finally:
            for _, proc in runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        dt = time.perf_counter() - t0
    lines = []
    for name, (pngs, out) in results.items():
        got = [ln for ln in out.splitlines()
               if ln.startswith(("kernel launches", "throughput", "MO "))]
        launch = [json.loads(ln.split(": ", 1)[1]) for ln in got
                  if ln.startswith("kernel launches")]
        launch = launch[0] if launch else {}
        has_summary = "timing summary (ms):" in out
        lines.append(f"{name}: PNGs {pngs}; timing summary "
                     + ("printed" if has_summary else "MISSING")
                     + f"; {got}")
        want = {"depth", "flow" if name == "flow" else "matches"}
        if {p.split("_")[0] for p in pngs} != want:
            fail(f"--viz ({name}) wrote {pngs}, want {sorted(want)} PNGs")
        path = ["select_rings", "ring_min1_packed", "grid_probe",
                "row_gather"] + (["zncc_describe"] if name != "flow" else [])
        if not has_summary or not all(launch.get(k, 0) > 0 for k in path):
            fail(f"--engine host ({name}) printed no timing summary or "
                 f"launched no kernel of its path: {launch}")
    print(f"[15d host engine CLI --viz] two subprocesses with no --device, "
          f"{dt:.1f} s side by side: " + "; ".join(lines), flush=True)


# ------------------------------------------------------------------ the mesh

MESH_WINDOW = 4096  # window rows a rank, LoamEngine's default
MESH_FRAMES = 16  # M3 and M4 drive the first 16 frames
# the single-device paths against the mesh's: LO never touches the mesh;
# MO within 1 cm, as tests/test_mesh_fused.py holds the reference's mesh
MESH_TOL = {"LO": 1e-5, "MO": 1e-2}


def mesh_launches(n: int, **more) -> dict:
    """Launches of n frames of a mesh engine: scan registration and LO as
    the single engine's; the mesh mapping chunk probes no grid (grid_probe
    0), gathers rows twice for the windows and twice for the inserts, and
    sweeps each window once in each of its 2 rounds (masked_knn)."""
    return lidar_launches(n, grid_probe=0, row_gather=4 * n,
                          masked_knn=4 * n, **more)


def _mo_gaps(rows, ref_rows) -> np.ndarray:
    """The MO position difference frame by frame between two packed row
    sets."""
    return np.linalg.norm(rows[:, 18:21] - ref_rows[:len(rows), 18:21],
                          axis=1)


def _mesh_diffs(rows, ref_rows) -> tuple[float, float]:
    """The largest LO row difference (f2f and world pose columns) and the
    largest MO position difference between two packed row sets."""
    lo = float(np.abs(rows[:, :14] - ref_rows[:len(rows), :14]).max())
    return lo, float(_mo_gaps(rows, ref_rows).max())


def mesh_engine_phase(cfg, frames, poses, outs5, mesh):
    """M2: LoamEngine(kitti_hdl64(), chunk=16, mesh=<one NCCL rank>,
    mesh_window_rows=4096) over phase 5's drive."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar.loam_step import LoamEngine, unpack_outputs

    eng = LoamEngine(cfg, chunk=CHUNK, mesh=mesh,
                     mesh_window_rows=MESH_WINDOW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for k in range(CHUNK):
        eng.push_polar(frames[k])
    torch.cuda.synchronize()
    knn0 = kernels.LAUNCHES["masked_knn"]
    t0 = time.perf_counter()
    host, syncs = _sync_free(lambda k: eng.push_polar(frames[k]),
                             range(CHUNK, N_FRAMES))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    knn_timed = kernels.LAUNCHES["masked_knn"] - knn0
    clk = clocks()
    outs = eng.finish()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    if outs.shape != (N_FRAMES, 24) or not np.isfinite(outs).all():
        fail(f"mesh outputs {outs.shape} not finite")
    res = unpack_outputs(outs)
    gt = np.stack([T[:3, 3] for T in poses])
    err = float(np.linalg.norm(res["t_w_mo"] - gt, axis=1).max())
    lo, mo = _mesh_diffs(outs, outs5)
    active, cap = eng.window_active_rows
    # launches a frame as phase 13 counts them: a chunk of PROFILE_FRAMES
    # after as many warm frames (the timed drive's chunk is 16 frames)
    cnt_eng = LoamEngine(cfg, chunk=PROFILE_FRAMES, mesh=mesh,
                         mesh_window_rows=MESH_WINDOW)
    for k in range(PROFILE_FRAMES):
        cnt_eng.push_polar(frames[k])
    per_frame = _host_launches(lambda: [
        cnt_eng.push_polar(frames[k])
        for k in range(PROFILE_FRAMES, 2 * PROFILE_FRAMES)]) / PROFILE_FRAMES
    cnt_eng.finish()
    n = N_FRAMES - CHUNK
    print(f"[M2 mesh end to end] LoamEngine(kitti_hdl64, chunk {CHUNK}, mesh "
          f"of {mesh.size} {mesh.backend} rank on {mesh.device}, "
          f"mesh_window_rows {MESH_WINDOW}) over phase 5's {N_FRAMES} frames: "
          f"{n / dt:.2f} frames/s over frames {CHUNK}-{N_FRAMES - 1} "
          f"({dt * 1e3 / n:.2f} ms/frame, host enqueue "
          f"{host * 1e3 / n:.2f} ms/frame); launches {launches}; masked_knn "
          f"{knn_timed / n:.2f} a frame in the timed frames; "
          f"{per_frame:.0f} kernel launches a frame (counted on the host over "
          f"frames {PROFILE_FRAMES}-{2 * PROFILE_FRAMES - 1} at chunk "
          f"{PROFILE_FRAMES}); peak active map rows {active} of the "
          f"window's {cap}; against phase 5: LO rows max |diff| {lo:.3g}, MO "
          f"max diff {mo:.4f} m (frame by frame, mm: "
          f"{' '.join(f'{g * 1e3:.2f}' for g in _mo_gaps(outs, outs5))}); "
          f"MO max err vs GT {err:.4f} m; peak device "
          f"memory {peak:.0f} MiB; host syncs in the timed frames "
          f"{len(syncs)} {clk}", flush=True)
    want = mesh_launches(N_FRAMES)
    if launches != want:
        fail(f"mesh kernel launch counts {launches}, want {want}")
    if knn_timed != 4 * n:
        fail(f"masked_knn launched {knn_timed} times in {n} timed frames, "
             f"want {4 * n}")
    if syncs:
        fail(f"the mesh frame loop synchronized with the device: {syncs[:3]}")
    if not (lo <= MESH_TOL["LO"] and mo < MESH_TOL["MO"]):
        fail(f"the mesh engine left phase 5's rows: LO {lo}, MO {mo} m")
    if not err < 0.15:
        fail(f"mesh MO error {err} m >= 0.15 m")
    if not 0 < active <= cap:
        fail(f"peak active map rows {active} outside the window {cap}")
    return outs, eng, launches


def mesh_knn_phase(cfg, eng, frame, mo_row, per_pair) -> dict:
    """M1: the windows of M2's final map at the last frame's MO position
    (_window_block: 4096 rows of 96 / 48 floats gathered from [2^17, W] by
    row_gather) against the plain gather on the CPU, bit for bit; then
    masked_knn (kernels/csrc/knn.cu) at the mesh engine's shapes, the last
    frame's stacks against those windows: 2048 corner queries x 4096*32
    slots, 6144 surf x 4096*16. Kernel against masked_knn_plain on the card:
    indices and distance bits identical; against the CPU: indices
    identical; device time a call beside the first design's
    (MASKED_KNN_BEFORE_US) and the plain version's, launches a call, the
    bound and the issue floor at per_pair (phase 2) instructions a pair over
    every slot and over the live pairs. Returns the kernels line's row at
    the corner window, its bound over the live pairs."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.data.synthetic import hdl64_elevations
    from vloam_tpu_torch.geometry import so3
    from vloam_tpu_torch.lidar.knn import masked_knn, masked_knn_plain
    from vloam_tpu_torch.lidar.scan_registration import (polar_directions,
                                                         register_scan_polar)
    from vloam_tpu_torch.lidar.voxel import voxel_downsample
    from vloam_tpu_torch.parallel.mesh_fused import _window_block
    from vloam_tpu_torch.tools.timing import (device_ms, knn_bound,
                                              knn_issue_floor)

    m = cfg.mapping
    elev = torch.tensor(np.radians(hdl64_elevations(64)),
                        dtype=torch.float32, device="cuda")
    feats = register_scan_polar(
        torch.from_numpy(frame.astype(np.int32)).cuda(),
        polar_directions(elev, N_AZ), cfg.lidar, cfg.scanreg)
    q = torch.tensor(mo_row[14:18], device="cuda")
    t = torch.tensor(mo_row[18:21], device="cuda")
    cube = eng.state[1].cube
    lines, row = [], None
    for name, cloud, res, cap_q, grid in (
            ("corner", feats.less_sharp, m.line_resolution,
             m.corner_stack_cap, cube.corner),
            ("surf", feats.less_flat, m.plane_resolution, m.surf_stack_cap,
             cube.surf)):
        xyz, _, _, _ = voxel_downsample(cloud.xyz, cloud.mask, res, cap_q)
        qw = so3.quat_rotate(q, xyz) + t
        pts, mask, n_act = _window_block(grid.pts, t, MESH_WINDOW)
        # the window's row_gather launches against the plain gather (the
        # wrapper takes it for CPU tensors): bit for bit
        pts_c, mask_c, n_act_c = _window_block(grid.pts.cpu(), t.cpu(),
                                               MESH_WINDOW)
        win_same = (torch.equal(pts.cpu(), pts_c)
                    and torch.equal(mask.cpu(), mask_c)
                    and int(n_act) == int(n_act_c))
        Q, C = qw.shape[0], pts.shape[0]
        n0 = kernels.LAUNCHES["masked_knn"]
        d, i = masked_knn(qw, pts, mask)
        counted = kernels.LAUNCHES["masked_knn"] - n0
        d_p, i_p = masked_knn_plain(qw, pts, mask)
        same_plain = (torch.equal(i, i_p) and torch.equal(
            d.view(torch.int32), d_p.view(torch.int32)))
        err = float((d - d_p).abs().nan_to_num(0.0).max())
        d_c, i_c = masked_knn_plain(qw.cpu(), pts.cpu(), mask.cpu())
        same = torch.equal(i.cpu(), i_c)
        fin = torch.isfinite(d_c)
        diff = float((d.cpu() - d_c)[fin].abs().max()) if fin.any() else 0.0
        live = int(mask.sum())
        ms = device_ms(lambda: masked_knn(qw, pts, mask), runs=20,
                       cold=False)
        first_us = MASKED_KNN_BEFORE_US[name]
        plain_ms = device_ms(lambda: masked_knn_plain(qw, pts, mask), runs=5,
                             cold=False)
        launches = _host_launches(lambda: masked_knn(qw, pts, mask))
        plain_launches = _host_launches(
            lambda: masked_knn_plain(qw, pts, mask))
        bound = knn_bound(Q, C, 5)
        bound_live = knn_bound(Q, C, 5, live=live)
        floor = knn_issue_floor(Q, C, per_pair[5])
        floor_live = knn_issue_floor(Q, C, per_pair[5], live=live)
        lines.append(
            f"{name} window {MESH_WINDOW} x {grid.pts.shape[1]} of "
            f"[{grid.pts.shape[0]}, {grid.pts.shape[1]}] ({int(n_act)} "
            "active rows): points, mask and active rows "
            + ("bit-identical" if win_same else "DIFFER")
            + f" card vs CPU gather; {Q} x {C} ({live} live): "
            "kernel vs masked_knn_plain on the card: indices and distance "
            "bits " + ("identical" if same_plain else "DIFFER")
            + f" (max |d_sq| diff {err:.3g}); indices "
            + ("identical" if same else "DIFFER")
            + f" card vs CPU, max |d_sq| diff {diff:.3g} m^2; kernel "
            f"{ms * 1e3:.1f} us a call [first design {first_us} us, "
            f"{first_us / (ms * 1e3):.2f}x] ({counted} count, {launches} "
            f"device launches), plain version {plain_ms:.3f} ms ({plain_launches} "
            f"launches); bound {bound[0] * 1e3:.1f} us ({bound[1]}) over "
            f"every slot, {bound_live[0] * 1e3:.1f} us ({bound_live[1]}) "
            f"over the live pairs; issue floor {floor * 1e3:.1f} / "
            f"{floor_live * 1e3:.1f} us at {per_pair[5]:.2f} instructions a "
            f"pair: kernel {ms / floor:.2f}x / {ms / floor_live:.2f}x the "
            "floor")
        if not win_same:
            fail(f"_window_block {name}: the card's window differs from the "
                 "plain gather's")
        if not same_plain:
            fail(f"masked_knn {name}: the kernel differs from the plain "
                 "version on the card")
        if not same:
            fail(f"masked_knn {name}: card and CPU indices differ")
        if counted != 1:
            fail(f"masked_knn {name}: counted {counted} launches for a call")
        if row is None:
            row = kernel_row("masked_knn", "knn.cu",
                             "vloam_tpu/lidar/knn.py:47", err, ms, plain_ms,
                             bound_live)
    print(f"[M1 masked_knn] 2 calls a grid a frame at one rank (2 rounds; "
          f"x D shards at D ranks): " + "; ".join(lines) + f" {clocks()}",
          flush=True)
    return row


def mesh_rank_main(backend: str, inp: str, out: str) -> None:
    """One rank of M3 (run as `chip_smoke.py mesh-rank BACKEND IN OUT` by
    parallel.launch): LoamEngine(kitti_hdl64, mesh) over the frames in IN,
    the second half of them recorded for host syncs; rank 0 writes the rows
    to OUT."""
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.lidar.loam_step import LoamEngine
    from vloam_tpu_torch.parallel.sharded import spmd_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = np.load(inp)
    frames = [data[f"f{k}"] for k in range(len(data.files))]
    half = len(frames) // 2
    with spmd_mesh(device="cuda", backend=backend) as mesh:
        eng = LoamEngine(kitti_hdl64(), chunk=half, mesh=mesh,
                         mesh_window_rows=MESH_WINDOW)
        for k in range(half):
            eng.push_polar(frames[k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, syncs = _sync_free(lambda k: eng.push_polar(frames[k]),
                              range(half, len(frames)))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows = eng.finish()
        if mesh.rank == 0:
            np.savez(out, rows=rows, syncs=len(syncs), fps=half / dt,
                     window=np.asarray(eng.window_active_rows),
                     device=str(mesh.device))


def mesh_ranks_phase(frames, outs_m2) -> None:
    """M3: the first 16 frames at 2 ranks sharing the card under gloo (the
    hop through host memory), against M2's rows; with 2 or more cards also
    min(4, cards) NCCL ranks, one a card."""
    import tempfile

    from vloam_tpu_torch.parallel.launch import launch

    runs = [("gloo", 2)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", min(4, torch.cuda.device_count())))
    script = os.path.abspath(__file__)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "frames.npz")
        np.savez(inp, **{f"f{k}": f
                         for k, f in enumerate(frames[:MESH_FRAMES])})
        for backend, n in runs:
            out = os.path.join(tmp, f"{backend}.npz")
            t0 = time.perf_counter()
            run = launch([script, "mesh-rank", backend, inp, out], n,
                         timeout=600)
            wall = time.perf_counter() - t0
            if run.code != 0:
                fail(f"{n} {backend} ranks exited {run.code}\n{run.report()}")
            got = np.load(out)
            lo, mo = _mesh_diffs(got["rows"], outs_m2)
            active, cap = got["window"]
            where = ("sharing " + str(got["device"]) if backend == "gloo"
                     else "one a card")
            half = MESH_FRAMES // 2
            lines.append(
                f"{n} {backend} ranks ({where}): {float(got['fps']):.2f} "
                f"frames/s over frames {half}-{MESH_FRAMES - 1} on rank 0, "
                f"{int(got['syncs']) / half:.2f} host syncs a frame there "
                f"(not gated), peak "
                f"active rows {active} of {cap}; against M2 LO max |diff| "
                f"{lo:.3g}, MO max diff {mo:.4f} m; {wall:.1f} s with start-up")
            if not (np.isfinite(got["rows"]).all()
                    and got["rows"].shape == (MESH_FRAMES, 24)):
                fail(f"{backend} ranks' rows {got['rows'].shape} not finite")
            if not mo < MESH_TOL["MO"]:
                fail(f"{n} {backend} ranks left M2's MO by {mo} m")
    print("[M3 mesh ranks] LoamEngine(kitti_hdl64, mesh) over the first "
          f"{MESH_FRAMES} frames: " + "; ".join(lines) + f" {clocks()}",
          flush=True)


def mesh_vloam_phase(cfg_v, frames, images, calib, res_v, mesh) -> None:
    """M4: VloamEngine(kitti_hdl64 detach_VO_LO=False, chunk=16, mesh=<one
    NCCL rank>) over the first 16 frames against phase 8's rows."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.vloam_step import VloamEngine, unpack_vloam_outputs

    eng = VloamEngine(cfg_v, calib, chunk=MESH_FRAMES, mesh=mesh,
                      mesh_window_rows=MESH_WINDOW)
    torch.cuda.synchronize()
    kernels.reset_launches()
    eng.push_polar(frames[0], images[0])  # uploads the ray geometry once
    t0 = time.perf_counter()
    _, syncs = _sync_free(lambda k: eng.push_polar(frames[k], images[k]),
                          range(1, MESH_FRAMES))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    outs = eng.finish()
    launches = dict(kernels.LAUNCHES)
    res = unpack_vloam_outputs(outs, calib)
    n = MESH_FRAMES
    lo = float(np.abs(res["t_w_lo"] - res_v["t_w_lo"][:n]).max())
    vo = float(np.abs(res["t_vo"] - res_v["t_vo"][:n]).max())
    mo = float(np.linalg.norm(res["t_w_mo"] - res_v["t_w_mo"][:n],
                              axis=1).max())
    active, cap = eng.window_active_rows
    print(f"[M4 mesh combined] VloamEngine(kitti_hdl64 detach_VO_LO=False, "
          f"chunk {n}, mesh of {mesh.size} {mesh.backend} rank) over frames "
          f"0-{n - 1}: {(n - 1) / dt:.2f} frames/s (frames 1-{n - 1}, one "
          f"chunk); launches {launches}; against phase 8: VO max |diff| "
          f"{vo:.3g} m, LO {lo:.3g} m, MO {mo:.4f} m; peak active rows "
          f"{active} of {cap}; host syncs in frames 1-{n - 1} {len(syncs)} "
          f"{clocks()}", flush=True)
    want = mesh_launches(n, zncc_describe=n)
    if launches != want:
        fail(f"mesh combined launch counts {launches}, want {want}")
    if syncs:
        fail(f"the mesh combined engine synchronized: {syncs[:3]}")
    if not (vo <= MESH_TOL["LO"] and lo <= MESH_TOL["LO"]
            and mo < MESH_TOL["MO"]):
        fail(f"the mesh combined engine left phase 8's rows: VO {vo}, LO "
             f"{lo}, MO {mo} m")
    if not 0 < active <= cap:
        fail(f"peak active map rows {active} outside the window {cap}")


def mesh_loop_phase(cfg, frames, res_host, card_14d, mesh) -> None:
    """M5: close_loops(mesh=<one NCCL rank>) on 14b's trajectory against
    14d's, then `python -m vloam_tpu_torch run --synthetic 4 --mesh 1` with
    no --device."""
    from vloam_tpu_torch.backend.loop_closure import close_loops
    from vloam_tpu_torch.data.synthetic import pad_scan

    q, t = res_host["raw"]["q_w_mo"], res_host["raw"]["t_w_mo"]
    scans = [pad_scan(_xyz(f), cfg.lidar.max_points) for f in frames]
    got = close_loops(q, t, scans.__getitem__, cfg, radius=50.0, min_gap=8,
                      mesh=mesh)
    dp = float(np.abs(got["poses"][:, 4:] - card_14d["poses"][:, 4:]).max())
    t0 = time.perf_counter()
    out = _cli("run", "--synthetic", CLI_FRAMES, "--mesh", "1")
    dt = time.perf_counter() - t0
    said = [ln for ln in out.splitlines() if ln.startswith(
        ("mesh mapping", "throughput", "MO "))]
    mo = [json.loads(ln[3:]) for ln in said if ln.startswith("MO ")]
    print(f"[M5 mesh loop closure and command line] close_loops(mesh=one "
          f"rank) on 14b's MO: loops {got['loops']}, max diff from 14d's "
          f"{dp:.3g} m; `run --synthetic {CLI_FRAMES} --mesh 1` (no "
          f"--device) in "
          f"{dt:.1f} s: {' | '.join(said)}", flush=True)
    if got["loops"] != card_14d["loops"] or not dp < 1e-3:
        fail(f"close_loops with a mesh left 14d's: {got['loops']}, {dp} m")
    if len(mo) != 1 or not np.isfinite(mo[0]["ate_rmse_m"]) or not any(
            ln.startswith("mesh mapping") for ln in said):
        fail(f"the --mesh 1 command line printed {said}")


# ----------------------------------------------------------- the evaluations

E1_FRAMES = 100  # scripts/eval_synthetic.py's drive
E2_FRAMES = 500  # scripts/eval_long.py's
# ---- PR 18's phases: the last scripts' tools on the card ----

PRERENDER_WORKERS = 6  # leave cores to the phases running beside it
UPLOAD_CHUNK, UPLOAD_CHUNKS = 16, 1  # phase U: one turn of 1 timed chunk
DV_PAIRS = 4  # phase DV: the first 4 pairs of the 100-frame drive


def prerender_main() -> None:
    """Make the frames of the later phases (U, DV, L2, MS, E1, E2, B's
    batch streams) into the temporary directory's cache, in
    PRERENDER_WORKERS processes: run as `chip_smoke.py prerender` beside the
    kernel phases, so that their host rendering (~90 s of E1 and E2 alone)
    overlaps the card's work."""
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.tools import (bench, eval_frames, model_mesh_scaling,
                                       profile_upload_overlap, stages)

    cfg = kitti_hdl64()
    w = PRERENDER_WORKERS
    t0 = time.perf_counter()
    eval_frames.synthetic_drive(E1_FRAMES, cfg, with_cam=True, workers=w,
                                first=DV_PAIRS + 1)
    profile_upload_overlap.drive(UPLOAD_CHUNK * (UPLOAD_CHUNKS + 1), 64,
                                 N_AZ, w)
    stages.xyz_frames(synthetic.drive_trajectory(2, speed=1.1,
                                                 yaw_rate=0.01),
                      range(2), 64, N_AZ, cfg.lidar.max_points)
    model_mesh_scaling.drive(64, N_AZ, w)
    eval_frames.synthetic_drive(E1_FRAMES, cfg, workers=w)
    eval_frames.long_drive(E2_FRAMES, workers=w)
    for pack in (False, True):
        bench.batch_drives(BATCH, BATCH_CHUNK + BENCH_BATCH_WINDOW
                           * BENCH_WINDOWS, cfg.lidar.n_scans, N_AZ, pack, w)
    print(f"[prerender] the frames of phases U, DV, L2, MS, E1, E2 and B in "
          f"{time.perf_counter() - t0:.1f} s ({w} processes beside the "
          "phases)", flush=True)


def start_prerender() -> subprocess.Popen:
    """prerender_main in its own process group (stop_prerender ends it and
    its workers)."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "prerender"], start_new_session=True)


def stop_prerender(proc: subprocess.Popen, wait: bool) -> None:
    """Wait for the prerender (wait) or end it; either way no process of
    its group is left."""
    import signal

    if wait:
        t0 = time.perf_counter()
        code = proc.wait()
        print(f"[prerender] waited {time.perf_counter() - t0:.1f} s for it",
              flush=True)
        if code:
            fail(f"the prerender process exited {code}")
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def upload_phase() -> None:
    """U: tools/profile_upload_overlap's four stagings of the polar chunk
    (A one upload a chunk, B one a frame, C and D the same with pack12),
    one turn of 1 timed chunk of 16 after a warm chunk: rows identical
    across the modes; frames/s, host enqueue and the copies' device ms."""
    from vloam_tpu_torch.tools import profile_upload_overlap as upo

    t0 = time.perf_counter()
    rec = upo.run("cuda", chunk=UPLOAD_CHUNK, n_chunks=UPLOAD_CHUNKS,
                  turns=1)
    print(f"[U upload overlap] kitti_hdl64 64x{N_AZ} at 3 cm, chunk "
          f"{UPLOAD_CHUNK}, {UPLOAD_CHUNKS} timed chunks a mode: " + "; ".join(
              f"{m['mode']} {m['fps']:.2f} frames/s, host enqueue "
              f"{m['host_ms']:.2f} ms a frame, copies {m['copy_ms']:.4f} ms "
              "a frame on the device" for m in rec["modes"])
          + f"; rows identical across the modes: {rec['rows_equal']} "
          f"(in {time.perf_counter() - t0:.1f} s) {clocks()}", flush=True)
    if not rec["rows_equal"]:
        fail("U: an upload mode's rows differ from mode A's")


def mesh_model_phase() -> None:
    """MS: tools/model_mesh_scaling at D = 1 (one NCCL rank): the mesh
    chunk's frame by stages, their kernel launches summed against the
    one-frame chunk's, the stages in order bit for bit with it; the model's
    rows."""
    from vloam_tpu_torch.tools import model_mesh_scaling as mms

    t0 = time.perf_counter()
    rec = mms.run("cuda", runs=1, replays=5)
    s, chk = rec["stage_ms"], rec["split_sum"]
    print(f"[MS mesh model] D = 1 chunk {s['mesh_d1']:.3f} ms a frame "
          f"({rec['stage_clock']}), one frame by stages: windows "
          f"{s['window']:.3f}, setup {s['setup']:.3f}, masked_knn sweeps "
          f"{s['knn']:.3f}, LM chains {s['lm']:.3f}, inserts + evicts "
          f"{s['insert']:.3f}, tail {s['tail']:.3f} (one-frame chunk "
          f"{s['chunk_1_frame']:.3f}); single engine's mapping stage "
          f"{s['single']:.3f} ms; launches summed {chk['sum']} against the "
          f"chunk's {chk['whole']} ({chk['how']}); stages bit for bit with "
          f"the chunk: {rec['split_identical']}; the model (link assumed: "
          f"{rec['link']['gbps']} GB/s, {rec['link']['hop_latency_us']} us "
          "a hop): " + "; ".join(
              f"D={r['D']} {r['t_ms']:.3f} ms, eff {r['efficiency']:.3f}"
              for r in rec["rows"]) + f" (in {time.perf_counter() - t0:.1f} "
          f"s) {clocks()}", flush=True)
    if not (chk["ok"] and rec["split_identical"]):
        fail(f"MS: the mesh chunk's stages do not compose it: {chk}")


def bench_mesh_phase() -> None:
    """MB: tools/bench_mesh on the card, D = 1 under NCCL in this process
    and D = 2 gloo ranks sharing the card: each pose within M2's 0.01 m of
    the single-device solve."""
    from vloam_tpu_torch.tools import bench_mesh

    t0 = time.perf_counter()
    rec = bench_mesh.run("cuda", sizes=(1, 2), reps=3)
    print("[MB bench_mesh] scripts/bench_mesh.py's frame: " + "; ".join(
        f"D={r['D']} ({r['how']}) |t - t_single| {r['t_err_mm']:.3f} mm, "
        f"accepted by rank {r['accepted']}, {r['solve_ms']:.1f} ms a solve"
        for r in rec["rows"]) + f" (in {time.perf_counter() - t0:.1f} s)",
          flush=True)
    bad = [r for r in rec["rows"] if not r["t_err_mm"] < MESH_TOL["MO"] * 1e3]
    if bad or [r["D"] for r in rec["rows"]] != [1, 2]:
        fail(f"MB: a mesh solve left the single-device pose by 0.01 m or "
             f"more: {bad}")


def diag_vo_phase() -> None:
    """DV: tools/diag_vo's main entry, base variant, over the first 4 pairs
    of the 100-frame drive on the card and on the CPU."""
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.tools import diag_vo

    t0 = time.perf_counter()
    cfg = kitti_hdl64()
    vo = cfg.replace(detach_VO_LO=False).vo
    recs = {}
    for dev in ("cuda", "cpu"):
        drive = diag_vo.load_drive(DV_PAIRS, cfg, dev)
        recs[dev] = [diag_vo.pair_stats(drive, k, vo, quality=True)
                     for k in range(DV_PAIRS)]

    def text(r):
        return (f"valid {r['valid']}, n32 {r['n32']}, n22 {r['n22']}, reproj "
                f"med {r['reproj_med']:.2f} px, <2 px {r['inlier2']:.2f}, rot "
                f"{r['rot_mrad']:.2f} mrad, trans {r['trans_mm']:.1f} mm")

    print(f"[DV diag_vo] main, base, {DV_PAIRS} pairs of the 100-frame drive,"
          " card | CPU: " + "; ".join(
              f"pair {k}: {text(a)} | {text(b)}"
              for k, (a, b) in enumerate(zip(recs["cuda"], recs["cpu"])))
          + f" (in {time.perf_counter() - t0:.1f} s)", flush=True)
    for r in recs["cuda"]:
        if not (r["n32"] > 0 and np.isfinite(r["trans_mm"])
                and np.isfinite(r["rot_mrad"])):
            fail(f"DV: a pair's solve on the card: {r}")


def shortlist_phase() -> None:
    """L2: tools/profile_lo2 at full width (its rows timed), and the
    shortlist association's picks on the card against the CPU's, corner and
    surf, at its frame's LO shapes; TF32 off again after the phase."""
    from vloam_tpu_torch.tools import legacy_assoc, profile_lo2

    t0 = time.perf_counter()
    rec = profile_lo2.run("cuda", runs=1, replays=5)
    rows = "; ".join(f"{r['label']} {r['device_ms']:.3f} ms"
                     for r in rec["stages"])
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.lidar import scan_registration as sr
    from vloam_tpu_torch.tools.stages import n_points, xyz_frames

    cfg = kitti_hdl64()
    scans = xyz_frames(synthetic.drive_trajectory(2, speed=1.1,
                                                  yaw_rate=0.01),
                       range(2), 64, N_AZ, cfg.lidar.max_points)
    f0, f1 = (sr.register_scan(torch.from_numpy(s).cuda(), n_points(s),
                               cfg.lidar, cfg.scanreg) for s in scans)
    same = {}
    for mode, q, c in (("corner", f1.sharp, f0.less_sharp),
                       ("surf", f1.flat, f0.less_flat)):
        args = (q.xyz, c.xyz, c.ring, c.mask)
        card = legacy_assoc.shortlist_ring_assoc(*args, cfg.lo.nearby_scan,
                                                 mode, 24)
        cpu = legacy_assoc.shortlist_ring_assoc(
            *(a.cpu() for a in args), cfg.lo.nearby_scan, mode, 24)
        same[mode] = all(torch.equal(card[k].cpu(), cpu[k]) for k in card)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"[L2 profile_lo2] {rows}; shortlist picks and distances card vs "
          f"CPU identical: {same}; TF32 after the phase: {tf32} (in "
          f"{time.perf_counter() - t0:.1f} s) {clocks()}", flush=True)
    if not all(same.values()):
        fail(f"L2: the shortlist association differs card vs CPU: {same}")
    if tf32 or rec["tf32_after"]:
        fail("L2: TF32 was left on")


def bench_knn_phase(per_pair) -> None:
    """BK: tools/bench_knn at the script's four shapes: masked_knn (knn.cu)
    and its plain version, bit for bit on the first 1024 queries; bounds
    and issue floors (phase 2's instructions a pair) over every slot and
    over the live pairs."""
    from vloam_tpu_torch.tools import bench_knn

    t0 = time.perf_counter()
    recs = bench_knn.run("cuda", runs=5, plain_runs=2, per_pair=per_pair[5])
    print("[BK bench_knn] " + "; ".join(
        f"{r['shape']} {r['Q']}x{r['C']} ({r['live']} live): kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms (peak "
        f"{r['plain_peak_bytes'] / 2**20:.0f} MiB), bound "
        f"{r['bound_ms'] * 1e3:.1f} / {r['bound_live_ms'] * 1e3:.1f} us, "
        f"issue floor {r['issue_floor_ms'] * 1e3:.1f} / "
        f"{r['issue_floor_live_ms'] * 1e3:.1f} us (every slot / the live "
        f"pairs), first {r['checked_rows']} identical: {r['identical']}"
        for r in recs)
          + f" (in {time.perf_counter() - t0:.1f} s) {clocks()}", flush=True)
    if not all(r["identical"] for r in recs):
        fail("BK: masked_knn differs from its plain version")


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden")
# E1: MO within 0.15 m of ground truth (tests/test_golden_regression.py:37)
E1_MO_MAX_ERR = 0.15
# E2: 1.5x the JAX package's MO on the long drive, a TPU run (RESULTS.md:22-23:
# LO t_rel 1.462 %, ATE rmse 9.445 m; MO 0.590 %, 3.267 m)
E2_JAX = {"LO": (1.462, 9.445), "MO": (0.590, 3.267)}
E2_MO_LIMITS = (0.885, 4.90)  # MO t_rel %, ATE rmse m


def _metric_text(m: dict) -> str:
    return (f"t_rel {m['t_rel_percent']:.3f} %, ATE rmse "
            f"{m['ate_rmse_m']:.3f} m, max {m['ate_max_m']:.3f} m")


def golden_drive_phase(cfg) -> None:
    """E1: tools.eval_synthetic's lidar_only mode (xyz ingest, chunk 10) over
    the 100-frame drive once; MO against ground truth, against the JAX
    package's golden trajectory and metrics, and each hand kernel's
    launches over the run."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.tools import eval_frames, eval_synthetic

    t0 = time.perf_counter()
    calib, frames, gt = eval_frames.synthetic_drive(E1_FRAMES, cfg)
    kernels.reset_launches()
    rec, res = eval_synthetic.run_mode("lidar_only", calib, frames, gt, cfg,
                                       "cuda", runs=1)
    launches = dict(kernels.LAUNCHES)
    with open(os.path.join(GOLDEN, "synthetic_metrics.json")) as f:
        jax_metrics = json.load(f)
    golden = np.load(os.path.join(GOLDEN, "synthetic_lidar_MO.npy"))
    gap = np.linalg.norm(res["MO"][:, :, 3] - golden[:, :, 3], axis=1)
    m = rec["metrics"]
    print(f"[E1 golden drive] {E1_FRAMES} frames, tools.eval_synthetic "
          f"lidar_only (xyz ingest, chunk 10) in "
          f"{time.perf_counter() - t0:.1f} s, {rec['fps_first']:.2f} frames/s "
          f"(run_sequence_fused's clock); "
          + "; ".join(f"{w} {_metric_text(m[w])} (the JAX package's golden "
                      f"metrics, a TPU run: "
                      f"{_metric_text(jax_metrics['lidar_only/' + w])})"
                      for w in ("LO", "MO"))
          + f"; launches {launches}", flush=True)
    print(f"[E1 golden drive] MO gap to tests/golden/synthetic_lidar_MO.npy "
          f"(made on a TPU; a reading, not a gate): max {gap.max():.4f} m at "
          f"frame {int(gap.argmax())}, mm by frame "
          + " ".join(f"{1e3 * g:.1f}" for g in gap), flush=True)
    if not np.isfinite(res["MO"]).all() or res["MO"].shape != gt.shape:
        fail(f"E1: MO {res['MO'].shape} not finite")
    if not m["MO"]["ate_max_m"] < E1_MO_MAX_ERR:
        fail(f"E1: MO max error {m['MO']['ate_max_m']} m >= {E1_MO_MAX_ERR}")
    want = lidar_launches(E1_FRAMES)
    if launches != want:
        fail(f"E1: kernel launches {launches}, want {want}")


def long_drive_phase(cfg) -> None:
    """E2: tools.eval_long over the 500-frame drive (chunk 16, a last chunk
    of 4): every output finite, MO within 1.5x the JAX package's metrics,
    no degraded frame."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.tools import eval_frames, eval_long

    t0 = time.perf_counter()
    frames, gt = eval_frames.long_drive(E2_FRAMES)
    kernels.reset_launches()
    try:
        rec, _ = eval_long.run(frames, gt, cfg, "cuda")
    except RuntimeError as e:  # rows missing or not finite
        fail(f"E2: {e}")
    launches = dict(kernels.LAUNCHES)
    m = rec["metrics"]
    occ = "; ".join(f"{name} {o['live_slots']} live slots of "
                    f"{o['buckets'] * o['cap']}, {o['full_buckets']} full "
                    f"buckets of {o['buckets']}"
                    for name, o in rec["map"].items())
    print(f"[E2 long drive] {E2_FRAMES} frames, {rec['distance_m']:.1f} m, "
          f"{rec['crossings']} map recentre crossings, "
          f"{rec['degraded_frames']} degraded frames, all outputs finite, "
          f"in {time.perf_counter() - t0:.1f} s; {rec['fps_steady']:.2f} "
          f"frames/s (eval_long.run's window) {clocks()}; "
          + "; ".join(f"{w} {_metric_text(m[w])} (the JAX package, a TPU "
                      f"run: t_rel {E2_JAX[w][0]} %, ATE rmse "
                      f"{E2_JAX[w][1]} m)" for w in ("LO", "MO"))
          + f"; map at the end: {occ}; launches {launches}", flush=True)
    t_rel, ate = E2_MO_LIMITS
    if not (m["MO"]["t_rel_percent"] <= t_rel
            and m["MO"]["ate_rmse_m"] <= ate):
        fail(f"E2: MO t_rel {m['MO']['t_rel_percent']} % or ATE rmse "
             f"{m['MO']['ate_rmse_m']} m above {t_rel} % / {ate} m")
    if rec["degraded_frames"]:
        fail(f"E2: {rec['degraded_frames']} degraded frames")


SECONDS: dict[str, float] = {}  # each phase's seconds, printed at the end


def timed(name: str, fn, *args, **kw):
    """fn(*args, **kw), its seconds kept under `name`."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    dt = time.perf_counter() - t0
    SECONDS[name] = SECONDS.get(name, 0.0) + dt
    print(f"[time] phase {name} in {dt:.1f} s", flush=True)
    return out


def main() -> None:
    t_start = time.perf_counter()
    card = timed("1", device_phase)
    knn_per_pair = timed("2", build_phase)
    from vloam_tpu_torch.config import kitti_hdl64

    cfg = kitti_hdl64()
    cfg_v = cfg.replace(detach_VO_LO=False)
    calib = Calib()
    frames, images, poses, streams, stream_poses = timed("frames",
                                                         make_frames)
    procs = []  # the prerender, once started
    try:
        run_phases(t_start, card, knn_per_pair, cfg, cfg_v, calib, frames,
                   images, poses, streams, stream_poses, procs)
    finally:
        for proc in procs:
            stop_prerender(proc, wait=False)


def run_phases(t_start, card, knn_per_pair, cfg, cfg_v, calib, frames,
               images, poses, streams, stream_poses, procs) -> None:
    from vloam_tpu_torch.data.synthetic import hdl64_elevations
    from vloam_tpu_torch.lidar.scan_registration import polar_directions

    elev = torch.tensor(np.radians(hdl64_elevations(64)),
                        dtype=torch.float32, device="cuda")
    ff = frame_features(cfg, frames[:3], polar_directions(elev, N_AZ))
    timed("G", geometry_phase, cfg, cfg_v, calib, frames, images)
    timed("warm-up", warm_up)
    k1 = timed("3", k1_phase, cfg, ff)
    (k2, s1_min1, packed, err_argmin2), shapes = timed("4", ring_phase, ff)
    launches_assoc = timed("4b", assoc_phase, shapes)
    del ff, shapes
    walls = {}  # the end-to-end phases' wall ms a (lockstep) frame
    res_gpu, eng, outs_gpu = timed("5", e2e_phase, cfg, frames, poses, card,
                                   walls)
    timed("EIG", eig3_phase, cfg)
    timed("6", cpu_phase, cfg, frames, res_gpu)
    k3 = timed("7", k3_phase, cfg_v, images)
    res_v, launches_v, grid_line = timed("8", vloam_phase, cfg_v, frames,
                                         images, poses, calib, walls)
    timed("9", vloam_cpu_phase, cfg_v, frames, images, calib, res_v,
          grid_line)
    outs_b, launches_b, beng = timed("10", batch_phase, cfg, streams,
                                     stream_poses, walls)
    timed("11", batch_cpu_phase, cfg, streams, outs_b)
    # the later phases' frames, rendered beside the phases from here on
    # (after the CPU runs of phases 6, 9 and 11, which it would slow)
    pre = start_prerender()
    procs.append(pre)
    probe, s2 = timed("S2", s2_phase, eng, frames[N_FRAMES - 1], beng,
                      streams)
    del eng, beng
    timed("P", pack12_phase, cfg, cfg_v, frames, images, poses, calib,
          streams, stream_poses, res_gpu, res_v, outs_b)
    s1_argmin2 = timed("12", ring_variants_phase, err_argmin2)
    stats13 = timed("13", profile_phase, cfg, cfg_v, frames, images, calib,
                    streams)
    timed("T", stage_phase, frames, images, stats13, walls)
    timed("14a", host_cli_phase, frames, poses, calib)
    res_host = timed("14b", host_combined_phase, cfg_v, frames, images,
                     poses, calib)
    timed("14c", host_resume_phase, cfg, frames, outs_gpu)
    loops = timed("14d", host_loop_phase, cfg, frames, res_host)
    host_frames = _host_frames(frames, images)
    res_he = timed("15a", host_engine_phase, cfg_v, host_frames, poses,
                   calib, res_host)
    timed("15b", host_cpu_phase, cfg_v, host_frames, calib, res_he)
    timed("15c", flow_phase, cfg_v, frames, images, poses, calib, walls)
    timed("15d", host_cli_viz_phase)
    thr = timed("V1", detector_phase, cfg_v.vo, images)
    timed("V2", orb_flann_phase, cfg_v.vo, images, thr)
    timed("V3", option_engines_phase, cfg_v, frames, images, poses, calib,
          thr, walls)
    timed("V4", batched_selection_phase, cfg, frames, poses, walls)
    timed("V5", ransac_phase)
    # the mesh: one NCCL rank on this card, in this process
    from vloam_tpu_torch.parallel.sharded import spmd_mesh

    t_mesh = time.perf_counter()
    with spmd_mesh() as mesh:  # the group ends after MB
        outs_m2, eng_m2, launches_m2 = timed("M2", mesh_engine_phase, cfg,
                                             frames, poses, outs_gpu, mesh)
        knn = timed("M1", mesh_knn_phase, cfg, eng_m2, frames[N_FRAMES - 1],
                    outs_m2[-1], knn_per_pair)
        del eng_m2
        timed("M3", mesh_ranks_phase, frames, outs_m2)
        timed("M4", mesh_vloam_phase, cfg_v, frames, images, calib, res_v,
              mesh)
        timed("M5", mesh_loop_phase, cfg, frames, res_host, loops, mesh)
        # the frames of MS and of the phases after M come from the prerender
        timed("prerender wait", stop_prerender, pre, wait=True)
        timed("MS", mesh_model_phase)
        timed("MB", bench_mesh_phase)
    if torch.distributed.is_initialized():
        fail("the mesh phases' process group outlived them")
    print(f"[M] phases M1-M5, MS and MB in "
          f"{time.perf_counter() - t_mesh:.1f} s", flush=True)
    t_eval = time.perf_counter()
    timed("E1", golden_drive_phase, cfg)
    timed("E2", long_drive_phase, cfg)
    print(f"[E] phases E1-E2 in {time.perf_counter() - t_eval:.1f} s",
          flush=True)
    timed("B", bench_phase, card, frames, images)
    t_new = time.perf_counter()
    timed("U", upload_phase)
    timed("DV", diag_vo_phase)
    timed("L2", shortlist_phase)
    timed("BK", bench_knn_phase, knn_per_pair)
    print(f"[U-BK] phases U, DV, L2 and BK in "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    total = time.perf_counter() - t_start
    print("[seconds] each phase's: " + ", ".join(
        f"{k} {v:.1f}" for k, v in SECONDS.items())
          + f"; the rest {total - sum(SECONDS.values()):.1f}", flush=True)
    print(f"[done] phases 1-B in {total:.1f} s", flush=True)
    # launches: each kernel's count over the run of the path that drives it,
    # with the counts set to 0 just before: the batch drive (phase 10), the
    # combined engine (phase 8) for K3, the association forms (phase 4b)
    # for K2 and ring_min1, the ring-variants entry point (phase 12) for
    # ring_argmin2, the mesh engine (M2) for masked_knn
    for row in (k1, packed, probe, s2):
        row["launches"] = launches_b[row["name"]]
    for row in (k2, s1_min1):
        row["launches"] = launches_assoc[row["name"]]
    k3["launches"] = launches_v["zncc_describe"]
    knn["launches"] = launches_m2["masked_knn"]
    kernels = [k1, k2, k3, probe, s2, s1_min1, s1_argmin2, packed, knn]
    if any(not row["launches"] > 0 for row in kernels):
        fail(f"a kernel was never launched on its path: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["mesh-rank"]:
        mesh_rank_main(*sys.argv[2:5])
    elif sys.argv[1:2] == ["prerender"]:
        prerender_main()
    else:
        main()
