"""Measurement entry points of the port, run on the GPU:

    python -m vloam_tpu_torch.tools.bench [--device cpu]

the port's counterpart of bench.py and scripts/bench_extras.py (one JSON
line: LoamEngine frames/s and bench.py's other keys, the card, the host
CPU, VloamEngine frames/s, the pose graph's Gauss-Newton steps a second),

    python -m vloam_tpu_torch.tools.profile_row_gather
    python -m vloam_tpu_torch.tools.profile_grid_probe [--parent DIR]
    python -m vloam_tpu_torch.tools.profile_ring_variants [--shapes] \
        [--parent DIR]

the counterparts of scripts/profile_pallas_gather.py (the row gather, and
the map probe that fuses it) and scripts/profile_ring_variants.py, and

    python -m vloam_tpu_torch.tools.profile_zncc [--parent DIR]
    python -m vloam_tpu_torch.tools.profile_select_rings
    python -m vloam_tpu_torch.tools.profile_primitives

(K3 and K1 by parts, warp-primitive latencies), and

    python -m vloam_tpu_torch.tools.profile_stages [--device cpu] [--tiny]
    python -m vloam_tpu_torch.tools.profile_vision_stages [...]
    python -m vloam_tpu_torch.tools.profile_batch_stages [...]

the counterparts of the JAX package's stage profilers (scripts/
calibrate_timing.py and scripts/profile_*.py): a frame of LoamEngine,
VloamEngine and BatchLoamEngine split into its stages, each with its host
enqueue, wall, graph-replayed device time and launches (stages.py holds
their table and frames). All raise without a GPU (bench and the stage
profilers unless --device cpu).
Beside them: timing.py (device time of a call, a stage's clocks
(stage_clocks), bounds), kernel_cases.py
(crafted inputs for K1 select_rings, K2 ring_min2, S1 ring_min1,
ring_argmin2 and ring_min1_packed, K3 zncc_describe and S2 grid_probe:
plain numpy, used by the CPU tests, the GPU tests and chip_smoke.py) and

    python -m vloam_tpu_torch.tools.trajectories save|diff ...

which saves and compares the three engines' output rows on a short drive.
"""
