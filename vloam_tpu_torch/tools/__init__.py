"""Measurement entry points of the port, run on the GPU:

    python -m vloam_tpu_torch.tools.profile_row_gather
    python -m vloam_tpu_torch.tools.profile_ring_variants

the counterparts of scripts/profile_pallas_gather.py and
scripts/profile_ring_variants.py. Both raise without a GPU. Beside them:
timing.py (device time of a call, bounds), kernel_cases.py (crafted inputs
for K1 select_rings and K2 ring_min2: plain numpy, used by the CPU tests, the
GPU tests and chip_smoke.py) and

    python -m vloam_tpu_torch.tools.trajectories save|diff ...

which saves and compares the three engines' output rows on a short drive.
"""
