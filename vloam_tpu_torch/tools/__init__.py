"""Measurement entry points of the port, run on the GPU:

    python -m vloam_tpu_torch.tools.profile_row_gather
    python -m vloam_tpu_torch.tools.profile_ring_variants

the counterparts of scripts/profile_pallas_gather.py and
scripts/profile_ring_variants.py. Both raise without a GPU.
"""
