"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit; the run reports the card's limit beside a share)."""

H100_BYTES_PER_S = 3.35e12  # HBM3
H100_FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores
H100_FP64_OPS_PER_S = 34e12  # float64 outside the tensor cores


def least_seconds(ops: float, ops_f64: float, n_bytes: float) -> float:
    """The least time the card needs for the work: the larger of its
    operations (float32 and float64 at their rates, one after the other)
    and its bytes at the memory rate."""
    return max(ops / H100_FP32_OPS_PER_S + ops_f64 / H100_FP64_OPS_PER_S,
               n_bytes / H100_BYTES_PER_S)
