"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W) and
the least time a kernel can take on it."""

HBM_BYTES_PER_S = 3.35e12
NONTENSOR_OPS_PER_S = 67e12  # float32 outside the tensor cores


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The larger of bytes over the memory peak and operations over the
    compute peak, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / NONTENSOR_OPS_PER_S)
