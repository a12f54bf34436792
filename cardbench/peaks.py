"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit)."""
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bf16': 989e12, 'fp32': 67e12}


def bound_s(n_bytes: float, n_ops: float, precision: str) -> float:
    """The least time: bytes over the memory rate or operations over the
    peak rate of their type, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS[precision])
