"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): HBM3 bandwidth and float32 rate outside
the tensor cores. A roofline share is stated against these, with the
card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_seconds(n_bytes, n_ops):
    """The least time the card could take to move ``n_bytes`` and do
    ``n_ops`` float32 operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
