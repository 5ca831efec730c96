"""Peak rates of one NVIDIA H100 80GB HBM3 (SXM), from NVIDIA's data sheet:
dense rates without sparsity, at the card's 700 W power limit. A card set
below 700 W runs slower under load; the benchmark prints the limit it read
beside every share of a peak."""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, flops_peak: float = BF16_FLOPS) -> float:
    """The least time the card could take for some work: the larger of its
    operations over the peak rate and its bytes over the memory's."""
    return max(flops / flops_peak, nbytes / HBM_BYTES_PER_S)
