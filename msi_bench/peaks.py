"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the 700 W power limit), against which every roofline share is stated."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bf16": 989e12, "f32": 67e12}


def least_s(flops: float, nbytes: float, peak: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / FLOPS[peak], nbytes / HBM_BYTES_PER_S)
