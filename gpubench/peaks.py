"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full 700 W power limit): the yardstick of every roofline share.

The path tracer's walks and shading are float32 arithmetic outside the
tensor cores, so its operation peak is the float32 vector rate.
"""

FP32_FLOPS = 67e12        # float32, outside the tensor cores
HBM_BYTES_S = 3.35e12     # 80 GB HBM3


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take for ``ops`` float32 operations
    and ``nbytes`` bytes of device memory traffic."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_S)
