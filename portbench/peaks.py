"""Published peaks of one NVIDIA H100 SXM card (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the least time a piece of work
can take on it.

Products (the multiply-adds of a matrix product, two operations each) are
counted once each, at the tensor cores' TF32 rate: the highest published rate
at which the card takes float32 operands. Everything else runs at the CUDA
cores' float32 rate, beside the tensor cores. Bytes move at the HBM3 rate.
So a bound reads the same work whatever implements it.
"""

from __future__ import annotations

PRODUCTS_PER_S = 495e12  # TF32 on the tensor cores, dense
FLOAT32_PER_S = 67e12  # float32 on the CUDA cores
BYTES_PER_S = 3.35e12  # HBM3


def bound_s(products: float, others: float, nbytes: float) -> float:
    """The least seconds this work takes: the largest of its products at
    the tensor-core rate, its other operations at the CUDA-core rate, and its
    bytes at the memory rate."""
    return max(products / PRODUCTS_PER_S, others / FLOAT32_PER_S, nbytes / BYTES_PER_S)


def mfu_percent(products: float, seconds: float) -> float:
    """Products per second as a share of the product peak, in percent."""
    return 100.0 * products / seconds / PRODUCTS_PER_S
