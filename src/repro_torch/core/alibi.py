"""ALiBi slopes (paper §III.A).  The kernels keep the ALiBi operand, so
the slope schedule is part of the port even though the dense decoders it
serves use RoPE."""
from __future__ import annotations

import math

import torch


def alibi_slopes(num_heads: int, device="cpu") -> torch.Tensor:
    """Standard ALiBi slope schedule: geometric in 2^(-8/n), [H] f32.

    Handles non-power-of-two head counts the way the ALiBi paper does
    (interleave the next power of two's odd slopes).
    """
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        s = pow2_slopes(num_heads)
    else:
        n = 2 ** math.floor(math.log2(num_heads))
        s = pow2_slopes(n) + pow2_slopes(2 * n)[0::2][: num_heads - n]
    return torch.tensor(s, dtype=torch.float32, device=device)
