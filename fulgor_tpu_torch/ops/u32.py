"""uint32 arithmetic for the plain PyTorch versions of the kernels.

The port carries u32 data as torch.int32 bit patterns. PyTorch on the CPU
cannot shift, compare or index uint32 tensors, so the plain versions widen
to int64 values in [0, 2^32) and keep every product below 2^63: 32-bit
multiplies are split at 16 bits, as fulgor_tpu's mulhi32 does. The CUDA
kernels use native uint32_t/uint64_t and __umulhi for the same results.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) -> int64 values mod 2^32."""
    return t.to(torch.int64) & M32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> torch.int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for u32 values x and a 32-bit constant c."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """fulgor_tpu's mix32 (ops/lookup.py) on int64-held u32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def mulhi32(a: torch.Tensor, c: int) -> torch.Tensor:
    """floor(a * c / 2^32) for u32 values a and a 32-bit constant c, in
    16-bit limbs (a * c itself can pass 2^63)."""
    a0, a1 = a & 0xFFFF, a >> 16
    c0, c1 = c & 0xFFFF, c >> 16
    lo = a0 * c0
    t = a1 * c0 + (lo >> 16)
    t2 = a0 * c1 + (t & 0xFFFF)
    return a1 * c1 + (t >> 16) + (t2 >> 16)
