"""TF32 rounding and the 3xTF32 split, emulated in torch on the CPU.

Shared by the tests that repeat the tensor-core kernels' arithmetic
(``test_torch_ssd_sm90.py``, ``test_torch_flash_tc32.py``): the kernels
split each f32 operand into hi, a cut to TF32's 10 mantissa bits (its low
13 bits cleared), and lo = a - hi, which the tensor core reads at TF32
precision (its low 13 bits cleared here too).
"""
import torch


def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest,
    ties away from zero, at 10 mantissa bits (the low 13 bits cleared)."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(
        torch.float32)


def truncate_tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 with its low 13 bits cleared: TF32 read off the top 19 bits."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(a: torch.Tensor):
    """The kernels' split: hi = a cut to TF32, lo = a - hi (exact in f32) as
    the tensor core reads it."""
    hi = truncate_tf32(a)
    return hi, truncate_tf32(a - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernels' 3xTF32: hi·hi and hi·lo + lo·hi, each sum f32."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh + (al @ bh + ah @ bl)


def mm_tf32(a, b):
    """a @ b in single-pass TF32."""
    return tf32(a) @ tf32(b)
