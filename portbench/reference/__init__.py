"""Plain references that decide ``correct``: PyTorch and NumPy only.

Nothing here imports the program (``qmf_tpu_torch``), the JAX package or
JAX; each module works out again from the benchmark's inputs whatever the
program derives from them (indices, packed classes, bitmaps, shuffles,
negatives), and computes in a precision given by name:

- ``"float64"``: the reference;
- ``"tf32"``: float32 storage, every matrix product's operands rounded to
  TF32 (10 mantissa bits, round to nearest) and accumulated in float32,
  as the card's TF32 tensor cores do: the control of a float32
  configuration with TF32 off;
- ``"bfloat16"``: the state kept and computed in bfloat16: the control of
  a float32 configuration whose hot path has no matrix product (BPR).
"""

from __future__ import annotations

import torch


def storage_dtype(precision: str) -> torch.dtype:
    return {"float64": torch.float64, "tf32": torch.float32,
            "bfloat16": torch.bfloat16}[precision]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` (batched too) in ``precision``; true float32/float64 with
    TF32 off, whatever the process set."""
    if precision == "tf32":
        a, b = round_tf32(a.float()), round_tf32(b.float())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
