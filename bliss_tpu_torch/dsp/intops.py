"""Integer helpers matching C semantics where they are observable."""

from __future__ import annotations

import torch


def c_div(a: torch.Tensor, b) -> torch.Tensor:
    """C-style integer division (truncation toward zero).

    The reference relies on C `/` for the signal mean and the stereo
    downmix (reference: src/helpers.c:36, src/frequency_sort.c:71-73);
    Python's `//` floors instead, which differs for negative operands.
    """
    return torch.div(a, b, rounding_mode="trunc")


def wrapping_sum_int32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum of an integer tensor along ``dim`` that wraps modulo 2**32 like a
    C ``int`` accumulator, returned as int32.

    ``torch.sum`` widens int32 to int64 and so never wraps; the exact int64
    sum is reduced mod 2**32 here. Exact while the true sum fits int64,
    which holds for any int16 input below 2**48 samples.
    """
    s = torch.sum(x, dim=dim, dtype=torch.int64)
    return (torch.remainder(s + 2**31, 2**32) - 2**31).to(torch.int32)
