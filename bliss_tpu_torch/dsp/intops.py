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


def wrap_int32(s: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of the exact int64 ``s`` as a signed int32: what a C
    ``int`` accumulator holds after summing to ``s``. ``torch.sum`` widens
    int32 to int64 and so never wraps; an exact int64 sum of int16 samples
    reduced here wraps like the C sum."""
    return (torch.remainder(s + 2**31, 2**32) - 2**31).to(torch.int32)
