"""Signal framing (counterpart of ``bliss_tpu/dsp/framing.py``).

512-sample windows at hop 256 (reference: src/tempo_atk_sort.c:50-55) or
hop 512 (src/frequency_sort.c:67). ``Tensor.unfold`` gives the windows as a
strided view, with no copy; the JAX module's interleaved reshapes exist only
for XLA's layout.
"""

from __future__ import annotations

import torch


def frame_signal(x: torch.Tensor, frame: int = 512, hop: int = 256) -> torch.Tensor:
    """The last axis of ``x`` as overlapping windows [..., n_windows, frame],
    n_windows = L // hop - (frame // hop - 1), a view of ``x``. Takes
    hop == frame or hop == frame // 2, and ``x.shape[-1]`` a multiple of
    ``frame``, as the JAX function does."""
    L = x.shape[-1]
    if L % frame:
        raise ValueError(f"signal length {L} not a multiple of frame {frame}")
    if hop not in (frame, frame // 2) or frame % hop:
        raise ValueError("only hop == frame or hop == frame//2 supported")
    return x.unfold(-1, frame, hop)
