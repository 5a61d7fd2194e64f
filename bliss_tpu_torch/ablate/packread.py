"""Reading the PCM as int16 or as packed int32 words (counterpart of
``scripts/ablate_packread.py``), through the probe kernel A2
(``probe.py``). The int32 view carries the same bytes as the int16 batch
in half the elements: a word w holds samples 2k (lo = (w << 16) >> 16) and
2k+1 (hi = w >> 16).

- ``call_i16``: int16 x [B, L], each 256-sample row's sum;
- ``call_packed``: int32 words [B, L/2], each 256-word row's sum of lo + hi;
- ``call_packed_nounpack``: the same words summed as int32 values, which
  isolates the unpacking from the read.

Outputs are [B, NC, 8, rows of a chunk] float32 for NC chunks of ``chunk``
int16 samples (``chunk // 256`` rows a chunk for int16, ``chunk // 512``
for the words), each row's sum 8 times. Each ``call_*`` launches the kernel
on a CUDA tensor and runs its plain version, ``call_*_reference``, on a CPU
tensor.
"""

from __future__ import annotations

import torch

from bliss_tpu_torch.ablate import probe as _probe

CHUNK = 245760


def packed_words(x: torch.Tensor) -> torch.Tensor:
    """int32 [B, L/2] words of int16 x [B, L] (the same bytes)."""
    return x.contiguous().view(torch.int32)


def _i16(x, chunk):
    if x.dtype != torch.int16:
        raise ValueError(f"x must be int16 [B, L], got {x.dtype}")
    return _probe.rows(x, chunk)


def _words(w, chunk):
    if w.dtype != torch.int32:
        raise ValueError(f"words must be int32 [B, L/2], got {w.dtype}")
    return _probe.rows(w, chunk // 2)


def call_i16(x: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    return _probe.probe(*_i16(x, chunk), "sum1")


def call_i16_reference(x: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    return _probe.probe_reference(*_i16(x, chunk), "sum1")


def call_packed(words: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    return _probe.probe(*_words(words, chunk), "packed")


def call_packed_reference(words: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    return _probe.probe_reference(*_words(words, chunk), "packed")


def call_packed_nounpack(words: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    return _probe.probe(*_words(words, chunk), "sum1")


def call_packed_nounpack_reference(words: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    return _probe.probe_reference(*_words(words, chunk), "sum1")
