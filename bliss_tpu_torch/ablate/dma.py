"""Launch and copy probes (counterpart of ``scripts/ablate_dma.py``),
through the probe kernel A2 (``probe.py``), in the script's layout
[B, NC, 8, NBLK] for NC chunks of ``chunk`` elements, NBLK = chunk // 256:

- ``call_noin``: zeros, reading no input (the grid and the output's write);
- ``call_x``: the first 8 rows of each chunk, first NBLK elements each
  (int16, int32 or float32; rows of 256 elements);
- ``call_touch``: every row's sum, so every element is read.

Each ``call_*`` launches the kernel on a CUDA tensor and runs its plain
version, ``call_*_reference``, on a CPU tensor.
"""

from __future__ import annotations

import torch

from bliss_tpu_torch.ablate import probe as _probe

CHUNK = 245760


def call_noin(x: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    """Zeros [B, NC, 8, NBLK] in the shape of x [B, L]; x is not read."""
    return _probe.probe(*_probe.rows(x, chunk), "zero")


def call_noin_reference(x: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    return _probe.probe_reference(*_probe.rows(x, chunk), "zero")


def call_x(x: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    """x [B, L] seen as rows of 256 elements: out[b, c, i, j] =
    x[b, c*NBLK + i, j] for j < 256, else 0."""
    return _probe.probe(*_probe.rows(x, chunk), "slice")


def call_x_reference(x: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    return _probe.probe_reference(*_probe.rows(x, chunk), "slice")


def call_touch(x: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    """Each 256-element row's sum, 8 times."""
    return _probe.probe(*_probe.rows(x, chunk), "sum1")


def call_touch_reference(x: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    return _probe.probe_reference(*_probe.rows(x, chunk), "sum1")
