"""Read-and-reduce probes with the stats kernel's launch geometry: the
kernel A2 (``bliss_probe`` of ``kernels/csrc/ablate.cu``) behind the
counterparts of ``scripts/ablate_fused.py``'s ``run_variant2`` bodies,
``scripts/ablate_dma.py`` and ``scripts/ablate_packread.py``.

``probe(x, nblk, mode)`` reads rows of 256 elements, x [B, R, 256] of
int16, int32 or float32 with R a multiple of ``nblk`` (the rows of one
chunk, at least 8), and writes float32 [B, R // nblk, 8, nblk], the TPU
scripts' own layout: out[b, c, i, j] for row j of chunk c. Its modes:

- ``zero``: 0, reading nothing;
- ``slice``: x[b, c*nblk + i, j] for j < 256, else 0 (the first 8 rows of
  each chunk);
- ``convert``: the chunk's first element;
- ``sum1``: the row's sum;
- ``sum6``: the row's sums of x, x^2, x+1, 2x, x-1 and x/2, then of x and
  x^2 again;
- ``packed``: int32 words holding two int16 samples each; the row's sum of
  lo + hi, lo = (w << 16) >> 16 and hi = w >> 16.

Sums run in float32. The kernel walks 8 rows per block of 256 threads, one
element a thread, and sums each row with the stats kernel's ``block_sums``,
so at full width its time is that kernel's floor for the read and its
per-row barriers. On a CUDA tensor ``probe`` launches the kernel; on a CPU
tensor it runs ``probe_reference``, the plain PyTorch version.
"""

from __future__ import annotations

import torch

ROW = 256  # elements a row: the stats kernel's hop block
MODES = {"zero": 0, "slice": 1, "convert": 2, "sum1": 3, "sum6": 4, "packed": 5}
DTYPES = {torch.int16: 0, torch.int32: 1, torch.float32: 2}

# Launches of the CUDA kernel: one per probe on a CUDA tensor.
LAUNCHES = 0


def check_probe_inputs(x: torch.Tensor, nblk: int, mode: str) -> None:
    """Raises ValueError for what the kernel does not take."""
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}; one of {sorted(MODES)}")
    if x.dtype not in DTYPES or x.dim() != 3 or x.shape[2] != ROW:
        raise ValueError(
            f"x must be int16, int32 or float32 [B, R, {ROW}], got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if mode == "packed" and x.dtype != torch.int32:
        raise ValueError(f"mode 'packed' reads int32 words, got {x.dtype}")
    B, R, _ = x.shape
    if B < 1 or nblk < 8 or R < nblk or R % nblk:
        raise ValueError(
            f"need B >= 1 and R a positive multiple of nblk >= 8, got B={B}, "
            f"R={R}, nblk={nblk}"
        )


def probe(x: torch.Tensor, nblk: int, mode: str) -> torch.Tensor:
    """float32 [B, R // nblk, 8, nblk] of rows x [B, R, 256] (see the
    module's docstring)."""
    check_probe_inputs(x, nblk, mode)
    if x.device.type == "cpu":
        return probe_reference(x, nblk, mode)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    from bliss_tpu_torch.kernels import _build

    B, R, _ = x.shape
    out = torch.empty(B, R // nblk, 8, nblk, dtype=torch.float32, device=x.device)
    _build.launch(
        "ablate", "bliss_probe", x.device, MODES[mode], DTYPES[x.dtype],
        None if mode == "zero" else x.data_ptr(), B, R, nblk, out.data_ptr(),
    )
    _build.count_launch(globals(), "LAUNCHES")
    return out


def probe_reference(
    x: torch.Tensor, nblk: int, mode: str, *, absolute: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of ``probe``. ``absolute=True`` sums the
    absolute value of each term instead: the scale that a sum's rounding
    error is stated against."""
    check_probe_inputs(x, nblk, mode)
    B, R, _ = x.shape
    nc = R // nblk
    if mode in ("zero", "slice", "convert"):
        out = torch.zeros(B, nc, 8, nblk, dtype=torch.float32, device=x.device)
        if mode == "slice":
            m = min(ROW, nblk)
            out[..., :m] = x.reshape(B, nc, nblk, ROW)[:, :, :8, :m].to(torch.float32)
        elif mode == "convert":
            out += x.reshape(B, nc, nblk * ROW)[:, :, 0, None, None].to(torch.float32)
        return out.abs() if absolute else out
    if mode == "packed":
        lo = ((x & 0xFFFF) ^ 0x8000) - 0x8000  # (w << 16) >> 16, sign-extended
        f = lo.to(torch.float32) + (x >> 16).to(torch.float32)
    else:
        f = x.to(torch.float32)
    terms = [f]
    if mode == "sum6":
        terms = [f, f * f, f + 1.0, f * 2.0, f - 1.0, f * 0.5]
    if absolute:
        terms = [t.abs() for t in terms]
    sums = [t.sum(dim=-1) for t in terms]  # each [B, R]
    out = torch.stack([sums[i % len(sums)] for i in range(8)], dim=1)
    return out.reshape(B, 8, nc, nblk).transpose(1, 2).contiguous()


def rows(x: torch.Tensor, chunk: int) -> tuple[torch.Tensor, int]:
    """(x as [B, L // 256, 256] rows, rows per chunk) of x [B, L], L a
    multiple of ``chunk`` and ``chunk`` a multiple of 256 * 8."""
    if x.dim() != 2:
        raise ValueError(f"x must be [B, L], got {tuple(x.shape)}")
    B, L = x.shape
    if chunk < 8 * ROW or chunk % ROW or L % chunk:
        raise ValueError(
            f"chunk must be a multiple of {ROW} of at least {8 * ROW} that "
            f"divides L={L}, got {chunk}"
        )
    return x.reshape(B, L // ROW, ROW), chunk // ROW
