"""Stage ablation of the sample-statistics kernel (counterpart of
``scripts/ablate_fused.py``).

``stats_variant(x, alpha, beta, variant)`` runs the stats kernel of K1 and
K2 (``stats_kernel`` of ``kernels/csrc/stats.cuh``) with stages switched
off, as the kernel A1 (``bliss_stats_ablate`` of ``kernels/csrc/ablate.cu``):

- ``full``: the shipped kernel (fp64 FIR, correction and sums);
- ``no_cheb``: the raw sample in place of the amplitude weight;
- ``no_conv``: the normalized signal in place of the FIR's output;
- ``no_warm``: no window-reset correction (delta = 0);
- ``bare``: all three off;
- ``fir_fp32``: the FIR, the correction and their sums in float32 (the
  script's lower-precision "conv DEFAULT"; on the card, what fp64 costs).

It returns the script's own layout, [B, NC, 8, NBLK] for NC chunks of
``chunk`` samples and NBLK = chunk // 256 hop blocks, rows (s1, s2, sa, d1,
d2, da, wsum, rownz): the block's sums of z, z^2 and (-1)^t z, the sums of
the window-reset correction's share of them, the amplitude weight sum and
the any-nonzero flag. From the kernel's pieces (``stats_pieces``, the
launch alone): s = tail + head and d = reset - head. The history before
sample 0 is normalized zero, after it the previous raw samples, normalized
(the script's ``no_hist``).

``reduce_probe(x, body)`` runs the script's ``run_variant2`` bodies
(``zero``, ``convert``, ``one_sum``, ``sums_stack``, ``six_sums``) through
the probe kernel A2 (``probe.py``); ``one_sum`` and ``sums_stack`` differ
only in the TPU's layout and are both ``sum1``.

On a CUDA tensor each launches its kernel; on a CPU tensor each runs its
plain version (``stats_variant_reference``, ``reduce_probe_reference``).
"""

from __future__ import annotations

import torch

from bliss_tpu_torch.ablate import probe as _probe
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.kernels import fused_stats as fs

CHUNK = 245760  # the scripts' chunk: 960 hop blocks
TAPS = 17  # the scripts' one band: the reference's 17-tap FIR
# name -> (kernel variant, cheb, conv, warm, FIR type)
VARIANTS = {
    "full": (0, True, True, True, torch.float64),
    "no_cheb": (1, False, True, True, torch.float64),
    "no_conv": (2, True, False, True, torch.float64),
    "no_warm": (3, True, True, False, torch.float64),
    "bare": (4, False, False, False, torch.float64),
    "fir_fp32": (5, True, True, True, torch.float32),
}
# scripts/ablate_fused.py's run_variant2 bodies -> probe modes
BODIES = {
    "zero": "zero",
    "convert": "convert",
    "one_sum": "sum1",
    "sums_stack": "sum1",
    "six_sums": "sum6",
}

# Launches of the CUDA kernel A1: one per stats_pieces (so per stats_variant)
# on a CUDA tensor.
LAUNCHES = 0


def _check(x, alpha, beta, variant, chunk=None):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {sorted(VARIANTS)}")
    fs.check_stats_inputs(x, alpha, beta, None, 1, TAPS, fs.BLK)
    if chunk is not None:
        _probe.rows(x, chunk)


def script_rows(wsum, rownz, stats, chunk: int) -> torch.Tensor:
    """[B, NC, 8, NBLK] rows (s1, s2, sa, d1, d2, da, wsum, rownz), in
    ``stats``' type, from the stats kernel's outputs of one band."""
    tail, head, reset = stats[:, 0, 0:3], stats[:, 0, 3:6], stats[:, 0, 6:9]
    rows = torch.cat(
        [tail + head, reset - head, wsum[:, None].to(stats.dtype),
         rownz[:, None].to(stats.dtype)],
        dim=1,
    )  # [B, 8, NBF]
    B, _, NBF = rows.shape
    nblk = chunk // fs.BLK
    return rows.reshape(B, 8, NBF // nblk, nblk).transpose(1, 2).contiguous()


def _pieces_reference(x, alpha, beta, variant):
    _, cheb, conv, warm, dtype = VARIANTS[variant]
    return fs.block_stats_reference(
        x, alpha, beta, nb_bands=1, band_taps=TAPS, filterbank="firwin",
        cheb=cheb, conv=conv, warm=warm, fir_dtype=dtype,
    )


def stats_pieces(
    x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, variant: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stats kernel's own outputs under ``variant``: wsum and rownz
    [B, L/256] and the pieces [B, 1, 9, L/256] (tail, head, reset; each
    v, v^2, (-1)^t v). One launch of A1 on a CUDA tensor, with no copy
    after it (what ``python -m bliss_tpu_torch.ablate`` times); the plain
    version on a CPU tensor."""
    _check(x, alpha, beta, variant)
    if x.device.type == "cpu":
        return _pieces_reference(x, alpha, beta, variant)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    from bliss_tpu_torch.kernels import _build

    index, *_, dtype = VARIANTS[variant]
    tabs = dict(device_tables(1, TAPS, "firwin", x.device))
    tabs["fir"], tabs["warm"] = tabs["fir"].to(dtype), tabs["warm"].to(dtype)
    args, outs = fs.stats_launch_args(x, alpha, beta, None, tabs, 1, TAPS)
    _build.launch("ablate", "bliss_stats_ablate", x.device, index, *args)
    _build.count_launch(globals(), "LAUNCHES")
    return outs


def stats_variant(
    x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, variant: str,
    *, chunk: int = CHUNK,
) -> torch.Tensor:
    """[B, NC, 8, NBLK] of int16 x [B, L] (L a multiple of ``chunk``) under
    ``variant``; float64, float32 for ``fir_fp32``."""
    _check(x, alpha, beta, variant, chunk)
    return script_rows(*stats_pieces(x, alpha, beta, variant), chunk)


def stats_variant_reference(
    x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, variant: str,
    *, chunk: int = CHUNK,
) -> torch.Tensor:
    """Plain PyTorch version of ``stats_variant``: the shipped kernel's
    plain version (``fused_stats.block_stats_reference``) with the same
    stages switched off."""
    _check(x, alpha, beta, variant, chunk)
    return script_rows(*_pieces_reference(x, alpha, beta, variant), chunk)


def _body_rows(x, body, chunk):
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; one of {sorted(BODIES)}")
    if x.dtype != torch.int16:
        raise ValueError(f"x must be int16 [B, L], got {x.dtype}")
    return _probe.rows(x, chunk)


def reduce_probe(x: torch.Tensor, body: str, *, chunk: int = CHUNK) -> torch.Tensor:
    """float32 [B, NC, 8, NBLK]: ``scripts/ablate_fused.py``'s ``v_<body>``
    on int16 x [B, L]."""
    xr, nblk = _body_rows(x, body, chunk)
    return _probe.probe(xr, nblk, BODIES[body])


def reduce_probe_reference(x: torch.Tensor, body: str, *, chunk: int = CHUNK) -> torch.Tensor:
    """Plain PyTorch version of ``reduce_probe``."""
    xr, nblk = _body_rows(x, body, chunk)
    return _probe.probe_reference(xr, nblk, BODIES[body])
