"""Amplitude (loudness) analyzer on the XLA path (counterpart of
``bliss_tpu/features/amplitude.py``).

Behavioral model (reference: src/amplitude_sort.c:12-80): trim leading and
trailing zero samples, histogram the s16 sample values into 65 536 bins,
smooth with a 7-tap FIR for 301 passes, normalize by the trimmed length, and
integrate the bins within +-1000 of INT16_MAX; score = -0.2*integral + 6.

- "table": the smoothing and the windowed integral are linear, so the
  analysis is one masked gather-and-sum over the samples
  (``tables.amplitude_weight_table``).
- "poly": the same weight from a Chebyshev fit of the smoothing kernel's
  CDF (``kernels/fused_stats.cheb_T``, the kernels' own evaluation).
- "iterative": the reference's 301 float32 passes, on a 4096-bin crop of
  the histogram around the integral window (the kernel's +-903-bin radius
  carries nothing from outside the crop into the window).

The kernels' path computes the "poly" weight inside K1 or K2; this module
serves the configs that take the XLA-path stage and ``Song.amplitude_analysis``.
It runs on the batch's device, a block of rows (``types.row_blocks``) at a
time.
"""

from __future__ import annotations

import torch

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.features.types import PCMBatch, row_blocks
from bliss_tpu_torch.kernels.fused_stats import cheb_T

# Crop of the iterative mode: the integral window grown by the 903-bin
# influence radius, rounded out to 4096 bins.
_CROP_LO = 30720
_CROP_W = 4096


def trim_bounds(s: torch.Tensor):
    """First and last nonzero sample index per row ([B], [B] int64); an
    all-zero row gives (0, L - 1), as ``argmax`` of all-False does."""
    nonzero = (s != 0).to(torch.uint8)
    start = torch.argmax(nonzero, dim=1)
    end = s.shape[1] - 1 - torch.argmax(nonzero.flip(1), dim=1)
    return start, end


def hist_crop_counts(s: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """[B, 4096] int32 histogram counts of the samples selected by ``seg``,
    cropped to the bins the iterative integral can see: an integer
    ``scatter_add_``, exact. A sample outside the crop adds 0 to the bin of
    its low 12 bits rather than to an edge bin, so that the GPU's atomic
    adds of the many such samples do not all meet on one address."""
    bin_idx = s.to(torch.int32) + ((1 << 15) - _CROP_LO)
    in_crop = (bin_idx >= 0) & (bin_idx < _CROP_W) & seg
    idx = torch.where(in_crop, bin_idx, bin_idx & (_CROP_W - 1)).to(torch.int64)
    hist = torch.zeros(s.shape[0], _CROP_W, dtype=torch.int32, device=s.device)
    return hist.scatter_add_(1, idx, in_crop.to(torch.int32))


def integral_from_hist(hist: torch.Tensor, span: torch.Tensor, cfg: AnalysisConfig):
    """The iterative integral [B] float32 from a [B, 4096] float32 histogram
    and the trimmed span (end - start): the reference's 301 float32
    smoothing passes, then the windowed sum (sequential in float32 under
    ``strict_accumulation``, as C sums it)."""
    # 1/27 multiplies in float64 and the product is stored float32, as C's
    # `1./27. * (float sums)`; float32 configs multiply in float32
    mul = torch.float64 if cfg.dtype == "float64" else torch.float32
    inv27 = torch.tensor(1.0 / 27.0, dtype=mul, device=hist.device)
    h = hist.to(torch.float32).clone()
    for _ in range(C.N_SMOOTH_PASSES + 1):
        # left-to-right float32 adds, as the C expression associates
        acc = h[:, 0:-6] + 3.0 * h[:, 1:-5]
        acc = acc + 6.0 * h[:, 2:-4]
        acc = acc + 7.0 * h[:, 3:-3]
        acc = acc + 6.0 * h[:, 4:-2]
        acc = acc + 3.0 * h[:, 5:-1]
        acc = acc + h[:, 6:]
        h[:, 3:-3] = (acc.to(mul) * inv27).to(torch.float32)

    window = h[:, C.INTEGRAL_INF - _CROP_LO : C.INTEGRAL_SUP - _CROP_LO + 1]
    # per-bin normalize in float32 (C divides by the negative span and takes
    # fabs: the same for nonnegative counts)
    span = span.to(torch.float32)
    norm = torch.abs((window / span[:, None]).to(mul) * 100.0).to(torch.float32)
    if not cfg.strict_accumulation:
        return norm.sum(dim=1)
    # the sequential float32 sum of the 2001 bins, one add a bin: a
    # reduction kernel would round in another order
    total = torch.zeros(norm.shape[0], dtype=torch.float32, device=norm.device)
    for c in range(norm.shape[1]):
        total = total + norm[:, c]
    return total


def _weights(s: torch.Tensor, cfg: AnalysisConfig, tabs) -> torch.Tensor:
    """The amplitude weight of every sample of ``s`` [b, L] in the config's
    dtype: the table's gather or the Chebyshev fit."""
    dtype = cfg.torch_dtype
    if cfg.amplitude_mode == "table":
        idx = (s.to(torch.int32) + (1 << 15)).reshape(-1)
        return torch.index_select(tabs["amp_table"], 0, idx).view(s.shape)
    A, _, c_pos = tables.amplitude_cdf_poly()
    coeffs = [float(c) for c in c_pos]
    return cheb_T(1000.0 - torch.abs(s.to(dtype) + 1.0), coeffs, float(A))


def amplitude_scores(batch: PCMBatch, cfg: AnalysisConfig) -> torch.Tensor:
    """[B] amplitude scores (float32) on the batch's device, in
    ``cfg.amplitude_mode``."""
    if cfg.amplitude_mode not in ("table", "poly", "iterative"):
        raise ValueError(f"unknown amplitude_mode {cfg.amplitude_mode}")
    dtype = cfg.torch_dtype
    samples = batch.samples
    B, L = samples.shape
    tabs = device_tables(cfg.nb_bands, cfg.band_taps, cfg.filterbank, samples.device,
                         cfg.iir_block, dtype=dtype)
    idx = torch.arange(L, device=samples.device)
    integrals, hists, spans = [], [], []
    for b0, b1 in row_blocks(B, L):
        s = samples[b0:b1]
        start, end = trim_bounds(s)
        seg = (idx[None, :] >= start[:, None]) & (idx[None, :] <= end[:, None])
        spans.append(end - start)
        if cfg.amplitude_mode == "iterative":
            hists.append(hist_crop_counts(s, seg))
            continue
        dot = torch.sum(_weights(s, cfg, tabs) * seg.to(dtype), dim=1)
        span_d = spans[-1].to(dtype)
        # a true division: `100.0 / t` multiplies by t's reciprocal
        integrals.append(dot * (torch.full_like(span_d, 100.0) / span_d))
    span = torch.cat(spans)
    if cfg.amplitude_mode == "iterative":
        integral = integral_from_hist(torch.cat(hists), span, cfg)
    else:
        integral = torch.cat(integrals)
    # the final affine score in float32, as the reference computes it
    # (src/amplitude_sort.c:79)
    return C.AMPLITUDE_SCALE * integral.to(torch.float32) + C.AMPLITUDE_BIAS
