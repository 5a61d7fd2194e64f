"""Frequency-balance analyzer on the XLA path (counterpart of
``bliss_tpu/features/frequency.py``).

Behavioral model (reference: src/frequency_sort.c:20-140): non-overlapping
512-sample windows per channel, stereo downmixed by C-truncated integer
average, Hann-windowed, 512-point real DFT, power accumulated across all
windows, converted to peak-relative dB with -3 dB attenuation, then averaged
over 5 fixed bands (``kernels/stft.frequency_scores_from_power``, shared
with the kernels' path).

The summed power spectrum comes from a dense real DFT (``spectrum_mode=
"matmul"``: the zero-Nyquist table of ``tables.rdft_matrices``, two
``torch.matmul`` in the config's dtype, TF32 off on the GPU) or from
``torch.fft.rfft`` (``"fft"``, the Nyquist bin zeroed after). Under
``strict_accumulation`` the per-frame float32 powers add up one frame at a
time in float32, as the reference's `power_spectrum[d] += re*re + im*im`.
It runs on the batch's device, a block of rows at a time.
"""

from __future__ import annotations

import torch

from bliss_tpu_torch import constants as C
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.features.types import PCMBatch, row_blocks
from bliss_tpu_torch.kernels.stft import frequency_scores_from_power, frame_counts, mono_frames


def _frame_spectra(s: torch.Tensor, n_frames: torch.Tensor, cfg: AnalysisConfig, tabs):
    """(re, im) [b, F, 257] of the Hann-windowed mono frames of the rows
    ``s`` [b, L] in the config's dtype, frames past a row's ``n_frames``
    zero, the Nyquist bin zero."""
    # frames past each song's count are zero, so they add zero power, as
    # the reference's n_frames loop bound
    x = mono_frames(s, n_frames, dtype=cfg.torch_dtype) * tabs["hann"]
    if cfg.spectrum_mode == "matmul":
        return x @ tabs["rdft_re"], x @ tabs["rdft_im"]
    X = torch.fft.rfft(x, dim=-1)
    # the reference never accumulates the Nyquist bin (av_rdft packing,
    # src/frequency_sort.c:86-93)
    re, im = X.real.clone(), X.imag.clone()
    re[..., -1] = 0.0
    im[..., -1] = 0.0
    return re, im


def power_spectrum(batch: PCMBatch, cfg: AnalysisConfig) -> torch.Tensor:
    """[B, 257] the sum over each song's frames of |DFT(frame)|^2, in the
    config's dtype."""
    if cfg.spectrum_mode not in ("matmul", "fft"):
        raise ValueError(f"unknown spectrum_mode {cfg.spectrum_mode}")
    dtype = cfg.torch_dtype
    samples = batch.samples
    B, L = samples.shape
    F = L // (C.WINDOW_SIZE * C.CHANNELS)
    tabs = device_tables(cfg.nb_bands, cfg.band_taps, cfg.filterbank, samples.device,
                         cfg.iir_block, dtype=dtype)
    n_frames = frame_counts(batch.n_samples)
    if cfg.strict_accumulation:
        raw = torch.empty(B, F, C.WINDOW_SIZE // 2 + 1, dtype=torch.float32,
                          device=samples.device)
    else:
        power = []
    for b0, b1 in row_blocks(B, L):
        re, im = _frame_spectra(samples[b0:b1], n_frames[b0:b1], cfg, tabs)
        if cfg.strict_accumulation:
            re32, im32 = re.to(torch.float32), im.to(torch.float32)
            raw[b0:b1] = re32 * re32 + im32 * im32  # float32, as in C
        else:
            power.append(torch.sum((re * re + im * im).to(dtype), dim=1))
        del re, im
    if not cfg.strict_accumulation:
        return torch.cat(power)
    # a float32 running sum over the frames, rounding after every add: a
    # loop over frames, since a reduction or cumsum kernel rounds in
    # another order
    total = torch.zeros(B, raw.shape[2], dtype=torch.float32, device=samples.device)
    for f in range(F):
        total = total + raw[:, f]
    return total.to(dtype)


def frequency_scores(batch: PCMBatch, cfg: AnalysisConfig) -> torch.Tensor:
    """[B] frequency scores (float32) on the batch's device, in
    ``cfg.spectrum_mode``."""
    return frequency_scores_from_power(power_spectrum(batch, cfg), cfg)
