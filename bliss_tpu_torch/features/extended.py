"""Extended timbral, loudness and beat features (counterpart of
``bliss_tpu/features/extended.py``): 45 columns a song after the 4 force
columns, in ``EXTENDED_FEATURE_NAMES`` order.

- zero-crossing rate of the C-truncated mono downmix, per mono sample pair;
- loudness, the RMS in dBFS: from the exact int64 sum of s^2 over each
  song's valid samples that ``prepass_kernel`` (``kernels/csrc/prepass.cuh``)
  already forms for the tempo normalization, so the stage makes no pass of
  its own over the batch for it (the JAX module sums float32 squares);
- spectral centroid, 95 % rolloff and flatness, energy-weighted over the
  frames, and the chroma of the summed spectrum: from the per-frame Hann
  power spectra of the mono, every bin to Nyquist included. K1's and K3's
  spectrum zeroes the Nyquist bin and sums over the frames, so it is not
  reused;
- MFCC (mel filterbank, log, orthonormal DCT-II) mean and standard
  deviation over the song's frames;
- bpm and beat_loudness from the core's own envelope finish
  (``tempo.beat_metrics``), so that bpm · duration / 60 is the core's beat
  count in every row.

``partials`` reduces the int16 PCM straight to per-song float64 sums (the
summed spectrum, float32 within a block; the rolloff and flatness
numerators; the MFCC sum and sum of squares; the zero-crossing count) in
blocks of at most ``BLOCK_SAMPLES`` samples, of whole songs or of a long
song's columns, so that the stage's temporaries stay under 0.5 GiB
whatever the batch (0.485 GiB at B=64, L=2^23 on the H100);
``finish`` turns the sums into the columns. The batch path
(``extended_features``) and the streamed path (``features/streaming.py``,
which sums a long song's rows) share both.

The JAX module's per-frame DFT, mel, DCT and chroma products are XLA
matmuls outside any Pallas kernel, so the stage has no hand-written kernel
either: each frame's spectrum is ``torch.fft.rfft`` (the same power
spectrum as the dense real DFT, from a 512-point FFT: on the H100, cuFFT
takes 0.77 ms for the frames of a B=64, L=2^23 batch where the float32
product takes 5.6 ms, ``chip_smoke.py`` phase 3's yardsticks), and the
mel, DCT and chroma products ``torch.matmul`` in full float32 (TF32 off),
on the batch's device.
``dtype=torch.float64`` runs the same per-frame stage in float64, the
yardstick of the float32 one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.convert import extended_tables
from bliss_tpu_torch.features.tempo import beat_metrics
from bliss_tpu_torch.features.types import EXTENDED_FEATURE_NAMES, PCMBatch
from bliss_tpu_torch.kernels import fused_stats as fs
from bliss_tpu_torch.kernels import stft

__all__ = ["EXTENDED_FEATURE_NAMES", "EXTENDED_GATES", "extended_features"]

N_MELS = 40
N_MFCC = 13
N_CHROMA = 12
NB = C.WINDOW_SIZE // 2 + 1  # 257 bins, Nyquist included
FRAME = stft.FRAME  # 1024 interleaved samples a frame
BLOCK_SAMPLES = 1 << 26  # samples of PCM the per-frame stage takes at once

# The gates of the JAX package's extended differential fuzz
# (scripts/fuzz_differential.py:199-210), |float32 - float64| per column
# group: (name, first column, end column, gate). The beat gate applies to
# bpm · duration / 60, in beats.
EXTENDED_GATES = (
    ("zero_crossing_rate", 0, 1, 1e-5),
    ("loudness_db", 1, 2, 5e-3),
    ("spectral_centroid_hz", 2, 3, 2.0),
    ("spectral_rolloff_hz", 3, 4, 25.0),
    ("spectral_flatness", 4, 5, 1e-3),
    ("beats (bpm*dur/60)", 5, 6, 0.02),
    ("beat_loudness", 6, 7, 1e-2),
    ("mfcc", 7, 20, 2e-3),
    ("mfcc_std", 20, 33, 2e-3),
    ("chroma", 33, 45, 1e-4),
)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_mels: int = N_MELS) -> np.ndarray:
    """[n_bins, n_mels] triangular mel filterbank (HTK mel scale)."""
    n_bins = C.WINDOW_SIZE // 2 + 1
    f_max = C.SAMPLE_RATE / 2.0

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(f_max), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bin_hz = np.arange(n_bins) * C.SAMPLE_RATE / C.WINDOW_SIZE
    fb = np.zeros((n_bins, n_mels))
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_hz - lo) / max(ctr - lo, 1e-9)
        down = (hi - bin_hz) / max(hi - ctr, 1e-9)
        fb[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


@functools.lru_cache(maxsize=None)
def chroma_matrix() -> np.ndarray:
    """[n_bins, 12] hard pitch-class assignment matrix (A440 tuning,
    column 0 = C)."""
    n_bins = C.WINDOW_SIZE // 2 + 1
    f = np.arange(n_bins) * C.SAMPLE_RATE / C.WINDOW_SIZE
    M = np.zeros((n_bins, N_CHROMA))
    for k in range(1, n_bins):
        pc = (int(round(12.0 * np.log2(f[k] / 440.0))) + 9) % 12
        M[k, pc] = 1.0
    return M


@functools.lru_cache(maxsize=None)
def dct_ii_matrix(n_in: int = N_MELS, n_out: int = N_MFCC) -> np.ndarray:
    """[n_in, n_out] orthonormal DCT-II."""
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[:, 0] *= 1.0 / np.sqrt(2.0)
    return mat


def reference_arrays() -> dict[str, np.ndarray]:
    """The stage's NumPy tables, float64, keyed as ``convert.extended_tables``
    gives them on a device: the Hann window, the bins' Hz, the mel
    filterbank, the DCT-II and the chroma matrix."""
    return {
        "hann": tables.hann_window(),
        "bin_hz": np.arange(NB) * C.SAMPLE_RATE / C.WINDOW_SIZE,
        "mel": mel_filterbank(),
        "dct": dct_ii_matrix(),
        "chroma": chroma_matrix(),
    }


class Partials(NamedTuple):
    """Per-song sums of the per-frame stage, float64 (``flips`` int64):
    ``spec`` [B, 257] the summed power spectrum of the counted frames;
    ``roll`` and ``flat`` [B] the frame-energy-weighted sums of the 95 %
    rolloff (Hz) and the flatness; ``mfcc`` and ``mfcc_sq`` [B, 13] the sum
    and sum of squares of the counted frames' MFCCs; ``flips`` [B] the
    sign changes between consecutive counted mono samples."""

    spec: torch.Tensor
    roll: torch.Tensor
    flat: torch.Tensor
    mfcc: torch.Tensor
    mfcc_sq: torch.Tensor
    flips: torch.Tensor

    def total(self) -> "Partials":
        """The sums over all rows, as one row [1, ...]: a streamed song's
        rows add up to the song."""
        return Partials(*(t.sum(dim=0, keepdim=True) for t in self))


def _block(x, c0, c1, n_frames, n_mono, tabs, dtype) -> Partials:
    """``Partials`` of columns [c0, c1) of the rows ``x`` int16 [b, W]: the
    frames c0/1024 .. c1/1024 - 1 that count (global frame < n_frames) and
    the mono pairs (m - 1, m) with c0/2 <= m < c1/2, 1 <= m < n_mono."""
    b = x.shape[0]
    lo = max(c0 - 2, 0)  # one stereo pair before the block: the first pair
    seg = x[:, lo:c1]
    # the C-truncated mono c_div(l + r, 2), exact in float32
    mono = seg[:, 0::2].to(dtype)
    mono += seg[:, 1::2]
    torch.div(mono, 2, rounding_mode="trunc", out=mono)
    nonneg = mono >= 0  # -0.0 (l + r = -1) counts as >= 0, as C's 0 does
    m = lo // 2 + 1 + torch.arange(nonneg.shape[1] - 1, device=x.device, dtype=torch.int32)
    counted = m[None, :] < n_mono[:, None]
    flips = ((nonneg[:, 1:] != nonneg[:, :-1]) & counted).sum(dim=1)
    del nonneg, counted, m

    nf = (c1 - c0) // FRAME
    frames = mono[:, (c0 - lo) // 2 :].contiguous().view(b * nf, C.WINDOW_SIZE)
    del mono
    spectra = torch.fft.rfft(frames.mul_(tabs["hann"]), dim=1)  # [b * nf, 257]
    del frames
    power = spectra.real * spectra.real
    power.addcmul_(spectra.imag, spectra.imag)
    del spectra
    # a frame that does not count has zero power, as the FFT of zeros
    fmask = (c0 // FRAME + torch.arange(nf, device=x.device))[None, :] < n_frames[:, None]
    power.view(b, nf, NB).mul_(fmask[..., None].to(dtype))
    fe = power.sum(dim=1)  # frame energies [b * nf]
    spec = power.view(b, nf, NB).sum(dim=1).to(torch.float64)

    # 95 % rolloff: the first bin whose cumulative power reaches 0.95 of
    # the frame's energy (bin 0 where none does, as argmax of all-False)
    reached = torch.cumsum(power, dim=1) >= (0.95 * fe.clamp(min=1e-12))[:, None]
    roll_hz = tabs["bin_hz"][torch.argmax(reached.to(torch.uint8), dim=1)]
    del reached
    roll = (roll_hz * fe).view(b, nf).sum(dim=1, dtype=torch.float64)

    # flatness: geometric over arithmetic mean of each frame's bins
    eps = 1e-12
    log_gm = torch.log(power + eps).sum(dim=1) / NB
    flat_f = torch.exp(log_gm) / (fe / NB).clamp(min=1e-12)
    flat = (flat_f * fe).view(b, nf).sum(dim=1, dtype=torch.float64)

    # MFCC: mel matmul -> log -> DCT-II, summed over the counted frames
    mfcc = torch.log(power @ tabs["mel"] + eps) @ tabs["dct"]
    del power
    mfcc = (mfcc.view(b, nf, N_MFCC) * fmask[..., None].to(dtype)).to(torch.float64)
    return Partials(spec, roll, flat, mfcc.sum(dim=1), (mfcc * mfcc).sum(dim=1), flips)


def partials(samples, n_frames, n_mono, dtype=torch.float32) -> Partials:
    """``Partials`` of int16 rows ``samples`` [B, W] (W a multiple of 1024)
    counting each row's frames f < ``n_frames`` [B] and its mono pairs
    (m - 1, m), 1 <= m < ``n_mono`` [B]; the per-frame stage in ``dtype``.
    Runs on the rows' device, ``BLOCK_SAMPLES`` samples at a time: whole
    rows, or columns of a row longer than that."""
    B, W = samples.shape
    if samples.dtype != torch.int16 or W % FRAME:
        raise ValueError(f"samples must be int16 [B, W], W a multiple of {FRAME}")
    tabs = extended_tables(samples.device, dtype)
    rows = max(1, BLOCK_SAMPLES // W)
    cols = min(W, BLOCK_SAMPLES)
    n_frames = n_frames.to(torch.int64)
    n_mono = n_mono.to(torch.int64)
    out = []
    for b0 in range(0, B, rows):
        b1 = min(B, b0 + rows)
        parts = [
            _block(samples[b0:b1], c0, min(W, c0 + cols), n_frames[b0:b1], n_mono[b0:b1],
                   tabs, dtype)
            for c0 in range(0, W, cols)
        ]
        out.append(Partials(*(sum(ts) for ts in zip(*parts))))
    return Partials(*(torch.cat(ts) for ts in zip(*out)))


def finish(p: Partials, n_samples, sum_s2, bpm, loud) -> torch.Tensor:
    """[B, 45] float32 columns of songs of ``n_samples`` samples from their
    ``Partials``, the exact int64 sums of s^2 over their valid samples and
    their beat columns."""
    f64 = torch.float64
    tabs = extended_tables(p.spec.device, f64)
    n = n_samples.to(torch.int64)
    rms = torch.sqrt(sum_s2.to(f64) / float(1 << 30) / n.clamp(min=1).to(f64))
    loudness_db = 20.0 * torch.log10(rms.clamp(min=1e-10))
    zcr = p.flips.to(f64) / (torch.div(n, C.CHANNELS, rounding_mode="floor") - 1).clamp(min=1)

    total = p.spec.sum(dim=1).clamp(min=1e-12)
    centroid = (p.spec @ tabs["bin_hz"]) / total
    cnt = torch.div(n, FRAME, rounding_mode="floor").clamp(min=1).to(f64)[:, None]
    mean = p.mfcc / cnt
    std = torch.sqrt((p.mfcc_sq / cnt - mean * mean).clamp(min=0.0))
    chroma = p.spec @ tabs["chroma"]
    chroma = chroma / chroma.sum(dim=1, keepdim=True).clamp(min=1e-12)
    cols = [zcr, loudness_db, centroid, p.roll / total, p.flat / total,
            bpm.to(f64), loud.to(f64)]
    out = torch.cat([torch.stack(cols, dim=1), mean, std, chroma], dim=1)
    return out.to(torch.float32)


def extended_features(
    batch: PCMBatch,
    cfg: AnalysisConfig,
    fa: torch.Tensor | None = None,
    beat_aux=None,
    *,
    sums=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """[B, 45] float32 extended features of ``batch`` on its device.

    ``fa``: the core pass's band energies [B, NB, NBF]; ``beat_aux``: the
    core finish's ``(beat, r2, peaks, mid)`` (``envelope_finish_device(...,
    return_aux=True)``), so that bpm and beat_loudness come from the core's
    own detection; ``"skip"`` gives zero beat columns, for the host finish
    that writes them from its float64 aux. ``sums``: the prepass's
    ``(sum s, sum s^2)``. What is not given is computed here: the energies
    through the config's device stage (K1, or K2 and K3), the sums through
    the prepass. ``dtype``: the per-frame stage's."""
    n = batch.n_samples
    if sums is None:
        sums = fs.prepass_sums(batch.samples, n)
    if isinstance(beat_aux, str) and beat_aux == "skip":
        bpm = loud = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    else:
        if beat_aux is None and fa is None:
            from bliss_tpu_torch.features.analyze import _device_stage  # imports this module

            fa = _device_stage(batch, cfg)[2]
        bpm, loud = beat_metrics(fa, n, batch.durations, cfg, aux=beat_aux)
    p = partials(batch.samples, stft.frame_counts(n),
                 torch.div(n, C.CHANNELS, rounding_mode="floor"), dtype)
    return finish(p, n, sums[1], bpm, loud)
