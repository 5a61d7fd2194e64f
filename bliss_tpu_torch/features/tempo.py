"""Tempo + attack envelope analyzer (counterpart of
``bliss_tpu/features/tempo.py``).

The XLA-path stage, ``band_energies`` (the configs that do not take the
CUDA kernels, and ``Song.envelope_analysis``): the interleaved s16 stream
normalized by its integer mean and variance (the reference divides by the
variance, not the std), 512-sample windows at hop 256, per window a causal
FIR with zero state at its start, then the window's summed power spectrum
(reference: src/tempo_atk_sort.c:42-152), in ``tempo_energy_mode``:
"parseval" (no window tensor: the global convolution, per-block sums and
the warm-up corrections of ``tables.fir_warmup_correction``, each energy
clamped at zero, F7),
"parseval_framed" (the explicit windows), "fft" and "fft_strict" (the
literal spectrum, the latter summed in the reference's float32 order).

The finish, from the per-band window energies fa [B, NB, NBF]: log-compress
(mu=100), upsample x2 with zero stuffing, 6th-order Butterworth low-pass,
half-wave-rectified differentiation, weighted envelope; attack = sum of the
envelope; two width-19 rectangular smoothings with the reference's edge
behavior, epsilon-peak count; tempo = 4*beats/duration - 30.4
(reference: src/tempo_atk_sort.c:163-284).

The reference computes that chain in C ``double`` and its eps=1e-6 peak
compare needs ~2^-27 relative precision, so the beat-exact finishes run it
in float64: ``envelope_finish_device`` on the tensor's device
(``tempo_finish="device_exact"``) and ``envelope_finish_host``, NumPy/SciPy
on the host (``"host"``), stage for stage alike. ``tempo_finish="device"``
runs the same device chain in the config's dtype with ``cfg.iir_mode``
(float32 may flip epsilon-marginal beats, as in the JAX package). The JAX
package's double-single emulation (``tempo_exact.py``, ``dsp/ddmath.py``)
exists only because the TPU lacks float64 and has no counterpart here.

The extended features' bpm and beat_loudness come from the same detection:
``beat_metrics`` from the device finish's ``return_aux``,
``beat_cols_from_host_aux`` from the host finish's.
"""

from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.dsp.boxfilter import box_sum_same
from bliss_tpu_torch.dsp.framing import frame_signal
from bliss_tpu_torch.dsp.iir import lfilter_blocked, lfilter_scan
from bliss_tpu_torch.features.types import PCMBatch, row_blocks
from bliss_tpu_torch.kernels import fused_stats as fs


def normalized(s, mean, var, dtype):
    """(s/2^15 - mean/2^15) / (var/2^30) of the int16 rows ``s`` [b, L] in
    ``dtype``, from each row's C mean and exact integer variance [b]
    (``fused_stats.moments``), the variance cast to ``dtype`` (reference
    :101-114)."""
    inv = 1.0 / (1 << 15)
    mean_d = mean.to(dtype) * inv
    var_d = var.to(dtype) * inv * inv
    return (s.to(dtype) * inv - mean_d[:, None]) / var_d[:, None]


def _normalize_signal(s, n, sums, dtype):
    """The zero-mean, divided-by-variance rows of ``s`` int16 [b, L] in
    ``dtype``, zero past each row's ``n``, from the prepass's exact int64
    sums: the C int32-wrapping mean and the exact integer variance
    (``fused_stats.moments``; the JAX package's float32 configs take a
    truncated float32 sum instead, F4)."""
    norm = normalized(s, *fs.moments(*sums, n), dtype)
    valid = torch.arange(s.shape[1], device=s.device)[None, :] < n[:, None]
    return torch.where(valid, norm, torch.zeros_like(norm))


def _fir(x, coeffs, K: int, length: int):
    """sum_m coeffs[m] * x[..., K - m : K - m + length]: the causal FIR of a
    signal with K samples of history in front, one shifted add a tap in the
    JAX function's order."""
    y = float(coeffs[0]) * x[..., K : K + length]
    for m in range(1, len(coeffs)):
        y = y + float(coeffs[m]) * x[..., K - m : K - m + length]
    return y


def _window_energy_blocked(xp, fb, tabs):
    """Per-window spectral energies [b, NB, NW] of the normalized rows
    ``xp`` [b, K + L], whose first K = taps - 1 samples are the history
    before the rows (zeros before a song's start), without the overlapped
    window tensor:

    - Parseval: sum_{k=0..W/2} |DFT(y)_k|^2 = (W/2)*sum(y^2)
      + ((sum y)^2 + (sum (-1)^t y)^2) / 2, no FFT;
    - the window-reset FIR equals the global causal convolution z except at
      each window's first taps-1 positions, where it differs by a small
      product of the preceding history (``tables.fir_warmup_correction``).

    So the stage is one convolution pass a band, per-block sums and small
    per-window corrections (``blocked_sums``, ``blocked_energies``)."""
    return blocked_energies(*blocked_sums(xp, fb, tabs))


def blocked_sums(xp, fb, tabs):
    """The pieces of ``_window_energy_blocked`` per 256-sample block of the
    rows ``xp`` [b, K + L]: (S, D), each [b, NB, NBF, 3] (NBF = L // 256),
    S the block's (sum z, sum z^2, sum (-1)^t z) of the global convolution
    z, D the warm-up correction's (sum delta, sum 2 z delta + delta^2,
    sum (-1)^t delta) over the block's first K samples."""
    hop = C.TEMPO_HOP
    K = fb.shape[1] - 1
    b, L = xp.shape[0], xp.shape[1] - K
    NBF = L // hop

    z = torch.stack([_fir(xp, fb[i], K, L) for i in range(fb.shape[0])], dim=1)  # [b, NB, L]

    alt = tabs["alt"][:hop]  # (-1)^t; blocks start at even offsets
    zb = z.view(b, -1, NBF, hop)
    S2 = torch.sum(zb * zb, dim=-1)
    S1 = torch.sum(zb, dim=-1)
    SA = torch.sum(zb * alt, dim=-1)

    # the K samples before each block, and the block's first K z values
    hist = xp[:, :L].reshape(b, NBF, hop)[:, :, :K]
    zh = zb[..., :K]
    # full precision: delta cancels z's history tail (TF32 off on the GPU)
    delta = torch.einsum("bwk,njk->bnwj", hist, tabs["warm"])
    d_s2 = torch.sum(2.0 * zh * delta + delta * delta, dim=-1)
    d_s1 = torch.sum(delta, dim=-1)
    d_sa = torch.sum(delta * alt[:K], dim=-1)
    return torch.stack([S1, S2, SA], dim=-1), torch.stack([d_s1, d_s2, d_sa], dim=-1)


def blocked_energies(S, D, S_next=None):
    """Window energies [b, NB, NW] from ``blocked_sums``: window w spans
    blocks w and w + 1 with its FIR reset at w's start, so its sums are
    S[w] + S[w + 1] + D[w]. Without ``S_next`` the rows' NW = NBF - 1
    windows; with it ([b, NB, 3], the sums of the block after the rows, as
    a sequence shard takes its right neighbour's first block) all NBF."""
    W = C.WINDOW_SIZE
    if S_next is None:
        S_here, S_after, D = S[:, :, :-1], S[:, :, 1:], D[:, :, :-1]
    else:
        S_here, S_after = S, torch.cat([S[:, :, 1:], S_next[:, :, None]], dim=2)
    sums = S_here + S_after + D
    sum_y, sum_y2, sum_a = sums.unbind(dim=-1)
    # a window's energy is a sum of squares: where the corrections cancel a
    # loud history's tail (a window just after a loud-to-silence edge) the
    # float32 rounding may leave it below zero, which the log compression
    # would turn into NaN (F7)
    return ((W / 2) * sum_y2 + (sum_y * sum_y + sum_a * sum_a) / 2.0).clamp_min(0.0)


def _fir_per_window(frames, coeffs):
    """Causal FIR of each window [..., W] with zero state at its start."""
    K = len(coeffs) - 1
    return _fir(F.pad(frames, (K, 0)), coeffs, K, frames.shape[-1])


def _window_energy(y, cfg: AnalysisConfig, tabs):
    """sum_{k=0..W/2} |DFT(y)_k|^2 of each window: [b, NW, W] -> [b, NW]."""
    dtype = cfg.torch_dtype
    mode = cfg.tempo_energy_mode
    if mode in ("parseval", "parseval_framed"):
        total = torch.sum(y * y, dim=-1)
        dc = torch.sum(y, dim=-1)
        nyq = torch.sum(y * tabs["alt"], dim=-1)
        return (C.WINDOW_SIZE / 2) * total + (dc * dc + nyq * nyq) / 2.0
    if mode == "fft_strict":
        # the reference's accumulator: a float32 running sum of float64 bin
        # powers, rounded to float32 after every add (`float sum_fft +=
        # double`, src/tempo_atk_sort.c:142-149), one add a bin
        X = torch.fft.rfft(y.to(torch.float64), dim=-1)
        abs2 = X.real * X.real + X.imag * X.imag  # [..., W/2 + 1] float64
        del X
        acc = torch.zeros(abs2.shape[:-1], dtype=torch.float32, device=y.device)
        for k in range(abs2.shape[-1]):
            acc = (acc.to(torch.float64) + abs2[..., k]).to(torch.float32)
        return acc.to(dtype)
    if mode != "fft":
        raise ValueError(f"unknown tempo_energy_mode {mode}")
    X = torch.fft.rfft(y, dim=-1)
    return torch.sum((X.real * X.real + X.imag * X.imag).to(dtype), dim=-1)


def window_energies(xp, cfg: AnalysisConfig, fb, tabs, history: bool = False) -> torch.Tensor:
    """Per-band window energies [b, NB, NW] in ``cfg.tempo_energy_mode`` of
    normalized rows (NW = L // 256 - 1 windows at hop 256 over L samples).
    ``xp`` is [b, L], rows that start a song, or with ``history`` [b, K +
    L]: the K = taps - 1 normalized samples before each row, then the row.
    Only "parseval" reads the history (its FIR runs across windows); the
    framed modes reset the FIR each window and read the row alone."""
    K = fb.shape[1] - 1
    if cfg.tempo_energy_mode == "parseval":
        return _window_energy_blocked(xp if history else F.pad(xp, (K, 0)), fb, tabs)
    frames = frame_signal(xp[:, K:] if history else xp, C.WINDOW_SIZE, C.TEMPO_HOP)  # a view
    return torch.stack([_window_energy(_fir_per_window(frames, fb[i]), cfg, tabs)
                        for i in range(fb.shape[0])], dim=1)


def band_energies(batch: PCMBatch, cfg: AnalysisConfig, sums=None) -> torch.Tensor:
    """The XLA-path stage's per-band window energies fa [B, NB, NBF] in the
    config's dtype on the batch's device (NBF = L // 256; per song, slots
    past its window count stay zero). ``sums``: the prepass's ``(sum s,
    sum s^2)`` when the caller has them. Runs a block of rows at a time
    (``types.row_blocks``, counting every band's copy of the signal), so
    that a float64 batch at L=2^23 fits."""
    dtype = cfg.torch_dtype
    W, hop = C.WINDOW_SIZE, C.TEMPO_HOP
    samples = batch.samples
    B, L = samples.shape
    n = batch.n_samples.to(torch.int64)
    if sums is None:
        sums = fs.prepass_sums(samples, batch.n_samples)
    fb = tables.bandpass_filterbank(cfg.nb_bands, cfg.band_taps, cfg.filterbank)
    tabs = device_tables(cfg.nb_bands, cfg.band_taps, cfg.filterbank, samples.device,
                         cfg.iir_block, dtype=dtype)
    out = []
    for b0, b1 in row_blocks(B, L * fb.shape[0]):
        norm = _normalize_signal(samples[b0:b1], n[b0:b1], (sums[0][b0:b1], sums[1][b0:b1]),
                                 dtype)
        out.append(window_energies(norm, cfg, fb, tabs))
        del norm
    energy = torch.cat(out)
    NW = energy.shape[-1]
    trunc_n = n - n % W
    n_windows = -torch.div(-(trunc_n - W), hop, rounding_mode="floor")  # ceil
    wmask = torch.arange(NW, device=energy.device)[None, :] < n_windows[:, None]
    energy = energy * wmask[:, None, :].to(dtype)
    # window energies land in nb_frames slots; the trailing slots stay zero
    # (the reference calloc's nb_frames entries, ~nb_frames - 2 windows run)
    return F.pad(energy, (0, L // hop - NW))


def envelope_energies(batch: PCMBatch, cfg: AnalysisConfig) -> torch.Tensor:
    """Single-band view of ``band_energies`` ([B, NBF])."""
    if cfg.nb_bands != 1:
        raise ValueError("envelope_energies is the single-band interface")
    return band_energies(batch, cfg)[:, 0]


def envelope_scores(batch: PCMBatch, cfg: AnalysisConfig):
    """([B] tempo, [B] attack) float32 of the XLA-path energies, finished as
    ``cfg.tempo_finish`` says: on the batch's device, or on the host in
    float64 for ``"host"`` (the JAX function runs its working-dtype chain
    there; the host finish is the port's beat-exact one)."""
    fa = band_energies(batch, cfg)
    if cfg.tempo_finish != "host":
        return envelope_finish_device(fa, batch.n_samples, batch.durations, cfg)
    tempo, attack = envelope_finish_host(
        fa.cpu().numpy(), batch.n_samples.cpu().numpy(), batch.durations.cpu().numpy()
    )
    dev = batch.samples.device
    return torch.from_numpy(tempo).to(dev), torch.from_numpy(attack).to(dev)


def _finish_dtype(cfg: AnalysisConfig) -> torch.dtype:
    """float64 for the beat-exact finish, the config's dtype for "device"."""
    return cfg.torch_dtype if cfg.tempo_finish == "device" else torch.float64


def _envelope_pipeline(fa, n, cfg: AnalysisConfig):
    """Band energies -> weighted envelope, in float64 (``"device_exact"``)
    or in the config's dtype with ``cfg.iir_mode`` (``"device"``).

    Returns (wa [B, NB, 2*NBF], wa_edges, ss_src, last_excluded, j, n2)."""
    dtype = _finish_dtype(cfg)
    fa = fa.to(dtype)
    B, NB, NBF = fa.shape
    n = n.to(torch.int64)
    nbf = torch.div(n - n % C.WINDOW_SIZE, C.TEMPO_HOP, rounding_mode="floor")

    comp = torch.log(1.0 + C.MU * fa) / math.log(1.0 + C.MU)
    u = torch.stack([comp, torch.zeros_like(comp)], dim=-1).reshape(B, NB, 2 * NBF)
    iir_mode = cfg.iir_mode if cfg.tempo_finish == "device" else "blocked"
    if iir_mode == "scan":
        lp = lfilter_scan(C.BUTTER_B, C.BUTTER_A, u)
    elif iir_mode == "blocked":
        tabs = device_tables(cfg.nb_bands, cfg.band_taps, cfg.filterbank, fa.device,
                             cfg.iir_block, dtype=dtype)
        lp = lfilter_blocked(u, (tabs["iir_L"], tabs["iir_Z"], tabs["iir_M"], tabs["iir_N"]))
    else:
        raise ValueError(f"unknown iir_mode {iir_mode}")

    diff = torch.cat(
        [lp[..., :1], torch.clamp_min(lp[..., 1:] - lp[..., :-1], 0.0)], dim=-1
    )
    wa = C.ENV_LP_WEIGHT * lp + C.ENV_DIFF_WEIGHT * diff / 10.0  # [B, NB, 2*NBF]

    n2 = 2 * nbf  # per-song envelope length
    j = torch.arange(2 * NBF, device=fa.device)[None, :]
    last_excluded = j <= (n2 - 2)[:, None]  # sum runs to 2*nb_frames - 2

    # The band-summed envelope is smoothed; the reference's pass-1 output
    # buffer is band 0's envelope, whose stale values survive at the edge
    # slots (reference: src/tempo_atk_sort.c:267-270, for any band count).
    wa_edges = wa[:, 0]
    ss_src = torch.sum(wa, dim=1)
    return wa, wa_edges, ss_src, last_excluded, j, n2


def _count_beats(ss_src, wa, last_excluded, j, n2, return_aux=False):
    """Two rectangular filters + epsilon peak count (reference :258-280).

    ss_src: band-summed envelope; wa: the buffer whose stale values the
    reference's in-place pass 1 leaves at the edges. Returns int64 [B];
    with ``return_aux`` also (r2 smoothed envelope, peak mask over
    r2[:, 1:-1], mid-valid mask) for the extended beat columns."""
    width = C.RECT_FILTER_WIDTH
    n2c = n2[:, None]

    ss = ss_src * last_excluded  # the envelope with its final slot zeroed
    box1 = box_sum_same(ss, width)
    # Pass 1 writes box sums into slots half-1..n-half-1 of the envelope
    # buffer itself; slot n-half accumulates the tail sum on top of the
    # stale envelope value; the other edge slots keep stale envelope values.
    half = width // 2  # 9; the reference's half_smooth_w is 10
    edge = (j <= half - 1) | (j >= n2c - half)
    r1 = torch.where(edge, wa, torch.where(j == n2c - half - 1, wa + box1, box1))
    r1 = r1 / width

    box2 = box_sum_same(r1, width)
    # Pass 2 runs on a zeroed output buffer: only slots 9..n-10 get values.
    mid = (j >= half) & (j <= n2c - half - 1)
    r2 = torch.where(mid, box2 / width, torch.zeros_like(box2))

    d_prev = r2[:, 1:-1] - r2[:, :-2]
    d_next = r2[:, 1:-1] - r2[:, 2:]
    inrange = j[:, 1:-1] <= (n2 - 2)[:, None]
    peaks = (d_prev > C.PEAK_EPSILON) & (d_next > C.PEAK_EPSILON) & inrange
    beat = torch.sum(peaks, dim=1)
    if return_aux:
        return beat, (r2, peaks, mid)
    return beat


def envelope_finish_device(fa, n, durations, cfg: AnalysisConfig, return_aux: bool = False):
    """fa [B, NB, NBF] band energies, n/durations [B] -> ([B] tempo,
    [B] attack) float32 on fa's device: computed in float64 for
    ``tempo_finish="device_exact"``, in the config's dtype with
    ``cfg.iir_mode`` for ``"device"`` (a kernel config's float64 energies
    enter it cast to float32, as the JAX package's float32 energies do).

    With ``return_aux`` also returns ``(beat, r2, peaks, mid)``: the beat
    count, the smoothed envelope, the peak mask padded to r2's full length
    and the valid-range mask, from the same detection that gave the tempo
    (``bliss_tpu/features/tempo.py:247-254``), for ``beat_metrics``."""
    if cfg.tempo_finish == "host":
        raise NotImplementedError(
            "tempo_finish='host' does not finish on the device: envelope_finish_host"
        )
    dtype = _finish_dtype(cfg)
    wa, wa_edges, ss_src, last_excluded, j, n2 = _envelope_pipeline(fa, n, cfg)
    atk_sum = torch.sum(wa * last_excluded[:, None, :].to(dtype), dim=(1, 2))
    beat, (r2, peaks, mid) = _count_beats(
        ss_src, wa_edges, last_excluded, j, n2, return_aux=True
    )
    # duration <= 0 gives an inf/nan tempo: the reference's own behavior
    tempo = C.TEMPO_SCALE * beat.to(dtype) / durations.to(dtype) + C.TEMPO_BIAS
    attack = C.ATTACK_SCALE * atk_sum / n.to(dtype) + C.ATTACK_BIAS
    if return_aux:
        # peaks cover r2[:, 1:-1]: pad them to r2's length, one aux layout
        aux = (beat, r2, F.pad(peaks, (1, 1)), mid)
        return tempo.to(torch.float32), attack.to(torch.float32), aux
    return tempo.to(torch.float32), attack.to(torch.float32)


def beat_metrics(fa, n, durations, cfg: AnalysisConfig, aux=None):
    """The extended beat columns ([B] bpm, [B] beat_loudness) float32, from
    band energies fa [B, NB, NBF], computed in float64 on fa's device.

    bpm: the detected beats per minute, from the same epsilon-peak detector
    the tempo score counts. beat_loudness: the mean smoothed envelope at the
    detected beats over its mean across the valid range (>1: beats stand
    out; ~1: a flat envelope).

    ``aux``: ``(beat, r2, peaks, mid)`` of ``envelope_finish_device(...,
    return_aux=True)``, so that core and extended columns come from one
    envelope chain and bpm · duration / 60 is the core's beat count in every
    row; without it the same finish runs here."""
    if aux is None:
        if cfg.tempo_finish == "host":
            # the host finish's float64 chain is the device finish's
            cfg = dataclasses.replace(cfg, tempo_finish="device_exact")
        _, _, aux = envelope_finish_device(fa, n, durations, cfg, return_aux=True)
    beat, r2, peaks, mid = aux
    dur = durations.to(torch.float64)
    bpm = 60.0 * beat.to(torch.float64) / dur
    # duration <= 0: the core tempo stays inf (the reference's behavior),
    # but the extended column reports 0, as a negative duration does
    bpm = torch.where(torch.isfinite(bpm) & (dur > 0), bpm, torch.zeros_like(bpm))
    zero = torch.zeros_like(r2)
    peak_mean = torch.where(peaks, r2, zero).sum(dim=1) / peaks.sum(dim=1).clamp(min=1)
    env_mean = torch.where(mid, r2, zero).sum(dim=1) / mid.sum(dim=1).clamp(min=1)
    loud = peak_mean / torch.maximum(env_mean, torch.full_like(env_mean, 1e-12))
    # a silent song (NaN envelope) reports 0, as its beat count is 0
    loud = torch.where(torch.isfinite(loud), loud, torch.zeros_like(loud))
    return bpm.to(torch.float32), loud.to(torch.float32)


def _box_sum_host(x, width):
    """Centered zero-padded box sums along the last axis, vectorized over
    leading axes. scipy.ndimage's C moving average; its float64 running-sum
    drift is ~2e-14 relative, eight orders below the 1e-6 epsilon the peak
    detector compares at."""
    from scipy.ndimage import uniform_filter1d

    return uniform_filter1d(x, size=width, axis=-1, mode="constant", cval=0.0) * width


def envelope_finish_host(
    fa, n_samples, durations, workers: int | None = None, return_aux=False
):
    """Host float64 finish of the tempo path: fa [B, NBF] (or [B, NB, NBF]
    multi-band) NumPy energies, n_samples/durations [B] -> ([B] tempo,
    [B] attack) float32 NumPy arrays; with ``return_aux`` also
    (r2, peaks, mid), the smoothed envelope, the peak mask over r2[:, 1:-1]
    and the valid-range mask.

    Rows are independent, so the batch splits across a thread pool (NumPy
    and SciPy release the GIL on the large operations); the results are
    bitwise identical to ``workers=1``. ``workers=None`` takes
    min(8, os.cpu_count())."""
    from scipy.signal import lfilter

    fa = np.asarray(fa, np.float64)
    if fa.ndim == 2:
        fa = fa[:, None, :]
    n = np.asarray(n_samples, np.int64)
    dur = np.asarray(durations, np.float64)
    B, NB, NBF = fa.shape

    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    if workers > 1 and B >= 2 * workers:
        bounds = np.linspace(0, B, workers + 1, dtype=int)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            parts = list(
                pool.map(
                    lambda se: envelope_finish_host(
                        fa[se[0] : se[1]], n[se[0] : se[1]], dur[se[0] : se[1]],
                        workers=1, return_aux=return_aux,
                    ),
                    zip(bounds[:-1], bounds[1:]),
                )
            )
        tempo = np.concatenate([p[0] for p in parts])
        attack = np.concatenate([p[1] for p in parts])
        if return_aux:
            # every chunk's aux is batch-leading with the same width (NBF
            # is shared), so concatenation equals the single-thread aux
            aux = tuple(np.concatenate([p[2][i] for p in parts]) for i in range(3))
            return tempo, attack, aux
        return tempo, attack
    nbf = (n - n % C.WINDOW_SIZE) // C.TEMPO_HOP
    n2 = 2 * nbf  # [B]

    u = np.zeros((B, NB, 2 * NBF))
    u[..., 0::2] = np.log(1.0 + C.MU * fa) / np.log(1.0 + C.MU)
    lp = lfilter(C.BUTTER_B, C.BUTTER_A, u, axis=-1)
    diff = np.concatenate(
        [lp[..., :1], np.maximum(lp[..., 1:] - lp[..., :-1], 0.0)], axis=-1
    )
    wa = C.ENV_LP_WEIGHT * lp + C.ENV_DIFF_WEIGHT * diff / 10.0  # [B, NB, 2NBF]

    j = np.arange(2 * NBF)[None, :]
    last_excluded = j <= (n2 - 2)[:, None]
    atk_sum = np.sum(wa * last_excluded[:, None, :], axis=(1, 2))

    # Band-summed envelope; the pass-1 edge slots keep the stale values of
    # the output buffer, band 0's envelope for any band count (reference:
    # src/tempo_atk_sort.c:267-270 smooths into weighted_average[0]).
    wa_edges = wa[:, 0]
    ss = np.sum(wa, axis=1) * last_excluded
    width = C.RECT_FILTER_WIDTH
    half = width // 2
    box1 = _box_sum_host(ss, width)
    n2c = n2[:, None]
    edge = (j <= half - 1) | (j >= n2c - half)
    r1 = np.where(edge, wa_edges, np.where(j == n2c - half - 1, wa_edges + box1, box1))
    r1 = r1 / width
    box2 = _box_sum_host(r1, width)
    mid = (j >= half) & (j <= n2c - half - 1)
    r2 = np.where(mid, box2 / width, 0.0)

    d_prev = r2[:, 1:-1] - r2[:, :-2]
    d_next = r2[:, 1:-1] - r2[:, 2:]
    inrange = j[:, 1:-1] <= (n2 - 2)[:, None]
    peaks = (d_prev > C.PEAK_EPSILON) & (d_next > C.PEAK_EPSILON) & inrange
    beat = np.sum(peaks, axis=1)

    with np.errstate(divide="ignore", invalid="ignore"):
        # duration <= 0 gives an inf/nan tempo: the reference's own behavior
        tempo = C.TEMPO_SCALE * beat / dur + C.TEMPO_BIAS
        attack = C.ATTACK_SCALE * atk_sum / n + C.ATTACK_BIAS
    if return_aux:
        return tempo.astype(np.float32), attack.astype(np.float32), (r2, peaks, mid)
    return tempo.astype(np.float32), attack.astype(np.float32)


def beat_cols_from_host_aux(aux, durations):
    """([B] bpm, [B] beat_loudness) float32 NumPy from
    ``envelope_finish_host``'s ``return_aux`` triple ``(r2, peaks, mid)``
    (peaks over r2[:, 1:-1]): the float64 host counterpart of
    ``beat_metrics(aux=...)``. The hybrid and streamed host finishes take
    the extended beat columns from the same detection as the tempo."""
    r2, peaks, mid = aux
    dur = np.asarray(durations, np.float64)
    beat = np.count_nonzero(peaks, axis=1)
    bpm = 60.0 * beat / np.where(dur > 0, dur, np.inf)
    # masked sums without a masked copy of the [B, 2 NBF] envelope
    peak_mean = np.sum(r2[:, 1:-1], axis=1, where=peaks) / np.maximum(beat, 1.0)
    env_mean = np.sum(r2, axis=1, where=mid) / np.maximum(np.count_nonzero(mid, axis=1), 1.0)
    loud = peak_mean / np.maximum(env_mean, 1e-12)
    loud = np.where(np.isfinite(loud), loud, 0.0)
    bpm = np.where(np.isfinite(bpm), bpm, 0.0)
    return bpm.astype(np.float32), loud.astype(np.float32)


def beat_metrics_host(fa, n_samples, durations):
    """``beat_metrics`` on the host in float64: [B, NBF] or [B, NB, NBF]
    NumPy energies -> ([B] bpm, [B] beat_loudness) float32, through
    ``envelope_finish_host``'s chain."""
    _, _, aux = envelope_finish_host(fa, n_samples, durations, workers=1, return_aux=True)
    return beat_cols_from_host_aux(aux, durations)
