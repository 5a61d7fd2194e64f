"""Long songs streamed in rows (counterpart of
``bliss_tpu/features/streaming.py``).

The JAX module streams a song chunk by chunk so that XLA compiles one chunk
shape for every length. The port compiles nothing at run time, so it folds
the song into rows that the device stage takes as one batch, and the cost
of a song grows with its own length instead of with its bucket's. Every
config streams (``streaming_supports``): one that takes the kernels
(``config.uses_kernels``) through the prepass and K1 or K2 + K3, every
other through the XLA-path stage's own functions.

1. **Fold.** The song is copied to the device once, zero-padded to R·CH +
   1024 samples (CH = ``chunk_samples``, R = ceil(n / CH)). Row r is its
   samples r·CH .. r·CH + CH + 1024: the chunk's payload and a one-frame
   lookahead, which serves the window that starts in the chunk's last hop
   and ends in the next chunk (1024 keeps the row a multiple of K1's
   frame; the JAX module's lookahead is one hop). A row counts its payload
   only: ``n_row = clamp(n - r·CH, 0, CH)`` samples and ``n_row // 1024``
   spectrum frames, which sum to the song's ``n // 1024``. The kernels'
   rows take ``halo0`` [R, K] (K = taps - 1), the K raw samples before each
   row, so that the causal FIR of every row continues the song's; the
   XLA-path rows start K samples earlier instead, the song having K zeros
   before it.
2. **Pass 1.** ``fused_stats.prepass_sums`` over the padded song as one row
   gives the exact int64 sums of s and s^2, and from them
   ``fused_stats.moments`` the C mean and the exact variance (and
   ``normalization_from_sums`` the kernels' alpha, beta).
3. **Pass 2.** Groups of rows, at most ``GROUP_SAMPLES`` samples of work a
   group, go through K1 (``fused_all_call``, ``single_pass``), K2 and K3
   (``fused_stats_call``, ``stft_power``), or the XLA-path stage
   (``_XlaRows``): the amplitude weights (``amplitude._weights``) summed a
   row or the iterative mode's exact histogram counts
   (``amplitude.hist_crop_counts``), each row's trim bounds
   (``amplitude.trim_bounds``), its payload frames' spectra
   (``frequency._frame_spectra``), and the window energies of its
   normalized samples with the K before it as the FIR's history
   (``tempo.window_energies``). Each row keeps its first CH/256 window
   energies; the spectra add up in float64, or, under
   ``strict_accumulation``, into one float32 running sum over the song's
   frames in order, carried from group to group (as the whole song's frame
   loop, so bit for bit).
4. **Assemble**, on the device: the trim bounds, the amplitude in the JAX
   module's form (the weight sum less the weight of zero for each zero
   outside the trimmed span, or, iterative, the trimmed zeros taken from
   the zero bin before the 301 passes run once on the song's histogram),
   the frequency score of the summed spectrum, the energies masked by the
   song's window count.
5. **Finish in float64**, whatever ``cfg.tempo_finish`` says, as the JAX
   module's host finish: on the host for ``"host"``
   (``envelope_finish_host``), else on the device in float64
   (``envelope_finish_device`` under ``tempo_finish="device_exact"``).
   Nothing before the final copy of the [4] vector waits for the device.

Row 0 has no history. The batch path normalizes the samples before sample 0
to 0, and the JAX module masks them to 0, as the XLA-path rows do. The
kernels' row 0 takes as ``halo0`` the song's mean, clipped to int16 (as
``bliss_tpu/parallel/mesh.py:289-295`` does for its shard 0), whose
normalized value alpha·mean + beta is 0 up to the float32 rounding of alpha
and beta. That keeps one launch a group: on the tests' songs the streamed
energies lie within 1e-9 relative of the batch path's
(``tests/test_torch_streaming.py``), so row 0 needs no launch of its own
without ``halo0``.

With ``extended``, each group of rows also gives the extended features'
per-song sums (``extended.partials``) from the rows' payload: a row counts
its ``n_row // 1024`` payload frames and never its lookahead frame, and its
mono pairs (m - 1, m) for 1 <= m < n_mono_row, where ``n_mono_row =
clamp(n // 2 - r·CH / 2, 0, CH / 2 + 1)`` reaches one mono sample into the
lookahead: the zero crossing between row r's last payload sample and row
r + 1's first is counted once, in row r. The rows' sums add up in float64
to the song's, and ``extended.finish`` makes the 45 columns with the
prepass's exact sum of s^2 and the beat columns of the song's own envelope
finish. An XLA-path config's per-frame stage runs in its dtype, as its
whole-song path does.

On a CUDA tensor every step launches its kernel or runs PyTorch on the card,
or raises; on the CPU the same wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables
from bliss_tpu_torch.config import AnalysisConfig, check_supported, uses_kernels
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.features.amplitude import (
    _CROP_LO,
    _CROP_W,
    _weights,
    hist_crop_counts,
    integral_from_hist,
    trim_bounds,
)
from bliss_tpu_torch.features.extended import EXTENDED_FEATURE_NAMES, Partials, finish, partials
from bliss_tpu_torch.features.analyze import _amplitude_score, _mask_energies
from bliss_tpu_torch.features.frequency import _frame_spectra
from bliss_tpu_torch.features.tempo import (
    beat_cols_from_host_aux,
    beat_metrics,
    envelope_finish_device,
    envelope_finish_host,
    normalized,
    window_energies,
)
from bliss_tpu_torch.features.types import PCMBatch, resolve_device
from bliss_tpu_torch.kernels import fused_all
from bliss_tpu_torch.kernels import fused_stats as fs
from bliss_tpu_torch.kernels import stft

# Default chunk: 2^22 interleaved samples (~95 s of stereo audio, 8 MB).
DEFAULT_CHUNK = 1 << 22
# Samples of rows a kernel launch takes at most (times bands and float32
# words a sample, for the XLA-path stage), so that its scratch stays
# bounded whatever the song's length.
GROUP_SAMPLES = 1 << 26


def streaming_supports(cfg: AnalysisConfig) -> bool:
    """Whether a config's long songs stream: every config does, as in
    ``bliss_tpu`` (so this returns True; it stays the routing hook of the
    pipeline and ``Song``). A config that takes the kernels streams through
    them; every other through the XLA-path stage, whose strict orders
    decompose over rows in song order: the float32 frame sum of
    ``strict_accumulation`` carries from row to row, the iterative
    amplitude's 301 passes run once on the song's summed histogram, and the
    framed energy modes reset their FIR each window, so a window needs no
    state from the row before."""
    return True


class Streamed(NamedTuple):
    """The device stage of one streamed song: ``song`` is the padded song's
    first R·CH samples [1, R·CH] with its count and duration; ``sums`` the
    prepass's exact (sum s, sum s^2); ``alpha``, ``beta``, ``mean`` its
    normalization; ``start``, ``end`` the trim bounds; ``amplitude`` and
    ``frequency`` the [1] scores; ``energies`` the masked window energies
    [1, NB, R·CH/256] float64; ``ext`` the song's extended ``Partials``
    [1, ...] when asked for, else None."""

    song: PCMBatch
    sums: tuple
    alpha: torch.Tensor
    beta: torch.Tensor
    mean: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    amplitude: torch.Tensor
    frequency: torch.Tensor
    energies: torch.Tensor
    ext: Partials | None = None


def stream_stage(
    samples: np.ndarray, duration: int, cfg: AnalysisConfig, chunk_samples: int, device,
    extended: bool = False,
) -> Streamed:
    """Steps 1-4 of the module docstring, on ``device``, for one int16 song
    of any length; with ``extended`` also the extended features' sums of its
    rows."""
    if not uses_kernels(cfg):
        return _xla_stage(samples, duration, cfg, chunk_samples, device, extended)
    CH, FR, BLK = int(chunk_samples), stft.FRAME, fs.BLK
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    n = int(samples.shape[0])
    R = max(1, -(-n // CH))
    K = cfg.band_taps - 1
    kw = dict(nb_bands=cfg.nb_bands, band_taps=cfg.band_taps, filterbank=cfg.filterbank)

    x = torch.zeros(R * CH + FR, dtype=torch.int16, device=device)
    x[:n].copy_(torch.from_numpy(samples))
    n_t = torch.full((1,), n, dtype=torch.int32, device=device)
    sums = fs.prepass_sums(x[None], n_t)
    alpha, beta, mean = fs.normalization_from_sums(*sums, n_t)

    starts = torch.arange(R, device=device) * CH
    before = starts[:, None] - K + torch.arange(K, device=device)
    halo0 = torch.where(before >= 0, x[before.clamp(min=0)],
                        mean.clamp(-32768, 32767).to(torch.int16))
    n_rows = (n - starts).clamp(0, CH).to(torch.int32)
    n_mono = (n // 2 - starts // 2).clamp(0, CH // 2 + 1)

    rows_all = x.unfold(0, CH + FR, CH)  # [R, CH + 1024], overlapping views
    group = max(1, GROUP_SAMPLES // (CH + FR))
    keep = CH // BLK
    wsum, rownz, energies, parts = [], [], [], []
    power = torch.zeros(stft.NBINS + 1, dtype=torch.float64, device=device)
    for g0 in range(0, R, group):
        rows = rows_all[g0 : g0 + group].contiguous()
        g = rows.shape[0]
        a, b = alpha.expand(g).contiguous(), beta.expand(g).contiguous()
        h, n_g = halo0[g0 : g0 + g], n_rows[g0 : g0 + g]
        if cfg.single_pass:
            w, z, e, p = fused_all.fused_all_call(rows, a, b, stft.frame_counts(n_g), h, **kw)
        else:
            w, z, e = fs.fused_stats_call(rows, a, b, h, conv_mode=cfg.fused_conv, **kw)
            p = stft.stft_power(rows, n_g, precise=cfg.stft_conv == "precise")
        if extended:
            parts.append(partials(rows, stft.frame_counts(n_g), n_mono[g0 : g0 + g]).total())
        del rows  # before the next group's copy
        wsum.append(w[:, :keep])
        rownz.append(z[:, :keep])
        energies.append(e[..., :keep])
        power += p.to(torch.float64).sum(dim=0)

    wsum = torch.cat(wsum).reshape(1, R * keep)
    rownz = torch.cat(rownz).reshape(1, R * keep)
    fa = torch.cat(energies).permute(1, 0, 2).reshape(1, cfg.nb_bands, R * keep)
    song = PCMBatch(x[None, : R * CH], n_t,
                    torch.full((1,), duration, dtype=torch.int32, device=device))
    start, end = fs.trim_bounds_from_rownz(song.samples, rownz, R * CH)
    end = torch.minimum(end, n_t - 1)  # an all-zero song spans the song only
    span = (end - start).to(torch.int64)
    # every sample of the R·CH outside [start, end] is a zero of weight 1
    outside = R * CH - 1 - span
    integral = (wsum.sum(dim=1, dtype=torch.float64) - outside) * 100.0 / span.clamp(min=1)
    return Streamed(
        song, sums, alpha, beta, mean, start, end, _amplitude_score(integral),
        stft.frequency_scores_from_power(power[None], cfg), _mask_energies(song, fa),
        Partials(*(sum(ts) for ts in zip(*parts))) if extended else None,
    )


def _xla_stage(
    samples: np.ndarray, duration: int, cfg: AnalysisConfig, chunk_samples: int, device,
    extended: bool,
) -> Streamed:
    """``stream_stage`` of a config that takes the XLA-path stage: the
    song folds into rows of K history samples, CH of payload and a 1024
    lookahead, a group of rows at a time through ``_XlaRows``."""
    CH, FR, hop = int(chunk_samples), stft.FRAME, C.TEMPO_HOP
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    n = int(samples.shape[0])
    R = max(1, -(-n // CH))
    K = cfg.band_taps - 1
    P = -(-K // 8) * 8  # zeros before the song: row 0's history, 16-byte aligned
    dtype = cfg.torch_dtype

    x = torch.zeros(P + R * CH + FR, dtype=torch.int16, device=device)
    x[P : P + n].copy_(torch.from_numpy(samples))
    n_t = torch.full((1,), n, dtype=torch.int32, device=device)
    sums = fs.prepass_sums(x[None, P:], n_t)
    mean, var = fs.moments(*sums, n_t)
    alpha, beta, _ = fs.normalization_from_sums(*sums, n_t)

    rows_all = x[P - K :].unfold(0, K + CH + FR, CH)  # [R, K + CH + FR], overlapping views
    # the stage's temporaries grow with the bands and the dtype's words
    work = (K + CH + FR) * cfg.nb_bands * (dtype.itemsize // 4)
    group = max(1, GROUP_SAMPLES // work)
    keep = CH // hop
    song_frames = n // FR
    acc = _XlaRows(cfg, n, mean, var, device, extended)
    for g0 in range(0, R, group):
        rows = rows_all[g0 : g0 + group].contiguous()
        # frames counted in each row, in song order: all but the song's last
        # rows count CH // 1024
        frames = [min(max(song_frames - r * (CH // FR), 0), CH // FR)
                  for r in range(g0, g0 + rows.shape[0])]
        acc.add(rows, g0 * CH, frames)
        del rows

    first = torch.cat(acc.first).min()
    last = torch.cat(acc.last).max()
    silent = first > last  # an all-zero song spans the song
    first = torch.where(silent, torch.zeros_like(first), first)
    last = torch.where(silent, torch.full_like(last, n - 1), last)
    trimmed = first + (n - 1 - last)
    span = (last - first).clamp(min=1)
    if cfg.amplitude_mode == "iterative":
        # the trimmed samples are zeros: their counts leave the zero bin
        hist = acc.hist.clone()
        hist[(1 << 15) - _CROP_LO] -= trimmed
        integral = integral_from_hist(hist[None], span[None], cfg)
    else:
        w0 = float(tables.amplitude_weight_table()[1 << 15])
        dot = torch.cat(acc.dots).to(torch.float64).sum()
        integral = ((dot - w0 * trimmed.to(torch.float64)) * 100.0 / span)[None]
    power = acc.power[None] if acc.power is not None else acc.strict[None].to(dtype)

    fa = torch.cat(acc.energies).permute(1, 0, 2).reshape(1, cfg.nb_bands, R * keep)
    song = PCMBatch(x[None, P : P + R * CH], n_t,
                    torch.full((1,), duration, dtype=torch.int32, device=device))
    return Streamed(
        song, sums, alpha, beta, mean, first[None], last[None], _amplitude_score(integral),
        stft.frequency_scores_from_power(power, cfg), _mask_energies(song, fa),
        Partials(*(sum(ts) for ts in zip(*acc.parts))) if extended else None,
    )


class _XlaRows:
    """The XLA-path stage over one song's groups of rows, and what they add
    up to: each row's trim bounds (``first``, ``last``), weight sums
    (``dots``) or the song's histogram (``hist``), the spectrum summed in
    float64 (``power``) or the strict float32 running sum (``strict``),
    each row's window energies, and the extended sums (``parts``)."""

    def __init__(self, cfg: AnalysisConfig, n: int, mean, var, device, extended: bool):
        self.cfg, self.n, self.mean, self.var, self.extended = cfg, n, mean, var, extended
        self.K = cfg.band_taps - 1
        self.fb = tables.bandpass_filterbank(cfg.nb_bands, cfg.band_taps, cfg.filterbank)
        self.tabs = device_tables(cfg.nb_bands, cfg.band_taps, cfg.filterbank, device,
                                  cfg.iir_block, dtype=cfg.torch_dtype)
        self.first, self.last, self.dots, self.energies, self.parts = [], [], [], [], []
        self.hist = torch.zeros(_CROP_W, dtype=torch.int64, device=device)
        nbins = C.WINDOW_SIZE // 2 + 1
        self.power = self.strict = None
        if cfg.strict_accumulation:
            self.strict = torch.zeros(nbins, dtype=torch.float32, device=device)
        else:
            self.power = torch.zeros(nbins, dtype=torch.float64, device=device)

    def add(self, rows: torch.Tensor, base: int, frames: list[int]) -> None:
        """One group of rows [g, K + CH + 1024] int16, row r the song's
        samples base + r·CH - K .. base + r·CH + CH + 1023 (zeros outside
        the song); ``frames`` lists the frames each row counts."""
        cfg, K, n, tabs = self.cfg, self.K, self.n, self.tabs
        g, CH = rows.shape[0], rows.shape[1] - K - stft.FRAME
        dtype = cfg.torch_dtype
        starts = base + torch.arange(g, device=rows.device) * CH
        j = torch.arange(rows.shape[1], device=rows.device)
        valid = (j[None, :] >= (K - starts)[:, None]) & (j[None, :] < (n + K - starts)[:, None])
        payload, vpay = rows[:, K : K + CH], valid[:, K : K + CH]

        # amplitude: each row's trim bounds, then its weight sum or its counts
        start, end = trim_bounds(payload)
        nonzero = torch.gather(payload, 1, start[:, None])[:, 0] != 0
        self.first.append(torch.where(nonzero, starts + start, torch.full_like(start, 1 << 62)))
        self.last.append(torch.where(nonzero, starts + end, torch.full_like(end, -1)))
        if cfg.amplitude_mode == "iterative":
            self.hist += hist_crop_counts(payload, vpay).sum(dim=0, dtype=torch.int64)
        else:
            self.dots.append(torch.sum(_weights(payload, cfg, tabs) * vpay.to(dtype), dim=1))

        # frequency: the payload's frames only, never the lookahead frame
        n_frames = torch.tensor(frames, dtype=torch.int32, device=rows.device)
        re, im = _frame_spectra(payload, n_frames, cfg, tabs)
        if self.strict is not None:
            re32, im32 = re.to(torch.float32), im.to(torch.float32)
            raw = (re32 * re32 + im32 * im32).reshape(-1, re.shape[-1])
            del re32, im32
            # the float32 running sum, a frame at a time in song order (a
            # reduction or cumsum kernel rounds in another order); the
            # counted frames lead the group's rows, and a frame that does
            # not count would add an exact zero, so it is skipped
            for f in range(sum(frames)):
                self.strict = self.strict + raw[f]
            del raw
        else:
            power = torch.sum((re * re + im * im).to(dtype), dim=1)
            self.power += power.to(torch.float64).sum(dim=0)
        del re, im

        # tempo: the normalized rows, zero outside the song, the K samples
        # before each payload its FIR's history
        norm = normalized(rows, self.mean.expand(g), self.var.expand(g), dtype)
        norm = torch.where(valid, norm, torch.zeros_like(norm))
        energies = window_energies(norm, cfg, self.fb, tabs, history=True)
        self.energies.append(energies[..., : CH // C.TEMPO_HOP])
        del norm
        if self.extended:
            n_mono = (n // 2 - starts // 2).clamp(0, CH // 2 + 1)
            self.parts.append(partials(rows[:, K:], n_frames, n_mono, dtype).total())


def analyze_song_streaming(
    samples: np.ndarray,
    duration: int,
    cfg: AnalysisConfig,
    chunk_samples: int = DEFAULT_CHUNK,
    extended: bool = False,
    *,
    device="cuda",
) -> np.ndarray:
    """The [4] float32 force vector (tempo, amplitude, frequency, attack) of
    one int16 interleaved-stereo song of any length, with its duration in
    whole seconds, analyzed on ``device`` (the GPU unless the caller asks
    for the CPU; raises RuntimeError when no GPU is present) in rows of
    ``chunk_samples``, a multiple of 1024; with ``extended``, [4 + 45], the
    extended features after the 4, their beat columns from the same
    envelope finish as the tempo. Every config streams: through the kernels
    where it takes them, else through the XLA-path stage. The envelope
    finish runs in float64 whatever ``cfg.tempo_finish`` says, as
    ``bliss_tpu``'s streaming does: on the host for ``"host"``, else on the
    device (``"device"`` finishes as ``"device_exact"``), so a streamed
    song's beats are exact."""
    check_supported(cfg)
    if chunk_samples <= 0 or chunk_samples % stft.FRAME:
        raise ValueError("chunk_samples must be a multiple of 1024")
    st = stream_stage(samples, duration, cfg, chunk_samples, resolve_device(device), extended)
    fa, song = st.energies, st.song
    n, d = song.n_samples, song.durations
    host = cfg.tempo_finish == "host"
    if extended and host:
        # zero beat columns here: the host finish writes them from its aux
        zero = torch.zeros(1, dtype=torch.float32, device=fa.device)
        cols = finish(st.ext, n, st.sums[1], zero, zero)
    if host:
        # one device-to-host copy: amplitude, frequency, energies (+ extended)
        parts = [st.amplitude.to(torch.float64), st.frequency.to(torch.float64), fa.reshape(-1)]
        if extended:
            parts.append(cols[0].to(torch.float64))
        packed = torch.cat(parts).cpu().numpy()
        end = 2 + fa.numel()
        finished = envelope_finish_host(
            packed[2:end].reshape(fa.shape), [len(samples)], [duration], return_aux=extended
        )
        core = np.array([finished[0][0], packed[0], packed[1], finished[1][0]], np.float32)
        if not extended:
            return core
        row = packed[end:].astype(np.float32)
        bpm, loud = beat_cols_from_host_aux(finished[2], [duration])
        row[EXTENDED_FEATURE_NAMES.index("bpm")] = bpm[0]
        row[EXTENDED_FEATURE_NAMES.index("beat_loudness")] = loud[0]
        return np.concatenate([core, row])
    exact = dataclasses.replace(cfg, tempo_finish="device_exact")
    if not extended:
        tempo, attack = envelope_finish_device(fa, n, d, exact)
        return torch.stack([tempo, st.amplitude, st.frequency, attack], dim=1)[0].cpu().numpy()
    tempo, attack, aux = envelope_finish_device(fa, n, d, exact, return_aux=True)
    bpm, loud = beat_metrics(fa, n, d, exact, aux=aux)
    core = torch.stack([tempo, st.amplitude, st.frequency, attack], dim=1)
    return torch.cat([core, finish(st.ext, n, st.sums[1], bpm, loud)], dim=1)[0].cpu().numpy()
