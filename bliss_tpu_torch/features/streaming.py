"""Long songs streamed through the batch kernels (counterpart of
``bliss_tpu/features/streaming.py``).

The JAX module streams a song chunk by chunk so that XLA compiles one chunk
shape for every length. The port compiles nothing at run time, so it folds
the song into rows that the batch kernels take as one batch, and the cost
of a song grows with its own length instead of with its bucket's.

1. **Fold.** The song is copied to the device once, zero-padded to R·CH +
   1024 samples (CH = ``chunk_samples``, R = ceil(n / CH)). Row r is its
   samples r·CH .. r·CH + CH + 1024: the chunk's payload and a one-frame
   lookahead, which serves the window that starts in the chunk's last hop
   and ends in the next chunk (1024 keeps the row a multiple of K1's
   frame; the JAX module's lookahead is one hop). A row counts its payload
   only: ``n_row = clamp(n - r·CH, 0, CH)`` samples and ``n_row // 1024``
   spectrum frames, which sum to the song's ``n // 1024``. ``halo0`` [R, K]
   (K = taps - 1) holds the K raw samples before each row, so the causal
   FIR of every row continues the song's.
2. **Pass 1.** ``fused_stats.prepass_sums`` over the padded song as one row
   gives the exact int64 sums of s and s^2, and
   ``fused_stats.normalization_from_sums`` the C mean, the exact variance
   and alpha, beta, the formula the batch path uses.
3. **Pass 2.** Groups of at most ``GROUP_SAMPLES`` samples of rows go
   through K1 (``fused_all_call``, ``single_pass``) or K2 and K3
   (``fused_stats_call``, ``stft_power``). Each row keeps its first CH/256
   blocks of weight sums and nonzero flags and its first CH/256 window
   energies; the spectra add up in float64.
4. **Assemble**, on the device: the trim bounds from the flags, the
   amplitude in the JAX module's form (the weight sum less one for each zero
   outside the trimmed span, whose size is an exact integer however long the
   song), the frequency score of the summed spectrum, the energies masked by
   the song's window count, then the float64 envelope finish on the device
   (``tempo_finish="device_exact"``) or on the host (``"host"``). Nothing
   before the final copy of the [4] vector waits for the device.

Row 0 has no history. The batch path normalizes the samples before sample 0
to 0, and the JAX module masks them to 0. Row 0's ``halo0`` is the song's
mean, clipped to int16 (as ``bliss_tpu/parallel/mesh.py:289-295`` does for
its shard 0), whose normalized value alpha·mean + beta is 0 up to the
float32 rounding of alpha and beta. That keeps one launch a group: on the
tests' songs the streamed energies lie within 1e-9 relative of the batch
path's (``tests/test_torch_streaming.py``), so row 0 needs no launch of its
own without ``halo0``.

With ``extended``, each group of rows also gives the extended features'
per-song sums (``extended.partials``) from the rows' payload: a row counts
its ``n_row // 1024`` payload frames and never its lookahead frame, and its
mono pairs (m - 1, m) for 1 <= m < n_mono_row, where ``n_mono_row =
clamp(n // 2 - r·CH / 2, 0, CH / 2 + 1)`` reaches one mono sample into the
lookahead: the zero crossing between row r's last payload sample and row
r + 1's first is counted once, in row r. The rows' sums add up in float64
to the song's, and ``extended.finish`` makes the 45 columns with the
prepass's exact sum of s^2 and the beat columns of the song's own envelope
finish.

On a CUDA tensor every step launches its kernel or raises; on the CPU the
same wrappers run their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bliss_tpu_torch.config import AnalysisConfig, check_supported, uses_kernels
from bliss_tpu_torch.features.extended import EXTENDED_FEATURE_NAMES, Partials, finish, partials
from bliss_tpu_torch.features.analyze import _amplitude_score, _mask_energies
from bliss_tpu_torch.features.tempo import (
    beat_cols_from_host_aux,
    beat_metrics,
    envelope_finish_device,
    envelope_finish_host,
)
from bliss_tpu_torch.features.types import PCMBatch, resolve_device
from bliss_tpu_torch.kernels import fused_all
from bliss_tpu_torch.kernels import fused_stats as fs
from bliss_tpu_torch.kernels import stft

# Default chunk: 2^22 interleaved samples (~95 s of stereo audio, 8 MB).
DEFAULT_CHUNK = 1 << 22
# Samples of rows a kernel launch takes at most, so that its scratch stays
# bounded whatever the song's length.
GROUP_SAMPLES = 1 << 26


def streaming_supports(cfg: AnalysisConfig) -> bool:
    """Whether the port streams a config's long songs: those that take the
    kernels (``config.uses_kernels``). The streamed form of the XLA-path
    stage is ROADMAP item M7b, so such a config's long songs go whole-shape
    through the buckets, ``bliss_tpu``'s ``long_song_samples=None``
    semantics."""
    return uses_kernels(cfg)


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
    """Steps 1-4 of the module docstring but the envelope finish, on
    ``device``, for one int16 song of any length; with ``extended`` also the
    extended features' sums of its rows."""
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
    envelope finish as the tempo. Raises NotImplementedError for a config
    that takes the XLA-path stage (``streaming_supports``)."""
    check_supported(cfg)
    if not streaming_supports(cfg):
        raise NotImplementedError(
            "streaming an XLA-path config (one that does not take the CUDA "
            "kernels: not fused_kernel, float64, or band_taps > 129) is ROADMAP "
            "item M7b; analyze the song whole (analyze_features)"
        )
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
    if not extended:
        tempo, attack = envelope_finish_device(fa, n, d, cfg)
        return torch.stack([tempo, st.amplitude, st.frequency, attack], dim=1)[0].cpu().numpy()
    tempo, attack, aux = envelope_finish_device(fa, n, d, cfg, return_aux=True)
    bpm, loud = beat_metrics(fa, n, d, cfg, aux=aux)
    core = torch.stack([tempo, st.amplitude, st.frequency, attack], dim=1)
    return torch.cat([core, finish(st.ext, n, st.sums[1], bpm, loud)], dim=1)[0].cpu().numpy()
