"""Batched analysis: PCM batch -> [B, 4] force vectors (counterpart of
``bliss_tpu/features/analyze.py``).

The device stage gives the amplitude score, the frequency score and the
tempo window energies. A config that takes the kernels (``config.
uses_kernels``: the fused kernel, float32, at most 129 taps, as
``bliss_tpu``'s ``_use_fused`` routes) computes them in one pass
(``single_pass=True``, the main path: kernel K1 of ``kernels/fused_all.py``)
or in two (the sample-stats kernel K2 of ``kernels/fused_stats.py`` and the
spectrum kernel K3 of ``kernels/stft.py``); every other config takes the
XLA-path stage, PyTorch on the device (``features/amplitude.py``,
``features/frequency.py``, ``tempo.band_energies``). The tempo/attack
scores come from the envelope finish: on the device, in float64
(``tempo_finish="device_exact"``) or in the config's dtype (``"device"``),
or on the host in float64 (``"host"``, ``analyze_batch_hybrid``). ``analyze_batch_ext``
and the ``extended`` option of the hybrid functions add the 45 extended
columns (``features/extended.py``) after the 4, from the same device stage
and the same envelope finish.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bliss_tpu_torch import constants as C
from bliss_tpu_torch.config import AnalysisConfig, check_supported, uses_kernels
from bliss_tpu_torch.features.amplitude import amplitude_scores
from bliss_tpu_torch.features.extended import EXTENDED_FEATURE_NAMES, extended_features
from bliss_tpu_torch.features.frequency import frequency_scores
from bliss_tpu_torch.features.tempo import (
    band_energies,
    beat_cols_from_host_aux,
    envelope_finish_device,
    envelope_finish_host,
)
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import fused_all, fused_stats
from bliss_tpu_torch.kernels.stft import frequency_scores_from_power, frequency_scores_fused


def analyze_batch(batch: PCMBatch, cfg: AnalysisConfig) -> torch.Tensor:
    """[B, 4] float32 force vectors on the batch's device, ordered (tempo,
    amplitude, frequency, attack) like the reference force_vector_s
    (include/bliss.h:26-31). A ``tempo_finish="host"`` config finishes on
    the host through ``analyze_batch_hybrid``. Raises ValueError for an
    unknown mode name."""
    check_supported(cfg)
    if cfg.tempo_finish == "host":
        return analyze_batch_hybrid(batch, cfg).to(batch.samples.device)
    amplitude, frequency, fa = _device_stage(batch, cfg)
    tempo, attack = envelope_finish_device(
        fa, batch.n_samples, batch.durations, cfg
    )
    return torch.stack([tempo, amplitude, frequency, attack], dim=1)


def analyze_batch_ext(batch: PCMBatch, cfg: AnalysisConfig) -> torch.Tensor:
    """[B, 4 + 45] float32 on the batch's device: the force vectors and the
    extended features (counterpart of ``analyze_batch_ext_jit``), from one
    device stage and ONE envelope chain, whose aux gives the extended bpm
    and beat_loudness, so that they count the core's beats in every row. A
    ``tempo_finish="host"`` config finishes on the host
    (``analyze_batch_hybrid(..., extended=True)``)."""
    check_supported(cfg)
    if cfg.tempo_finish == "host":
        return analyze_batch_hybrid(batch, cfg, extended=True).to(batch.samples.device)
    amplitude, frequency, fa, sums = _device_stage_sums(batch, cfg)
    tempo, attack, aux = envelope_finish_device(
        fa, batch.n_samples, batch.durations, cfg, return_aux=True
    )
    core = torch.stack([tempo, amplitude, frequency, attack], dim=1)
    ext = extended_features(batch, cfg, fa=fa, beat_aux=aux, sums=sums, dtype=cfg.torch_dtype)
    return torch.cat([core, ext], dim=1)


def _device_stage(batch: PCMBatch, cfg: AnalysisConfig):
    """(amplitude [B], frequency [B], fa [B, NB, NBF]) on the batch's
    device: through K1, through K2 and K3 (fa float64), or through the
    XLA-path stage (fa in the config's dtype)."""
    return _device_stage_sums(batch, cfg)[:3]


def _device_stage_sums(batch: PCMBatch, cfg: AnalysisConfig):
    """``_device_stage``'s outputs and the prepass's exact ``(sum s,
    sum s^2)``, which the tempo normalization and the extended loudness
    read."""
    sums = fused_stats.prepass_sums(batch.samples, batch.n_samples)
    if not uses_kernels(cfg):
        return (amplitude_scores(batch, cfg), frequency_scores(batch, cfg),
                band_energies(batch, cfg, sums), sums)
    if cfg.single_pass:
        return (*_single_pass_stage(batch, cfg, sums), sums)
    amplitude, fa = _fused_amp_and_energies(batch, cfg, sums)
    return amplitude, frequency_scores_fused(batch, cfg), fa, sums


def _amplitude_score(amp_integral: torch.Tensor) -> torch.Tensor:
    return C.AMPLITUDE_SCALE * amp_integral.to(torch.float32) + C.AMPLITUDE_BIAS


def _single_pass_stage(batch: PCMBatch, cfg: AnalysisConfig, sums=None):
    """One pass over the PCM: (amplitude [B], frequency [B],
    fa [B, NB, NBF])."""
    amp_integral, energies, power = fused_all.fused_all_stats(
        batch.samples,
        batch.n_samples,
        nb_bands=cfg.nb_bands,
        band_taps=cfg.band_taps,
        filterbank=cfg.filterbank,
        sums=sums,
    )
    frequency = frequency_scores_from_power(power, cfg)
    return _amplitude_score(amp_integral), frequency, _mask_energies(batch, energies)


def _fused_amp_and_energies(batch: PCMBatch, cfg: AnalysisConfig, sums=None):
    """The sample-stats kernel's part of the two-kernel stage:
    (amplitude [B], masked energies fa [B, NB, NBF])."""
    amp_integral, energies = fused_stats.fused_sample_stats(
        batch.samples,
        batch.n_samples,
        nb_bands=cfg.nb_bands,
        band_taps=cfg.band_taps,
        filterbank=cfg.filterbank,
        conv_mode=cfg.fused_conv,
        sums=sums,
    )
    return _amplitude_score(amp_integral), _mask_energies(batch, energies)


def _mask_energies(batch: PCMBatch, energies: torch.Tensor) -> torch.Tensor:
    """Zero window slots past each song's count; pad/trim to NBF."""
    W, hop = C.WINDOW_SIZE, C.TEMPO_HOP
    n = batch.n_samples.to(torch.int64)
    NBF = batch.samples.shape[1] // hop
    NW = energies.shape[-1]
    trunc_n = n - n % W
    n_windows = -torch.div(-(trunc_n - W), hop, rounding_mode="floor")
    wmask = torch.arange(NW, device=energies.device)[None, None, :] < n_windows[:, None, None]
    fa = energies * wmask.to(energies.dtype)
    if NW < NBF:
        return F.pad(fa, (0, NBF - NW))
    return fa[:, :, :NBF]


def _device_stage_packed(
    batch: PCMBatch, cfg: AnalysisConfig, extended: bool = False
) -> torch.Tensor:
    """The hybrid path's device stage with every output in one float64
    array [B, 2 + NB*NBF (+ 45)] = (amplitude, frequency, flattened band
    energies, extended features), so the host pays one copy back. A
    ``tempo_finish="host"`` config's extended beat columns are left zero:
    its finish writes them from the float64 host aux."""
    amplitude, frequency, fa, sums = _device_stage_sums(batch, cfg)
    B, NB, NBF = fa.shape
    cols = [amplitude[:, None], frequency[:, None], fa.reshape(B, NB * NBF)]
    if extended:
        skip = "skip" if cfg.tempo_finish == "host" else None
        cols.append(extended_features(batch, cfg, fa=fa, beat_aux=skip, sums=sums,
                                      dtype=cfg.torch_dtype))
    return torch.cat([c.to(torch.float64) for c in cols], dim=1)


def _unpack_stage(packed: np.ndarray, cfg: AnalysisConfig, L: int, extended: bool = False):
    """Split a copied-back ``_device_stage_packed`` array into
    (amplitude [B], frequency [B], fa [B, NB, NBF], extended [B, 45] or
    None)."""
    B = packed.shape[0]
    NBF = L // C.TEMPO_HOP
    end = 2 + cfg.nb_bands * NBF
    amp = packed[:, 0].astype(np.float32)
    freq = packed[:, 1].astype(np.float32)
    fa = packed[:, 2:end].reshape(B, cfg.nb_bands, NBF)
    ext = packed[:, end:].astype(np.float32) if extended else None
    return amp, freq, fa, ext


def launch_hybrid(batch: PCMBatch, cfg: AnalysisConfig, extended: bool = False):
    """The launch half of ``analyze_batch_hybrid``: queue the device stage
    and return ``finish(n_samples, durations)``, which takes the host
    (NumPy) counts and durations, copies the packed result back, runs the
    float64 envelope finish and gives [B, 4] (with ``extended``, [B, 49])
    float32 NumPy rows; the extended bpm and beat_loudness come from the
    same host finish as the tempo. The callable holds the device result,
    never the batch, so it may run on another thread while the caller
    launches more work."""
    check_supported(cfg)
    packed = _device_stage_packed(batch, cfg, extended)
    L = batch.samples.shape[1]

    def finish(n_samples: np.ndarray, durations: np.ndarray) -> np.ndarray:
        return finish_packed(packed.cpu().numpy(), cfg, L, extended, n_samples, durations)

    return finish


def finish_packed(packed: np.ndarray, cfg: AnalysisConfig, L: int, extended: bool,
                  n_samples: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """The host half of the hybrid path: a copied-back
    ``_device_stage_packed`` array of a batch of length L -> [B, 4] (with
    ``extended``, [B, 49]) float32 rows, the tempo and attack from the
    float64 envelope finish, and the extended bpm and beat_loudness from
    its aux."""
    amplitude, frequency, fa, ext = _unpack_stage(packed, cfg, L, extended)
    if not extended:
        tempo, attack = envelope_finish_host(fa, n_samples, durations)
        return np.stack([tempo, amplitude, frequency, attack], axis=1)
    tempo, attack, aux = envelope_finish_host(fa, n_samples, durations, return_aux=True)
    bpm, loud = beat_cols_from_host_aux(aux, durations)
    ext[:, EXTENDED_FEATURE_NAMES.index("bpm")] = bpm
    ext[:, EXTENDED_FEATURE_NAMES.index("beat_loudness")] = loud
    return np.concatenate([np.stack([tempo, amplitude, frequency, attack], axis=1), ext], axis=1)


def analyze_batch_hybrid(
    batch: PCMBatch, cfg: AnalysisConfig, extended: bool = False
) -> torch.Tensor:
    """[B, 4] (with ``extended``, [B, 49]) float32 rows on the CPU: the
    device stage on the batch's device, one copy back, then the float64
    NumPy/SciPy envelope finish on the host."""
    finish = launch_hybrid(batch, cfg, extended)
    return torch.from_numpy(
        finish(batch.n_samples.cpu().numpy(), batch.durations.cpu().numpy())
    )


def force_and_class(features: torch.Tensor):
    """Aggregate rating and LOUD/CALM/UNKNOWN class per song
    (reference: src/analyze.c:67-79)."""
    t, a, f, k = features.unbind(dim=1)
    force = torch.clamp_min(t, 0.0) + a + f + torch.clamp_min(k, 0.0)
    cls = torch.where(
        force > 0,
        C.BL_LOUD,
        torch.where(force < 0, C.BL_CALM, C.BL_UNKNOWN),
    )
    return force, cls
