"""Batched analysis: PCM batch -> [B, 4] force vectors (counterpart of
``bliss_tpu/features/analyze.py``).

The main path: the fused kernel's one pass gives the amplitude integral,
the tempo window energies and the summed power spectrum; the frequency
score comes from the spectrum and the tempo/attack scores from the float64
envelope finish.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bliss_tpu_torch import constants as C
from bliss_tpu_torch.config import AnalysisConfig, check_supported
from bliss_tpu_torch.features.tempo import envelope_finish_device
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import fused_all
from bliss_tpu_torch.kernels.stft import frequency_scores_from_power


def analyze_batch(batch: PCMBatch, cfg: AnalysisConfig) -> torch.Tensor:
    """[B, 4] float32 force vectors, ordered (tempo, amplitude, frequency,
    attack) like the reference force_vector_s (include/bliss.h:26-31).
    Raises NotImplementedError for a config the port does not run yet."""
    check_supported(cfg)
    amplitude, frequency, fa = _single_pass_stage(batch, cfg)
    tempo, attack = envelope_finish_device(
        fa, batch.n_samples, batch.durations, cfg
    )
    return torch.stack([tempo, amplitude, frequency, attack], dim=1)


def _single_pass_stage(batch: PCMBatch, cfg: AnalysisConfig):
    """One pass over the PCM: (amplitude [B], frequency [B],
    fa [B, NB, NBF])."""
    amp_integral, energies, power = fused_all.fused_all_stats(
        batch.samples,
        batch.n_samples,
        nb_bands=cfg.nb_bands,
        band_taps=cfg.band_taps,
        filterbank=cfg.filterbank,
    )
    amplitude = C.AMPLITUDE_SCALE * amp_integral.to(torch.float32) + C.AMPLITUDE_BIAS
    frequency = frequency_scores_from_power(power, cfg)
    fa = _mask_energies(batch, energies)
    return amplitude, frequency, fa


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
