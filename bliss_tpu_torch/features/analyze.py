"""Batched analysis: PCM batch -> [B, 4] force vectors (counterpart of
``bliss_tpu/features/analyze.py``).

The device stage gives the amplitude integral, the tempo window energies
and the summed power spectrum, either in one pass (``single_pass=True``,
the main path: kernel K1 of ``kernels/fused_all.py``) or in two (the
sample-stats kernel K2 of ``kernels/fused_stats.py`` and the spectrum
kernel K3 of ``kernels/stft.py``). The frequency score comes from the
spectrum and the tempo/attack scores from a float64 envelope finish: on the
device (``tempo_finish="device_exact"``) or on the host
(``tempo_finish="host"``, ``analyze_batch_hybrid``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bliss_tpu_torch import constants as C
from bliss_tpu_torch.config import AnalysisConfig, check_supported
from bliss_tpu_torch.features.tempo import envelope_finish_device, envelope_finish_host
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import fused_all, fused_stats
from bliss_tpu_torch.kernels.stft import frequency_scores_from_power, frequency_scores_fused


def analyze_batch(batch: PCMBatch, cfg: AnalysisConfig) -> torch.Tensor:
    """[B, 4] float32 force vectors on the batch's device, ordered (tempo,
    amplitude, frequency, attack) like the reference force_vector_s
    (include/bliss.h:26-31). A ``tempo_finish="host"`` config finishes on
    the host through ``analyze_batch_hybrid``. Raises NotImplementedError
    for a config the port does not run yet."""
    check_supported(cfg)
    if cfg.tempo_finish == "host":
        return analyze_batch_hybrid(batch, cfg).to(batch.samples.device)
    amplitude, frequency, fa = _device_stage(batch, cfg)
    tempo, attack = envelope_finish_device(
        fa, batch.n_samples, batch.durations, cfg
    )
    return torch.stack([tempo, amplitude, frequency, attack], dim=1)


def _device_stage(batch: PCMBatch, cfg: AnalysisConfig):
    """(amplitude [B], frequency [B], fa [B, NB, NBF] float64) on the
    batch's device, through K1 or through K2 and K3."""
    if cfg.single_pass:
        return _single_pass_stage(batch, cfg)
    amplitude, fa = _fused_amp_and_energies(batch, cfg)
    return amplitude, frequency_scores_fused(batch, cfg), fa


def _amplitude_score(amp_integral: torch.Tensor) -> torch.Tensor:
    return C.AMPLITUDE_SCALE * amp_integral.to(torch.float32) + C.AMPLITUDE_BIAS


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
    frequency = frequency_scores_from_power(power, cfg)
    return _amplitude_score(amp_integral), frequency, _mask_energies(batch, energies)


def _fused_amp_and_energies(batch: PCMBatch, cfg: AnalysisConfig):
    """The sample-stats kernel's part of the two-kernel stage:
    (amplitude [B], masked energies fa [B, NB, NBF])."""
    amp_integral, energies = fused_stats.fused_sample_stats(
        batch.samples,
        batch.n_samples,
        nb_bands=cfg.nb_bands,
        band_taps=cfg.band_taps,
        filterbank=cfg.filterbank,
        conv_mode=cfg.fused_conv,
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
    array [B, 2 + NB*NBF] = (amplitude, frequency, flattened band
    energies), so the host pays one copy back."""
    if extended:
        raise NotImplementedError(
            "the extended features of the hybrid stage are ROADMAP item M8"
        )
    amplitude, frequency, fa = _device_stage(batch, cfg)
    B, NB, NBF = fa.shape
    cols = [amplitude[:, None], frequency[:, None], fa.reshape(B, NB * NBF)]
    return torch.cat([c.to(torch.float64) for c in cols], dim=1)


def _unpack_stage(packed: np.ndarray, cfg: AnalysisConfig, L: int):
    """Split a copied-back ``_device_stage_packed`` array into
    (amplitude [B], frequency [B], fa [B, NB, NBF])."""
    B = packed.shape[0]
    NBF = L // C.TEMPO_HOP
    amp = packed[:, 0].astype(np.float32)
    freq = packed[:, 1].astype(np.float32)
    fa = packed[:, 2 : 2 + cfg.nb_bands * NBF].reshape(B, cfg.nb_bands, NBF)
    return amp, freq, fa


def launch_hybrid(batch: PCMBatch, cfg: AnalysisConfig):
    """The launch half of ``analyze_batch_hybrid``: queue the device stage
    and return ``finish(n_samples, durations)``, which takes the host
    (NumPy) counts and durations, copies the packed result back, runs the
    float64 envelope finish and gives [B, 4] float32 NumPy force vectors.
    The callable holds the device result, never the batch, so it may run
    on another thread while the caller launches more work."""
    check_supported(cfg)
    packed = _device_stage_packed(batch, cfg)
    L = batch.samples.shape[1]

    def finish(n_samples: np.ndarray, durations: np.ndarray) -> np.ndarray:
        amplitude, frequency, fa = _unpack_stage(packed.cpu().numpy(), cfg, L)
        tempo, attack = envelope_finish_host(fa, n_samples, durations)
        return np.stack([tempo, amplitude, frequency, attack], axis=1)

    return finish


def analyze_batch_hybrid(batch: PCMBatch, cfg: AnalysisConfig) -> torch.Tensor:
    """[B, 4] float32 force vectors on the CPU: the device stage on the
    batch's device, one copy back, then the float64 NumPy/SciPy envelope
    finish on the host."""
    finish = launch_hybrid(batch, cfg)
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
