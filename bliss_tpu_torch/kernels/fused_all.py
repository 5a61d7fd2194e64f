"""One pass of sample statistics plus the summed power spectrum (counterpart
of ``bliss_tpu/kernels/fused_all.py``).

``fused_all_call`` returns, for an int16 PCM batch [B, L]:

- ``wsum``, ``rownz`` [B, NBF] and ``energies`` [B, NB, NW] float64: what
  ``fused_stats.fused_stats_call`` (K2) returns;
- ``power`` [B, 257]: what ``stft.stft_power`` (K3) returns for the song's
  first ``n_frames`` frames.

NBF = L // 256 and NW = NBF - 1. On a CUDA tensor it launches both kernels
of ``csrc/fused_all.cu`` through K1's own entry point; on a CPU tensor it
runs ``fused_all_reference``, the plain versions of K2 and K3 composed.
"""

from __future__ import annotations

import torch

from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.kernels import fused_stats as fs
from bliss_tpu_torch.kernels import stft

# Launches of the CUDA kernels: one per fused_all_call on a CUDA tensor.
LAUNCHES = 0


def _check_inputs(samples, alpha, beta, n_frames, halo0, nb_bands, band_taps):
    fs.check_stats_inputs(samples, alpha, beta, halo0, nb_bands, band_taps, stft.FRAME)
    stft.check_power_inputs(samples, n_frames, None)


def fused_all_call(
    samples: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    n_frames: torch.Tensor,
    halo0: torch.Tensor | None = None,
    *,
    nb_bands: int = 1,
    band_taps: int = 17,
    filterbank: str = "firwin",
):
    """(wsum [B, NBF], rownz [B, NBF], energies [B, NB, NW], power [B, 257])
    of an int16 batch [B, L], L a multiple of 1024; ``alpha``/``beta``
    float32 [B] normalize the signal (xn = alpha*s + beta), ``n_frames``
    int32 [B] counts each song's spectrum frames and ``halo0`` (optional
    int16 [B, band_taps - 1]) is the raw history before sample 0, as for
    ``fused_stats_call``."""
    _check_inputs(samples, alpha, beta, n_frames, halo0, nb_bands, band_taps)
    if samples.device.type == "cpu":
        return fused_all_reference(
            samples, alpha, beta, n_frames, halo0, nb_bands=nb_bands,
            band_taps=band_taps, filterbank=filterbank,
        )
    if samples.device.type != "cuda":
        raise ValueError(f"no kernel for device {samples.device}")
    from bliss_tpu_torch.kernels import _build

    global LAUNCHES
    tabs = device_tables(nb_bands, band_taps, filterbank, samples.device)
    args, (wsum, rownz, stats) = fs.stats_launch_args(
        samples, alpha, beta, halo0, tabs, nb_bands, band_taps
    )
    part, ntiles = stft.power_scratch(samples)
    n_frames = n_frames.contiguous()
    _build.launch(
        "fused_all", "bliss_fused_all", samples.device, *args, n_frames.data_ptr(),
        tabs["dft"].data_ptr(), part.data_ptr(), ntiles,
    )
    LAUNCHES += 1
    return wsum, rownz, fs.assemble_energies(stats), stft.fold_power(part.sum(dim=1))


def fused_all_reference(
    samples: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    n_frames: torch.Tensor,
    halo0: torch.Tensor | None = None,
    *,
    nb_bands: int = 1,
    band_taps: int = 17,
    filterbank: str = "firwin",
):
    """Plain PyTorch version of ``fused_all_call``: ``fused_stats_reference``
    and ``stft.power_reference`` on the same inputs. Callers on the GPU must
    keep TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    _check_inputs(samples, alpha, beta, n_frames, halo0, nb_bands, band_taps)
    wsum, rownz, energies = fs.fused_stats_reference(
        samples, alpha, beta, halo0, nb_bands=nb_bands, band_taps=band_taps,
        filterbank=filterbank,
    )
    return wsum, rownz, energies, stft.power_reference(samples, n_frames)


def fused_all_stats(
    samples: torch.Tensor,
    n_samples: torch.Tensor,
    *,
    nb_bands: int = 1,
    band_taps: int = 17,
    filterbank: str = "firwin",
):
    """samples: int16 [B, L]; n_samples: int32 [B].

    Returns (amp_integral [B], energies [B, NB, NW], power [B, 257]): the
    prepass, the fused call, the trim bounds and the amplitude integral."""
    alpha, beta, _ = fs.normalization(samples, n_samples)
    wsum, rownz, energies, power = fused_all_call(
        samples, alpha, beta, stft.frame_counts(n_samples), nb_bands=nb_bands,
        band_taps=band_taps, filterbank=filterbank,
    )
    return fs.amplitude_integral(samples, wsum, rownz), energies, power
