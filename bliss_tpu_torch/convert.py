"""The state carried across from the JAX package.

This system has no weights: its state is the constant tables and the
analysis config. ``tables_from_numpy`` turns a dict of NumPy tables into the
device-resident tensors the kernel and the plain versions read;
``config_from_reference`` rebuilds an ``AnalysisConfig`` from the JAX
package's config as ``dataclasses.asdict`` gives it. The tests feed both with
what ``bliss_tpu`` itself built; at run time ``device_tables`` feeds them
from this package's own ``tables.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bliss_tpu_torch import tables
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.kernels.stft import hann_dft_table

# The tempo path's tables stay float64 (FIR, warm-up correction and the
# IIR block operators); the amplitude and spectrum tables are float32.
FLOAT64_TABLES = ("fir", "warm", "iir_L", "iir_Z", "iir_M", "iir_N")


def reference_arrays(
    nb_bands: int, band_taps: int, filterbank: str, iir_block: int = 256
) -> dict[str, np.ndarray]:
    """The NumPy tables the main path reads, keyed as ``tables_from_numpy``
    expects."""
    _, _, c_pos = tables.amplitude_cdf_poly()
    L, Z, M, N = tables.iir_block_operator(iir_block)
    return {
        "cheb": c_pos,
        "fir": tables.bandpass_filterbank(nb_bands, band_taps, filterbank),
        "warm": tables.fir_warmup_correction(nb_bands, band_taps, filterbank),
        "dft": hann_dft_table(),
        "iir_L": L,
        "iir_Z": Z,
        "iir_M": M,
        "iir_N": N,
    }


def tables_from_numpy(
    arrays: dict[str, np.ndarray], device
) -> dict[str, torch.Tensor]:
    """Contiguous device tensors of ``arrays``: float64 for the names in
    ``FLOAT64_TABLES``, float32 for everything else."""
    out = {}
    for name, a in arrays.items():
        dtype = torch.float64 if name in FLOAT64_TABLES else torch.float32
        out[name] = torch.as_tensor(
            np.ascontiguousarray(a), dtype=dtype
        ).to(device).contiguous()
    return out


@functools.lru_cache(maxsize=16)
def _cached_tables(nb_bands, band_taps, filterbank, iir_block, device):
    arrays = reference_arrays(nb_bands, band_taps, filterbank, iir_block)
    return tables_from_numpy(arrays, device)


def device_tables(
    nb_bands: int, band_taps: int, filterbank: str, device, iir_block: int = 256
) -> dict[str, torch.Tensor]:
    """Per-device cache of the main path's tables."""
    return _cached_tables(
        nb_bands, band_taps, filterbank, iir_block, torch.device(device)
    )


def config_from_reference(d: dict) -> AnalysisConfig:
    """``AnalysisConfig`` from ``dataclasses.asdict`` of the JAX package's
    config; unknown or missing fields raise."""
    fields = {f.name for f in AnalysisConfig.__dataclass_fields__.values()}
    if set(d) != fields:
        raise ValueError(
            f"config fields differ: extra {sorted(set(d) - fields)}, "
            f"missing {sorted(fields - set(d))}"
        )
    return AnalysisConfig(**d)
