"""The state carried across from the JAX package.

This system has no weights: its state is the constant tables and the
analysis config. ``tables_from_numpy`` turns a dict of NumPy tables into the
device-resident tensors the kernels, their plain versions and the XLA-path
stage (``features/amplitude.py``, ``frequency.py``, ``tempo.py``) read;
``config_from_reference`` rebuilds an ``AnalysisConfig`` from the JAX
package's config as ``dataclasses.asdict`` gives it. ``extended_tables``
puts the extended features' tables (``features/extended.py``) on a device. The tests feed both with
what ``bliss_tpu`` itself built; at run time ``device_tables`` feeds them
from this package's own ``tables.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bliss_tpu_torch import tables
from bliss_tpu_torch.config import AnalysisConfig

# The kernels' tempo tables stay float64 (FIR, warm-up correction and the
# IIR block operators); their amplitude and spectrum tables are float32.
# The XLA-path stage takes every table in its config's dtype instead.
FLOAT64_TABLES = ("fir", "warm", "iir_L", "iir_Z", "iir_M", "iir_N")


def reference_arrays(
    nb_bands: int, band_taps: int, filterbank: str, iir_block: int = 256
) -> dict[str, np.ndarray]:
    """The NumPy tables the kernel path and the XLA-path stage read, keyed as
    ``tables_from_numpy`` expects: the XLA path's amplitude weight table
    (``amp_table``), its zero-Nyquist real DFT (``rdft_re``, ``rdft_im``)
    and the Parseval sign pattern (``alt``) besides the kernels' tables."""
    # stft imports this module
    from bliss_tpu_torch.kernels.stft import fft_twiddles, hann_dft_table

    _, _, c_pos = tables.amplitude_cdf_poly()
    L, Z, M, N = tables.iir_block_operator(iir_block)
    rdft_re, rdft_im = tables.rdft_matrices(zero_nyquist=True)
    return {
        "cheb": c_pos,
        "fir": tables.bandpass_filterbank(nb_bands, band_taps, filterbank),
        "warm": tables.fir_warmup_correction(nb_bands, band_taps, filterbank),
        "dft": hann_dft_table(),
        "twiddle": fft_twiddles(),
        "hann": tables.hann_window(),
        "iir_L": L,
        "iir_Z": Z,
        "iir_M": M,
        "iir_N": N,
        "amp_table": tables.amplitude_weight_table(),
        "rdft_re": rdft_re,
        "rdft_im": rdft_im,
        "alt": tables.parseval_alt_sign(),
    }


def tables_from_numpy(
    arrays: dict[str, np.ndarray], device, dtype: torch.dtype | None = None
) -> dict[str, torch.Tensor]:
    """Contiguous device tensors of ``arrays``: all in ``dtype`` when it is
    given (the XLA-path stage's working dtype); else float64 for the names
    in ``FLOAT64_TABLES`` and float32 for everything else (the kernels')."""
    out = {}
    for name, a in arrays.items():
        want = dtype or (torch.float64 if name in FLOAT64_TABLES else torch.float32)
        out[name] = torch.as_tensor(
            np.ascontiguousarray(a), dtype=want
        ).to(device).contiguous()
    return out


@functools.lru_cache(maxsize=32)
def _cached_tables(nb_bands, band_taps, filterbank, iir_block, device, dtype):
    arrays = reference_arrays(nb_bands, band_taps, filterbank, iir_block)
    return tables_from_numpy(arrays, device, dtype)


def device_tables(
    nb_bands: int, band_taps: int, filterbank: str, device, iir_block: int = 256,
    dtype: torch.dtype | None = None,
) -> dict[str, torch.Tensor]:
    """Per-device cache of the tables: the kernels' dtypes by default, every
    table in ``dtype`` when it is given."""
    return _cached_tables(
        nb_bands, band_taps, filterbank, iir_block, torch.device(device), dtype
    )


@functools.lru_cache(maxsize=16)
def _cached_extended(device, dtype):
    from bliss_tpu_torch.features import extended  # extended imports this module

    return {
        name: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device).contiguous()
        for name, a in extended.reference_arrays().items()
    }


def extended_tables(device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Per-device cache of the extended features' tables in ``dtype``
    (float32 on the main path, float64 for its float64 variant)."""
    return _cached_extended(torch.device(device), dtype)


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
