"""The reference author's filterbanks (``filterbank="reference5"``, 5x17, and
``"reference36"``, 36x33) through the port's kernels on the batch, hybrid
and streamed routes, against ``bliss_tpu``'s float64 ``for_parity()`` with
the same filterbank: beats identical, the other columns within 5e-4.

The port's kernel path runs the tempo FIR and its sums in float64 (F1), so
it is held to the parity config, not to ``bliss_tpu``'s float32
``for_tpu()``, whose attack lies up to 9.8e-4 from parity at reference36
(ROADMAP "traps")."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_slice import _songs
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features.analyze import analyze_batch_jit

from bliss_tpu_torch.config import AnalysisConfig, uses_kernels
from bliss_tpu_torch.features import streaming
from bliss_tpu_torch.features.analyze import analyze_batch, analyze_batch_hybrid
from bliss_tpu_torch.features.types import PCMBatch

torch.set_num_threads(1)

TOL = 5e-4  # tests/test_golden.py:28
CHUNK = 16_384  # four rows a song, each with its halo0


@pytest.fixture(scope="module")
def parity_rows():
    """bliss_tpu's for_parity() rows of the songs, by filterbank."""
    songs, durs = _songs()
    batch = JBatch.from_arrays(songs, durs)
    return {fb: np.asarray(analyze_batch_jit(
        batch, dataclasses.replace(JConfig.for_parity(), filterbank=fb, nb_bands=None, band_taps=None)))
        for fb in ("reference5", "reference36")}


def _port_rows(route, cfg):
    songs, durs = _songs()
    if route == "streamed":
        return np.stack([streaming.analyze_song_streaming(s, d, cfg, CHUNK, device="cpu")
                         for s, d in zip(songs, durs)])
    batch = PCMBatch.from_arrays(songs, durs, device="cpu")
    if route == "hybrid":
        return analyze_batch_hybrid(batch, cfg).numpy()
    return analyze_batch(batch, cfg).numpy()


@pytest.mark.parametrize("route", ["batch", "hybrid", "streamed"])
@pytest.mark.parametrize("filterbank", ["reference5", "reference36"])
def test_reference_filterbank_matches_parity(parity_rows, filterbank, route):
    base = AnalysisConfig.for_gpu_hybrid() if route == "hybrid" else AnalysisConfig.for_gpu()
    cfg = dataclasses.replace(base, filterbank=filterbank, nb_bands=None, band_taps=None)
    assert uses_kernels(cfg) and streaming.streaming_supports(cfg)
    assert (cfg.nb_bands, cfg.band_taps) == {"reference5": (5, 17), "reference36": (36, 33)}[filterbank]
    port, ref = _port_rows(route, cfg), parity_rows[filterbank]
    assert port.shape == ref.shape == (3, 4) and np.isfinite(port).all()
    assert np.array_equal(port[:, 0], ref[:, 0]), (port[:, 0], ref[:, 0])  # beats
    np.testing.assert_allclose(port[:, 1:], ref[:, 1:], rtol=0, atol=TOL)
