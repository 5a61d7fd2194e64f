"""The port's CUDA kernel against its plain version, on an NVIDIA GPU.

Marked ``cuda``; skips where no GPU is present. On a machine with a card
and no JAX:  python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features.analyze import analyze_batch
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import fused_all

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused_all kernel is CUDA only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _songs():
    rng = np.random.RandomState(2)
    t = np.arange(150_000)
    a = 9000 * np.sin(2 * np.pi * t / 37.0) + 800 * rng.randn(t.size)
    a[:3000] = 0
    a[-3000:] = 0
    b = rng.randint(-32768, 32768, size=131_072)
    return [a.astype(np.int16), b.astype(np.int16)], [3, 2]


@pytest.mark.parametrize("nb_bands,taps,filterbank", [(1, 17, "firwin"), (5, 17, "reference5"), (36, 33, "reference36")])
def test_kernel_matches_plain(cuda, nb_bands, taps, filterbank):
    songs, durs = _songs()
    batch = PCMBatch.from_arrays(songs, durs, device=cuda)
    alpha, beta, _ = fused_all.normalization(batch.samples, batch.n_samples)
    nf = (batch.n_samples // 1024).to(torch.int32)
    kw = dict(nb_bands=nb_bands, band_taps=taps, filterbank=filterbank)
    before = fused_all.LAUNCHES
    kw_, kr, ke, kp = fused_all.fused_all_call(batch.samples, alpha, beta, nf, **kw)
    torch.cuda.synchronize()
    assert fused_all.LAUNCHES == before + 1
    pw, pr, pe, pp = fused_all.fused_all_reference(batch.samples, alpha, beta, nf, **kw)
    assert torch.equal(kr, pr)
    assert ((kw_ - pw).abs() / (pw.abs() + 1.0)).max() < 1e-5
    assert ((ke - pe).abs() / (pe.abs() + 1e-3)).max() < 1e-9
    assert ((kp - pp).abs() / pp.amax(dim=1, keepdim=True)).max() < 1e-5


def test_main_path_on_gpu_matches_cpu(cuda):
    songs, durs = _songs()
    cfg = AnalysisConfig.for_gpu()
    gpu = analyze_batch(PCMBatch.from_arrays(songs, durs, device=cuda), cfg).cpu().numpy()
    cpu = analyze_batch(PCMBatch.from_arrays(songs, durs, device="cpu"), cfg).numpy()
    assert np.array_equal(gpu[:, 0], cpu[:, 0])
    np.testing.assert_allclose(gpu[:, 1:], cpu[:, 1:], rtol=0, atol=1e-3)
