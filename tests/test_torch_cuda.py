"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked ``cuda``; skips where no GPU is present. On a machine with a card
and no JAX:  python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features.analyze import analyze_batch, analyze_batch_hybrid
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import fused_all, fused_stats, stft

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels are CUDA only")
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


FILTERBANKS = [(1, 17, "firwin"), (5, 17, "reference5"), (36, 33, "reference36")]
TWO_KERNEL = AnalysisConfig(
    dtype="float32", amplitude_mode="poly", tempo_finish="device_exact", fused_kernel=True
)


@pytest.mark.parametrize("nb_bands,taps,filterbank", FILTERBANKS)
def test_kernel_matches_plain(cuda, nb_bands, taps, filterbank):
    songs, durs = _songs()
    batch = PCMBatch.from_arrays(songs, durs, device=cuda)
    alpha, beta, _ = fused_stats.normalization(batch.samples, batch.n_samples)
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


def _counters():
    return fused_all.LAUNCHES, fused_stats.LAUNCHES, stft.LAUNCHES


@pytest.mark.parametrize("nb_bands,taps,filterbank", FILTERBANKS)
@pytest.mark.parametrize("with_halo", [False, True], ids=["no_halo", "halo0"])
def test_fused_stats_kernel_matches_plain(cuda, nb_bands, taps, filterbank, with_halo):
    songs, durs = _songs()
    batch = PCMBatch.from_arrays(songs, durs, device=cuda)
    alpha, beta, _ = fused_stats.normalization(batch.samples, batch.n_samples)
    halo0 = None
    if with_halo:
        rng = np.random.RandomState(taps)
        halo0 = torch.from_numpy(
            rng.randint(-20000, 20000, size=(2, taps - 1)).astype(np.int16)
        ).to(cuda)
    kw = dict(nb_bands=nb_bands, band_taps=taps, filterbank=filterbank)
    before = _counters()
    kw_, kr, ke = fused_stats.fused_stats_call(batch.samples, alpha, beta, halo0, **kw)
    torch.cuda.synchronize()
    assert _counters() == (before[0], before[1] + 1, before[2])
    pw, pr, pe = fused_stats.fused_stats_reference(batch.samples, alpha, beta, halo0, **kw)
    assert torch.equal(kr, pr)
    assert ((kw_ - pw).abs() / (pw.abs() + 1.0)).max() < 1e-5
    assert ((ke - pe).abs() / (pe.abs() + 1e-3)).max() < 1e-9
    if with_halo:  # the same history through K1's entry point
        nf = stft.frame_counts(batch.n_samples)
        _, _, e1, _ = fused_all.fused_all_call(batch.samples, alpha, beta, nf, halo0, **kw)
        assert ((e1 - pe).abs() / (pe.abs() + 1e-3)).max() < 1e-9


@pytest.mark.parametrize("offset", [None, 0, 60, 10_000], ids=["none", "0", "mid", "past"])
def test_stft_power_kernel_matches_plain(cuda, offset):
    songs, durs = _songs()
    batch = PCMBatch.from_arrays(songs, durs, device=cuda)
    before = _counters()
    got = stft.stft_power(batch.samples, batch.n_samples, frame_offset=offset)
    torch.cuda.synchronize()
    assert _counters() == (before[0], before[1], before[2] + 1)
    ref = stft.stft_power_reference(batch.samples, batch.n_samples, frame_offset=offset)
    if offset == 10_000:
        assert (got == 0).all() and (ref == 0).all()
        return
    peak = ref.amax(dim=1, keepdim=True)
    assert ((got - ref).abs() / peak).max() < 1e-5


def test_two_kernel_and_hybrid_on_gpu_match_cpu(cuda):
    songs, durs = _songs()
    for cfg in (TWO_KERNEL, AnalysisConfig.for_gpu_hybrid()):
        gpu = analyze_batch(PCMBatch.from_arrays(songs, durs, device=cuda), cfg).cpu().numpy()
        cpu = analyze_batch(PCMBatch.from_arrays(songs, durs, device="cpu"), cfg).numpy()
        assert np.array_equal(gpu[:, 0], cpu[:, 0])
        np.testing.assert_allclose(gpu[:, 1:], cpu[:, 1:], rtol=0, atol=1e-3)


def test_each_path_launches_only_its_own_kernels(cuda):
    batch = PCMBatch.from_arrays(*_songs(), device=cuda)
    before = _counters()
    analyze_batch(batch, AnalysisConfig.for_gpu())
    torch.cuda.synchronize()
    assert _counters() == (before[0] + 1, before[1], before[2])
    before = _counters()
    analyze_batch(batch, TWO_KERNEL)
    analyze_batch_hybrid(batch, AnalysisConfig.for_gpu_hybrid())
    torch.cuda.synchronize()
    assert _counters() == (before[0], before[1] + 2, before[2] + 2)
