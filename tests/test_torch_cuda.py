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
from bliss_tpu_torch.ablate import dma, fused as ablate_fused, matred, packread, probe
from bliss_tpu_torch.kernels import _build, fused_all, fused_stats, stft

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
# and the shortest and longest FIR the stats kernel takes
STATS_FILTERBANKS = FILTERBANKS + [(1, 2, "firwin"), (1, 129, "firwin")]
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


@pytest.mark.parametrize("nb_bands,taps,filterbank", STATS_FILTERBANKS)
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


def test_prepass_kernel_matches_plain(cuda):
    """The int64 sums identical to the plain version's, and so the mean and
    the variance: a song whose int32 sum wraps, a silent one, counts that
    are not multiples of 8."""
    rng = np.random.RandomState(8)
    L = 1 << 18
    x = rng.randint(-32768, 32768, size=(4, L)).astype(np.int16)
    x[1] = rng.randint(20000, 32768, size=L)
    x[2] = 0
    n = torch.tensor([L, L - 3, 1000, 99_999], dtype=torch.int32)
    xg = torch.from_numpy(x).to(cuda)
    before = fused_stats.PREPASS_LAUNCHES
    got = fused_stats.prepass_sums(xg, n.to(cuda))
    torch.cuda.synchronize()
    assert fused_stats.PREPASS_LAUNCHES == before + 1
    ref = fused_stats.prepass_sums(torch.from_numpy(x), n)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int64 and torch.equal(g.cpu(), r)
    assert int(ref[0][1]) > 2**31  # the int32 sum wraps
    mean, var = fused_stats.mean_variance(xg, n.to(cuda))
    mean_c, var_c = fused_stats.mean_variance(torch.from_numpy(x), n)
    assert torch.equal(mean.cpu(), mean_c) and torch.equal(var.cpu(), var_c)


def _ragged_songs():
    """Frame counts off the kernel's tile: 257 frames and 1000 samples, none
    (700 samples) and 129 frames."""
    rng = np.random.RandomState(9)
    lens = (257 * 1024 + 1000, 700, 129 * 1024)
    return [rng.randint(-32768, 32768, size=n).astype(np.int16) for n in lens], [12, 1, 6]


# id -> (songs, frame_offset)
POWER_CASES = {
    "none": (_songs, None), "0": (_songs, 0), "mid": (_songs, 60),
    "past": (_songs, 10_000), "ragged": (_ragged_songs, None),
}


@pytest.mark.parametrize("case", list(POWER_CASES))
def test_stft_power_kernel_matches_plain(cuda, case):
    make_songs, offset = POWER_CASES[case]
    batch = PCMBatch.from_arrays(*make_songs(), device=cuda)
    if case == "ragged":
        tile = _build.library("fused_all").bliss_power_tile()
        assert 257 % tile and 129 % tile
    before = _counters()
    got = stft.stft_power(batch.samples, batch.n_samples, frame_offset=offset)
    torch.cuda.synchronize()
    assert _counters() == (before[0], before[1], before[2] + 1)
    ref = stft.stft_power_reference(batch.samples, batch.n_samples, frame_offset=offset)
    if offset == 10_000:
        assert (got == 0).all() and (ref == 0).all()
        return
    peak = ref.amax(dim=1, keepdim=True)
    silent = peak[:, 0] == 0  # no frame counts: exactly zero
    assert (got[silent] == 0).all() and silent.sum() == (case == "ragged")
    assert ((got - ref).abs()[~silent] / peak[~silent]).max() < 1e-5


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


@pytest.mark.parametrize("cfg", [AnalysisConfig.for_gpu(), AnalysisConfig.for_gpu_hybrid()],
                         ids=["main", "hybrid"])
def test_streaming_on_gpu_matches_cpu(cuda, cfg):
    """A song streamed in five rows of 2^16 samples on the card: the CPU's
    vector (beat counts identical, the rest within 1e-3), through one
    prepass and one K1 (or K2 and K3) launch."""
    from bliss_tpu_torch.features.streaming import analyze_song_streaming

    song = _songs()[0][0]
    song = np.concatenate([song, song[::-1]])  # 300 000 samples
    before = _counters() + (fused_stats.PREPASS_LAUNCHES,)
    gpu = analyze_song_streaming(song, 6, cfg, 1 << 16, device=cuda)
    k1 = (1, 0, 0) if cfg.single_pass else (0, 1, 1)
    assert _counters() + (fused_stats.PREPASS_LAUNCHES,) == tuple(
        b + d for b, d in zip(before, k1 + (1,)))
    cpu = analyze_song_streaming(song, 6, cfg, 1 << 16, device="cpu")
    assert gpu[0] == cpu[0]
    np.testing.assert_allclose(gpu[1:], cpu[1:], rtol=0, atol=1e-3)


@pytest.mark.parametrize("cfg", [AnalysisConfig(), AnalysisConfig.for_parity()],
                         ids=["default", "parity"])
def test_streaming_an_xla_path_config_on_gpu_matches_cpu(cuda, cfg):
    """A song streamed under an XLA-path config in five rows of 2^16
    samples on the card: the CPU's vector (beat counts identical, the rest
    within 1e-3, 1e-5 in float64), through one prepass launch and no K1,
    K2 or K3."""
    from bliss_tpu_torch.features.streaming import analyze_song_streaming

    song = _songs()[0][0]
    song = np.concatenate([song, song[::-1]])  # 300 000 samples
    before = _counters() + (fused_stats.PREPASS_LAUNCHES,)
    gpu = analyze_song_streaming(song, 6, cfg, 1 << 16, device=cuda)
    assert _counters() + (fused_stats.PREPASS_LAUNCHES,) == before[:3] + (before[3] + 1,)
    cpu = analyze_song_streaming(song, 6, cfg, 1 << 16, device="cpu")
    assert gpu[0] == cpu[0]
    tol = 1e-5 if cfg.dtype == "float64" else 1e-3
    np.testing.assert_allclose(gpu[1:], cpu[1:], rtol=0, atol=tol)


@pytest.mark.parametrize("cfg", [AnalysisConfig.for_gpu(), TWO_KERNEL, AnalysisConfig.for_gpu_hybrid()],
                         ids=["main", "two_kernel", "hybrid"])
def test_extended_batch_on_gpu_matches_float64(cuda, cfg):
    """A small extended batch on the card: the core columns those of
    ``analyze_batch``; the 45 within EXTENDED_GATES of the same function
    with its per-frame stage in float64 on the card, and of the CPU's rows;
    bpm · duration / 60 the core's beat count; one prepass and one K1 (or
    K2 and K3) launch."""
    from bliss_tpu_torch.features import extended
    from bliss_tpu_torch.features.analyze import _device_stage_sums, analyze_batch_ext

    songs, durs = _songs()
    batch = PCMBatch.from_arrays(songs, durs, device=cuda)
    before = _counters() + (fused_stats.PREPASS_LAUNCHES,)
    rows = analyze_batch_ext(batch, cfg).cpu().numpy()
    k1 = (1, 0, 0) if cfg.single_pass else (0, 1, 1)
    assert _counters() + (fused_stats.PREPASS_LAUNCHES,) == tuple(
        b + d for b, d in zip(before, k1 + (1,)))
    np.testing.assert_array_equal(rows[:, :4], analyze_batch(batch, cfg).cpu().numpy())
    _, _, fa, sums = _device_stage_sums(batch, cfg)
    f64 = extended.extended_features(batch, cfg, fa=fa, sums=sums, dtype=torch.float64).cpu().numpy()
    cpu = analyze_batch_ext(PCMBatch.from_arrays(songs, durs, device="cpu"), cfg).numpy()
    dur = np.asarray(durs, np.float64)
    beats = np.rint((rows[:, 0].astype(np.float64) + 30.4) * dur / 4.0)
    np.testing.assert_allclose(rows[:, 9].astype(np.float64) * dur / 60.0, beats, rtol=1e-6)
    for ref in (f64, cpu[:, 4:]):
        for name, lo, hi, gate in extended.EXTENDED_GATES:
            d = np.abs(rows[:, 4 + lo : 4 + hi].astype(np.float64) - ref[:, lo:hi])
            assert d.max() * (dur.max() / 60.0 if lo == 5 else 1.0) <= gate, name


# ---- the measurement kernels A1-A3 (bliss_tpu_torch.ablate) -------------------


def _ablate_inputs(cuda):
    """B=3, L=32768: the scripts' uniform int16 with a silent stretch, and a
    full-range song; alpha, beta from the prepass."""
    rng = np.random.RandomState(4)
    x = rng.randint(-3000, 3000, size=(3, 32768)).astype(np.int16)
    x[0, :700] = 0
    x[2] = rng.randint(-32768, 32768, size=32768)
    x = torch.from_numpy(x).to(cuda)
    alpha, beta, _ = fused_stats.normalization(x, torch.full((3,), 32768, device=cuda))
    return x, alpha, beta


def _ablate_counters():
    return ablate_fused.LAUNCHES, probe.LAUNCHES, matred.LAUNCHES


def _max_err(got, ref, scale):
    return float(((got.double() - ref.double()).abs() / scale).max())


@pytest.mark.parametrize("variant", list(ablate_fused.VARIANTS))
def test_stats_variant_kernel_matches_plain(cuda, variant):
    """Rows s1..da within 1e-9 of the block's sum of z^2 (+1) in float64,
    1e-5 for the float32 FIR; wsum within 1e-5 of |ref| + 1; rownz equal."""
    x, a, b = _ablate_inputs(cuda)
    before = _ablate_counters()
    got = ablate_fused.stats_variant(x, a, b, variant, chunk=8192)
    torch.cuda.synchronize()
    assert _ablate_counters() == (before[0] + 1, before[1], before[2])
    ref = ablate_fused.stats_variant_reference(x, a, b, variant, chunk=8192)
    assert got.dtype == ref.dtype and got.shape == ref.shape == (3, 4, 8, 32)
    assert torch.equal(got[:, :, 7], ref[:, :, 7])
    assert _max_err(got[:, :, 6], ref[:, :, 6], ref[:, :, 6].abs() + 1.0) < 1e-5
    tol = 1e-5 if variant == "fir_fp32" else 1e-9
    assert _max_err(got[:, :, :6], ref[:, :, :6], ref[:, :, 1:2].double() + 1.0) < tol


PROBES = [("zero", torch.int16), ("slice", torch.int16), ("slice", torch.int32),
          ("slice", torch.float32), ("convert", torch.int16), ("sum1", torch.int16),
          ("sum1", torch.int32), ("sum1", torch.float32), ("sum6", torch.int16),
          ("packed", torch.int32)]


@pytest.mark.parametrize("mode,dtype", PROBES, ids=[f"{m}-{str(d)[6:]}" for m, d in PROBES])
def test_probe_kernel_matches_plain(cuda, mode, dtype):
    """Equal for int16 and float32 copies of int16 sums; within 1e-6 of the
    row's sum of |term| (+1) for squares and int32 words."""
    x, _, _ = _ablate_inputs(cuda)
    x = packread.packed_words(x) if mode == "packed" else x.to(dtype)
    rows, nblk = probe.rows(x, 8192 // (2 if mode == "packed" else 1))
    before = _ablate_counters()
    got = probe.probe(rows, nblk, mode)
    torch.cuda.synchronize()
    assert _ablate_counters() == (before[0], before[1] + 1, before[2])
    ref = probe.probe_reference(rows, nblk, mode)
    scale = probe.probe_reference(rows, nblk, mode, absolute=True).double() + 1.0
    assert got.shape == ref.shape
    if mode in ("sum6",) or dtype == torch.int32:
        assert _max_err(got, ref, scale) < 1e-6
    else:
        assert torch.equal(got, ref)


ALL_PROBES = [(m, d) for d in (torch.int16, torch.int32, torch.float32) for m in probe.MODES
              if m != "packed" or d == torch.int32]


@pytest.mark.parametrize("R,nblk", [(80, 40), (48, 16), (600, 300)], ids=["R80_nblk40", "R48_nblk16", "R600_nblk300"])
@pytest.mark.parametrize("mode,dtype", ALL_PROBES, ids=[f"{m}-{str(d)[6:]}" for m, d in ALL_PROBES])
def test_every_probe_mode_and_dtype_matches_plain(cuda, mode, dtype, R, nblk):
    """Every mode the kernel takes on every dtype, with stripes of 32 rows
    that end ragged (nblk not a multiple of 32): copies identical, sums of
    int16 values identical, other sums within 1e-6 of the row's sum of
    |term| (+1); full-range int32 words, so their float32 sums round."""
    rng = np.random.RandomState(9)
    if dtype == torch.int32:
        x = rng.randint(-2**31, 2**31 - 1, size=(3, R, 256), dtype=np.int64)
    else:
        x = rng.randint(-3000, 3000, size=(3, R, 256))
        x[1, : R // 2] = 0
    x = torch.from_numpy(x).to(dtype).to(cuda)
    before = _ablate_counters()
    got = probe.probe(x, nblk, mode)
    torch.cuda.synchronize()
    assert _ablate_counters() == (before[0], before[1] + 1, before[2])
    ref = probe.probe_reference(x, nblk, mode)
    assert got.shape == ref.shape == (3, R // nblk, 8, nblk)
    if mode in ("zero", "slice", "convert") or (mode in ("sum1", "packed") and dtype != torch.int32):
        assert torch.equal(got, ref)
    else:
        scale = probe.probe_reference(x, nblk, mode, absolute=True).double() + 1.0
        assert _max_err(got, ref, scale) < 1e-6


def test_script_wrappers_launch_the_probe(cuda):
    x, _, _ = _ablate_inputs(cuda)
    before = probe.LAUNCHES
    calls = [
        (ablate_fused.reduce_probe(x, "six_sums", chunk=8192),
         ablate_fused.reduce_probe_reference(x, "six_sums", chunk=8192)),
        (dma.call_noin(x, chunk=8192), dma.call_noin_reference(x, chunk=8192)),
        (dma.call_x(x, chunk=8192), dma.call_x_reference(x, chunk=8192)),
        (packread.call_i16(x, chunk=8192), packread.call_i16_reference(x, chunk=8192)),
    ]
    w = packread.packed_words(x)
    calls.append((packread.call_packed(w, chunk=8192), packread.call_packed_reference(w, chunk=8192)))
    torch.cuda.synchronize()
    assert probe.LAUNCHES == before + 5
    for got, ref in calls:
        assert got.shape == ref.shape and got.is_cuda
        assert torch.allclose(got, ref, rtol=1e-6, atol=1.0)


@pytest.mark.parametrize("fit", [(18, 200), (14, 128)], ids=["cheb18_200", "cheb14_128"])
def test_matred_kernel_matches_plain(cuda, fit):
    """Columns of z and delta within 1e-9 of the block's sum of z^2 (+1),
    wsum within 1e-5 of |ref| + 1, counts equal; with the shipped fit the
    energies assemble to the stats kernel's."""
    x, a, b = _ablate_inputs(cuda)
    before = _ablate_counters()
    got = matred.proto_call(x, a, b, *fit, chunk=8192)
    torch.cuda.synchronize()
    assert _ablate_counters() == (before[0], before[1], before[2] + 1)
    ref = matred.matred_reference(x, a, b, *fit, chunk=8192)
    assert got.shape == ref.shape == (3, 4, 32, 8)
    assert torch.equal(got[..., 7], ref[..., 7])
    assert _max_err(got[..., 6], ref[..., 6], ref[..., 6].abs() + 1.0) < 1e-5
    assert _max_err(got[..., :6], ref[..., :6], ref[..., 2:3] + 1.0) < 1e-9
    report = matred.numerics_report(x, a, b, *fit)
    assert report["rownz_agree"]
    if fit == (18, 200):
        assert report["energy_max_rel"] < 1e-9


@pytest.mark.parametrize("fit", [(18, 200), (14, 128)], ids=["cheb18_200", "cheb14_128"])
@pytest.mark.parametrize("taps", [2, 17, 129])
def test_matred_kernel_matches_plain_at_every_fir_length(cuda, taps, fit):
    """The shortest, the scripts' and the longest FIR A3 takes, with a
    ragged last run of 8 hop blocks (L = 35 * 256 + a second chunk) and a
    silent song: columns of z and delta within 1e-9 of |ref| plus the
    block's sum of z^2 (+1), wsum within 1e-5 of |ref| + 1, counts equal,
    NaN at the same places."""
    x, a, b = _ablate_inputs(cuda)
    L = 35 * 256
    x = x[:, :L].contiguous()
    x[1] = 0
    alpha, beta, _ = fused_stats.normalization(x, torch.full((3,), L, device=cuda))
    before = _ablate_counters()
    got = matred.proto_call(x, alpha, beta, *fit, chunk=L, taps=taps)
    torch.cuda.synchronize()
    assert _ablate_counters() == (before[0], before[1], before[2] + 1)
    ref = matred.matred_reference(x, alpha, beta, *fit, chunk=L, taps=taps)
    assert got.shape == ref.shape == (3, 1, 35, 8)
    assert torch.equal(torch.isnan(got), torch.isnan(ref)) and torch.isnan(ref[1]).all()
    ok = ~torch.isnan(ref[..., 0])
    g, r = got[ok], ref[ok]
    assert torch.equal(g[:, 7], r[:, 7])
    assert _max_err(g[:, 6], r[:, 6], r[:, 6].abs() + 1.0) < 1e-5
    assert _max_err(g[:, :6], r[:, :6], r[:, :6].abs() + r[:, 2:3] + 1.0) < 1e-9


def _library(n=20_000):
    rng = np.random.RandomState(6)
    f = (rng.randn(n, 4) * 3 + np.array([-10, -10, -10, -15])).astype(np.float32)
    f[n - 200 :] = f[:200]  # exact duplicates
    return f


def test_nearest_neighbors_all_on_gpu_matches_cpu(cuda):
    """float64 products on both: the same float32 distances, and the same
    neighbours wherever the CPU's row has no tie at that rank."""
    from bliss_tpu_torch import sim

    f = _library()
    gd, gi = sim.nearest_neighbors_all(f, 5, block=4096, device=cuda)
    cd, ci = sim.nearest_neighbors_all(f, 5, block=4096, device="cpu")
    gd, gi, cd, ci = gd.cpu().numpy(), gi.cpu().numpy(), cd.numpy(), ci.numpy()
    np.testing.assert_allclose(gd, cd, rtol=1e-6, atol=1e-6)
    padded = np.concatenate([np.full((len(f), 1), -np.inf), cd, np.full((len(f), 1), np.inf)], axis=1)
    clear = np.minimum(padded[:, 1:-1] - padded[:, :-2], padded[:, 2:] - padded[:, 1:-1]) > 1e-5
    np.testing.assert_array_equal(gi[clear], ci[clear])
    n = len(f)
    assert (gi[n - 200 :, 0] == np.arange(200)).all() and (gd[n - 200 :, 0] <= 1e-3).all()


def _knn_rows(n, d, seed=7, copies=200):
    """[n, d] float32 rows about -8 with sd 3, the last ``copies`` rows
    (when n >= 2 copies) exact copies of the first."""
    f = (np.random.RandomState(seed).randn(n, d) * 3 - 8).astype(np.float32)
    if n >= 2 * copies:
        f[n - copies :] = f[:copies]
    return f


def _check_knn_against_cpu(f, gd, gi, cd, ci):
    """Distances within 1e-6 of sqrt(|q|^2 + |f|^2), the scale of the Gram
    form's rounding (the CPU's twins read ~1e-6 where the card's read 0);
    indices equal wherever the CPU's row has no tie within 1e-5 at that
    rank; never the query's own row."""
    n, k = ci.shape
    sq = (f.astype(np.float64) ** 2).sum(1)
    scale = np.sqrt(sq[:, None] + sq[ci.astype(np.int64)])
    assert (np.abs(gd.astype(np.float64) - cd) <= 1e-6 * scale).all()
    padded = np.concatenate([np.full((n, 1), -np.inf), cd, np.full((n, 1), np.inf)], axis=1)
    clear = np.minimum(padded[:, 1:-1] - padded[:, :-2], padded[:, 2:] - padded[:, 1:-1]) > 1e-5
    np.testing.assert_array_equal(gi[clear], ci[clear])
    assert (gi != np.arange(n)[:, None]).all()


@pytest.mark.parametrize("n", [1, 2, 37, 4097, 20_000])
@pytest.mark.parametrize("d", [1, 3, 4, 5, 49, 64])
def test_knn_kernel_matches_the_cpu_path(cuda, n, d):
    """``nearest_neighbors_all`` on the card against the plain path on the
    CPU for k = 1, 5, K_MAX and K_MAX + 1 (clamped to N - 1): the kernel
    launches once a call for k <= K_MAX and not at all above, where the
    plain blocked path answers; the planted copies come first."""
    from bliss_tpu_torch import sim
    from bliss_tpu_torch.kernels import knn

    f = _knn_rows(n, d)
    for k in (1, 5, knn.K_MAX, knn.K_MAX + 1):
        keff = min(k, n - 1)
        before = knn.LAUNCHES
        gd, gi = sim.nearest_neighbors_all(f, k, device=cuda)
        torch.cuda.synchronize()
        assert knn.LAUNCHES - before == (1 if 1 <= keff <= knn.K_MAX else 0)
        cd, ci = sim.nearest_neighbors_all(f, k, device="cpu")
        assert gd.shape == cd.shape == (n, max(keff, 0)) and gi.dtype == torch.int32
        if keff <= 0:
            continue
        gd, gi = gd.cpu().numpy(), gi.cpu().numpy()
        _check_knn_against_cpu(f, gd, gi, cd.numpy(), ci.numpy())
        if n >= 400:
            twins = np.concatenate([np.arange(n - 200, n), np.arange(200)])
            rows = np.concatenate([np.arange(200), np.arange(n - 200, n)])
            assert (gi[rows, 0] == twins).all() and (gd[rows, 0] <= 1e-3).all()


@pytest.mark.parametrize("d", [1, 4, 5, 49, 64])
def test_knn_kernel_is_bit_equal_on_exact_rows(cuda, d):
    """Dyadic rows, every product and sum exact, ties everywhere: the
    kernel's distances and indices equal the plain version's on the card bit
    for bit, ties in index order; the indices equal the CPU path's, and the
    distances are the correctly rounded float32 square roots of the exact
    d^2 (the CPU's vectorized float32 sqrt is 1 ulp off on some)."""
    from bliss_tpu_torch import sim
    from bliss_tpu_torch.sim.distance import _block_topk

    f = (np.random.RandomState(5).randint(-3, 4, size=(4097, d)) / 2).astype(np.float32)
    g64 = torch.from_numpy(f).to(cuda).double()
    f64 = f.astype(np.float64)
    for k in (1, 7, 32):
        gd, gi = sim.nearest_neighbors_all(f, k, device=cuda)
        parts = [_block_topk(g64[b0 : b0 + 4096], g64, b0, k) for b0 in range(0, len(f), 4096)]
        assert torch.equal(gd, torch.cat([p[0] for p in parts])) and torch.equal(gi, torch.cat([p[1] for p in parts]))
        _, ci = sim.nearest_neighbors_all(f, k, device="cpu")
        gd, gi = gd.cpu().numpy(), gi.cpu().numpy()
        np.testing.assert_array_equal(gi, ci.numpy())
        exact = ((f64[:, None, :] - f64[gi]) ** 2).sum(-1).astype(np.float32)
        np.testing.assert_array_equal(gd, np.sqrt(exact))


def test_knn_kernel_answers_a_row_whatever_shares_its_launch(cuda):
    """``block`` 1, 7 and 4096 and the mesh's shards on one card give the
    same answers bit for bit, and so does any run of rows."""
    from bliss_tpu_torch import sim
    from bliss_tpu_torch.parallel import analysis_mesh, sharded_distance_topk
    from bliss_tpu_torch.sim.distance import topk_rows

    f = _knn_rows(5000, 49)
    d0, i0 = sim.nearest_neighbors_all(f, 5, block=4096, device=cuda)
    for block in (1, 7):
        d, i = sim.nearest_neighbors_all(f, 5, block=block, device=cuda)
        assert torch.equal(d, d0) and torch.equal(i, i0)
    for shape in ((1, 1), (3, 1)):
        mesh = analysis_mesh(*shape, devices=[cuda] * (shape[0] * shape[1]))
        d, i = sharded_distance_topk(f, mesh, 5, block=7)
        assert torch.equal(d, d0.cpu()) and torch.equal(i, i0.cpu())
    g = torch.from_numpy(f).to(cuda)
    for r0, r1 in ((0, 1), (13, 20), (777, 2777), (4999, 5000)):
        d, i = topk_rows(g, r0, r1, 5)
        assert torch.equal(d, d0[r0:r1]) and torch.equal(i, i0[r0:r1])


@pytest.mark.parametrize("value", [np.inf, np.nan, -np.inf, "negative_nan"])
def test_knn_kernel_on_nonfinite_rows_gives_the_cpu_indices(cuda, value):
    """A row with an inf, a NaN, a -inf or a negative NaN tempo: the call
    returns, with the CPU path's indices and NaN pattern (a NaN d^2 sorts by
    its sign bit on both: csrc/knn.cu)."""
    from bliss_tpu_torch import sim

    f = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    f[3, 0] = np.array([0xFFC00000], np.uint32).view(np.float32)[0] if value == "negative_nan" else value
    big = _knn_rows(3000, 4)
    big[17, 2] = f[3, 0]
    for rows, k in ((f, 3), (big, 5)):
        gd, gi = sim.nearest_neighbors_all(rows, k, device=cuda)
        torch.cuda.synchronize()
        cd, ci = sim.nearest_neighbors_all(rows, k, device="cpu")
        np.testing.assert_array_equal(gi.cpu().numpy(), ci.numpy())
        np.testing.assert_array_equal(np.isnan(gd.cpu().numpy()), np.isnan(cd.numpy()))


def test_knn_call_runs_only_its_kernels_in_memory_of_its_inputs(cuda):
    """At N = 100 000, D = 49: a call launches the pre-pass and the search
    and nothing else (no top-k, no elementwise pass, no GEMM), and its peak
    device memory is the padded rows, the norms and the answers, not a
    [block, N] matrix."""
    from torch.profiler import ProfilerActivity, profile

    from bliss_tpu_torch import sim

    n, d, k = 100_000, 49, 5
    g = torch.from_numpy(_knn_rows(n, d)).to(cuda)
    sim.nearest_neighbors_all(g, k)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.nearest_neighbors_all(g, k)
        torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= 2 * (n * 52 * 4 + n * 8 + n * k * 8) + (1 << 21), extra
    kernels = {e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert kernels and all("knn" in name for name in kernels), kernels


def test_kmeans_on_gpu_matches_cpu_lloyd_from_the_same_init(cuda):
    from bliss_tpu_torch import sim
    from bliss_tpu_torch.sim.kmeans import assign, init_centroids, lloyd

    f = _library()
    g = torch.from_numpy(f).to(cuda)
    c, a = sim.kmeans(g, 16, iters=30, seed=3)
    c2, a2 = sim.kmeans(g, 16, iters=30, seed=3)
    assert torch.equal(c, c2) and torch.equal(a, a2)
    start = init_centroids(g, 16, seed=3)
    rows = {tuple(r) for r in f.tolist()}
    assert len({tuple(r) for r in start.cpu().tolist()} & rows) == 16
    cc = lloyd(torch.from_numpy(f), start.cpu(), iters=30)
    assert (c.cpu() - cc).abs().max() <= 1e-5 * cc.abs().max()
    assert torch.equal(a.cpu(), assign(torch.from_numpy(f), cc))


def test_daemon_on_gpu_analyzes_through_the_kernels(cuda, tmp_path, monkeypatch):
    """The daemon on the card: warmup launches the prepass and K1, an
    analyze op over a socket launches them again and gives analyze_pcm's
    rows, and status names the card. The card's machine has no libav, so
    the written FLAC files are 'decoded' to the PCM they were written
    from."""
    import threading

    from bliss_tpu_torch import api, pipeline
    from bliss_tpu_torch.io import DecodedAudio
    from bliss_tpu_torch.io.flac_writer import write_flac
    from bliss_tpu_torch.server import AnalysisServer, request

    songs, durs = _songs()
    files = [str(tmp_path / f"song{i}.flac") for i in range(len(songs))]
    pcm = {}
    for f, s, d in zip(files, songs, durs):
        write_flac(f, s.reshape(-1, 2), 22050)
        pcm[f] = DecodedAudio(s, 2, 22050, 0, 2, 0, d, f, "", "", "", "", "")
    monkeypatch.setattr(pipeline, "iter_decode", lambda paths, **kw: ((p, pcm[p]) for p in paths))
    buckets = len({pipeline._bucket_length(s.shape[0], 1024) for s in songs})  # a batch each
    sock = str(tmp_path / "s.sock")
    server = AnalysisServer(sock, batch_size=2, device=cuda)
    before = (fused_stats.PREPASS_LAUNCHES, fused_all.LAUNCHES)
    server.warmup(seconds=1.0)
    assert fused_stats.PREPASS_LAUNCHES == before[0] + 1 and fused_all.LAUNCHES == before[1] + 1
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    assert server.wait_ready(30)
    try:
        r = request({"op": "analyze", "paths": files}, sock, timeout=120)
        assert r["ok"] and r["errors"] == {}
        assert fused_stats.PREPASS_LAUNCHES == before[0] + 1 + buckets
        assert fused_all.LAUNCHES == before[1] + 1 + buckets
        got = np.array([r["features"][f] for f in files], np.float32)
        ref = api.analyze_pcm(songs, durs, device=cuda)
        assert np.array_equal(got[:, 0], ref[:, 0])
        np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=0, atol=1e-3)
        st = request({"op": "status"}, sock, timeout=30)
        assert st["backend"] == "cuda" and st["devices"] == torch.cuda.device_count()
        assert st["backend_health"]["healthy"]
    finally:
        server.stop()
        t.join(timeout=30)
    assert not t.is_alive()


def _mesh_batch(device):
    """Two songs whose 2-way sequence shards (81 920 samples) take the
    kernels."""
    songs, durs = _songs()
    return PCMBatch.from_arrays(songs, durs, pad_multiple=1024 * 160, device=device)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_mesh_on_gpu_launches_k2_k3_a_shard_and_matches_cpu(cuda, shape):
    """The mesh over ``cuda`` repeated: the prepass, K2 and K3 once a shard;
    the rows are the unsharded GPU rows' (beats identical, the rest within
    5e-4) and the CPU mesh's (within 1e-4)."""
    from bliss_tpu_torch.parallel import analysis_mesh, analyze_sharded

    cfg = AnalysisConfig.for_gpu()
    n = shape[0] * shape[1]
    before = (fused_stats.PREPASS_LAUNCHES, fused_stats.LAUNCHES, stft.LAUNCHES)
    got = analyze_sharded(_mesh_batch(cuda), analysis_mesh(*shape, devices=[cuda] * n), cfg)
    after = (fused_stats.PREPASS_LAUNCHES, fused_stats.LAUNCHES, stft.LAUNCHES)
    # a (2, 2) mesh pads the two songs to one a data row: 2 x 2 shards
    assert tuple(a - b for a, b in zip(after, before)) == (n, n, n)
    flat = analyze_batch(_mesh_batch(cuda), cfg).cpu().numpy()
    assert np.array_equal(got[:, 0], flat[:, 0])
    np.testing.assert_allclose(got, flat, rtol=0, atol=5e-4)
    on_cpu = analyze_sharded(_mesh_batch("cpu"), analysis_mesh(*shape, devices=["cpu"] * n), cfg)
    assert np.array_equal(got[:, 0], on_cpu[:, 0])
    np.testing.assert_allclose(got, on_cpu, rtol=0, atol=1e-4)


def test_nccl_process_group_of_one_matches_the_local_mesh(cuda, tmp_path):
    """``init_distributed`` on a file store at world size 1 with NCCL: the
    (1, 1) mesh over the ``ProcessGroup`` gives the ``LocalGroup`` mesh's
    rows bit for bit."""
    import torch.distributed as tdist

    from bliss_tpu_torch.parallel import analysis_mesh, analyze_sharded_async
    from bliss_tpu_torch.parallel.distributed import init_distributed, process_mesh

    cfg = AnalysisConfig.for_gpu()
    init_distributed(f"file://{tmp_path / 'store'}", 1, 0, device=cuda)
    assert tdist.is_initialized() and tdist.get_backend() == "nccl"
    try:
        mesh = process_mesh(1, cuda)
        assert mesh.process is not None
        got = analyze_sharded_async(_mesh_batch(cuda), mesh, cfg, extended=True)()
    finally:
        tdist.destroy_process_group()
    want = analyze_sharded_async(_mesh_batch(cuda), analysis_mesh(1, 1, devices=[cuda]), cfg,
                                 extended=True)()
    assert np.array_equal(got, want)


def test_c_library_on_gpu_analyzes_through_the_kernels(cuda, tmp_path, monkeypatch):
    """``libbliss.so`` loaded into this process, ``gpu`` mode on the card:
    each ``bl_analyze`` launches the prepass and K1 once and gives
    ``analyze_pcm``'s row (beats identical, the rest within 5e-4). The
    card's machine has no libav, so decode hands back the PCM each file
    name stands for."""
    import ctypes

    from bliss_tpu_torch import api, compat
    from bliss_tpu_torch.io import DecodedAudio, decoder

    songs, durs = _songs()
    pcm = {f"song{i}.flac": DecodedAudio(s, 2, 22050, 0, 2, 0, d, f"song{i}.flac", "", "", "", "", "")
           for i, (s, d) in enumerate(zip(songs, durs))}
    monkeypatch.setattr(decoder, "decode", lambda path: pcm[path])
    monkeypatch.setenv("BLISS_TPU_TORCH_COMPAT_MODE", "gpu")
    monkeypatch.delenv("BLISS_TPU_TORCH_DEVICE", raising=False)  # cuda
    lib = compat.load()
    rows = []
    for name in pcm:
        song = compat.BlSong()
        before = (fused_stats.PREPASS_LAUNCHES, fused_all.LAUNCHES)
        assert lib.bl_analyze(name.encode(), ctypes.byref(song)) != -2
        assert (fused_stats.PREPASS_LAUNCHES, fused_all.LAUNCHES) == (before[0] + 1, before[1] + 1)
        v = song.force_vector
        rows.append([v.tempo, v.amplitude, v.frequency, v.attack])
        lib.bl_free_song(ctypes.byref(song))
    got = np.array(rows, np.float32)
    ref = np.concatenate([api.analyze_pcm([s], [d], device=cuda) for s, d in zip(songs, durs)])
    assert np.array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=0, atol=5e-4)


@pytest.mark.parametrize("mode", ["device_exact", "hybrid"])
def test_fuzz_on_gpu_finds_no_divergence(cuda, mode):
    from bliss_tpu_torch import fuzz

    before = (fused_stats.PREPASS_LAUNCHES, fused_all.LAUNCHES, fused_stats.LAUNCHES)
    res = fuzz.run_batched_device_fuzz(16, mode, device=cuda, verbose=False)
    assert (res["cases"], res["divergent"]) == (16, 0), res
    launched = [a - b for a, b in zip((fused_stats.PREPASS_LAUNCHES, fused_all.LAUNCHES,
                                       fused_stats.LAUNCHES), before)]
    assert launched[0] and (launched[1] if mode == "device_exact" else launched[2]), launched
