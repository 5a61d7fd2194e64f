"""The port's two-kernel and hybrid paths against bliss_tpu: the sample-stats
kernel K2 (``fused_stats``) and the spectrum kernel K3 (``stft_power``),
their plain versions (which a CPU tensor runs) against the JAX kernels in
Pallas interpret mode, the sequence-shard parameters ``halo0`` and
``frame_offset``, the float64 host finish, and both configs end to end."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import synth_pcm
from bliss_tpu import constants as JC
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features.analyze import (
    _mask_energies as j_mask_energies,
    analyze_batch_hybrid as j_analyze_batch_hybrid,
    analyze_batch_jit,
)
from bliss_tpu.features.tempo import envelope_finish_host as j_envelope_finish_host
from bliss_tpu.kernels import fused_sample_stats as j_fused_sample_stats
from bliss_tpu.kernels.fused_stats import (
    fused_stats_call as j_fused_stats_call,
    trim_bounds_from_rownz as j_trim,
)
from bliss_tpu.kernels.pallas_stft import stft_power as j_stft_power

import bliss_tpu_torch
from bliss_tpu_torch import api
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features import analyze as tanalyze
from bliss_tpu_torch.features.analyze import (
    _mask_energies,
    analyze_batch,
    analyze_batch_hybrid,
)
from bliss_tpu_torch.features.extended import extended_features
from bliss_tpu_torch.features.tempo import envelope_finish_host
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import fused_all, fused_stats, stft

torch.set_num_threads(1)
# the plain versions' matmuls in full float32 wherever a GPU runs them
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the two-kernel config with the device finish: for_tpu() with
# single_pass=False
TWO_KERNEL = dict(
    dtype="float32", amplitude_mode="poly", tempo_finish="device_exact",
    fused_kernel=True,
)
BANDS = {
    "1band": dict(nb_bands=1, band_taps=17, filterbank="firwin"),
    "reference5": dict(nb_bands=5, band_taps=17, filterbank="reference5"),
}


def _songs():
    """Tonal + noise songs with silent edges and a periodic decaying click,
    so the envelope has real beats (as tests/test_torch_tempo.py)."""
    rng = np.random.RandomState(7)
    out = []
    for n, period in ((90_000, 9_000), (81_920, 11_000), (66_561, 7_000)):
        s = synth_pcm(rng, n).astype(np.float64)
        k = np.arange(1_500)
        click = 9000.0 * np.exp(-k / 300.0) * rng.randn(k.size)
        for start in range(n // 50, n - n // 50 - k.size, period):
            s[start : start + k.size] += click
        out.append(np.clip(s, -32768, 32767).astype(np.int16))
    return out, [4, 3, 3]


def _halo(B, K, seed=3):
    return np.random.RandomState(seed).randint(-20000, 20000, size=(B, K)).astype(np.int16)


@pytest.fixture(scope="module")
def batches():
    songs, durs = _songs()
    return JBatch.from_arrays(songs, durs), PCMBatch.from_arrays(songs, durs, device="cpu")


def _masked_rel_err(jb, tb, e_ref, e_port, jcfg, peak_floor=0.0):
    """Max |port - ref| / (|ref| + 1e-3 + peak_floor * the song's band
    peak) over the windows both packages keep."""
    e_ref = np.asarray(j_mask_energies(jb, jnp.asarray(e_ref), jcfg))
    e_port = _mask_energies(tb, e_port).numpy()
    assert e_ref.shape == e_port.shape
    denom = np.abs(e_ref) + 1e-3 + peak_floor * np.abs(e_ref).max(axis=-1, keepdims=True)
    return float((np.abs(e_port - e_ref) / denom).max())


# ---- K2: fused_stats ---------------------------------------------------------


@pytest.mark.parametrize("conv_mode", ["split", "exact"])
@pytest.mark.parametrize("bands", sorted(BANDS))
def test_fused_sample_stats_matches_jax(batches, conv_mode, bands):
    """Amplitude within 2e-5, masked energies within 1e-4 relative. JAX's
    "split" FIR (bf16 x4, bliss_tpu/kernels/fused_stats.py:124-131) is
    accurate to ~1e-5 of the signal's level, so its absolute error scales
    with the band's loudest window: in the silent lead-in of a quiet band it
    exceeds 1e-4 of the window itself (1.2e-4 in reference5's band 3 here,
    where the float64 port and JAX's "exact" FIR agree to 8e-7). For that
    mode the relative error's denominator adds 1e-5 of the song's band
    peak."""
    jb, tb = batches
    kw = BANDS[bands]
    amp_ref, e_ref = j_fused_sample_stats(
        jb.samples, jb.n_samples, interpret=True, conv_mode=conv_mode, **kw
    )
    amp, energies = fused_stats.fused_sample_stats(
        tb.samples, tb.n_samples, conv_mode=conv_mode, **kw
    )
    a_ref = np.float32(JC.AMPLITUDE_SCALE) * np.asarray(amp_ref) + np.float32(JC.AMPLITUDE_BIAS)
    a_port = JC.AMPLITUDE_SCALE * amp.numpy() + JC.AMPLITUDE_BIAS
    np.testing.assert_allclose(a_port, a_ref, rtol=0, atol=2e-5)
    jcfg = JConfig(fused_kernel=True, fused_conv=conv_mode, filterbank=kw["filterbank"])
    assert energies.dtype == torch.float64
    floor = 1e-5 if conv_mode == "split" else 0.0
    assert _masked_rel_err(jb, tb, e_ref, energies, jcfg, floor) < 1e-4


def _shard(jb, tb, S):
    """Both packages' batches of the samples from S on, as a sequence shard
    sees them."""
    return (
        JBatch(jb.samples[:, S:], jb.n_samples - S, jb.durations),
        PCMBatch(tb.samples[:, S:].contiguous(), tb.n_samples - S, tb.durations),
    )


@pytest.mark.parametrize("halo", ["none", "mean", "shard"])
def test_fused_stats_call_with_halo0_matches_jax(batches, halo):
    """rownz and trim bounds identical, wsum within 2e-4 (float32 block sums
    of weights in [0, 1]), masked energies within 1e-4 relative. halo0 as
    the mesh passes it (parallel/mesh.py:289-298): the clipped integer mean
    to the first shard, the previous shard's last K samples to the next."""
    jb, tb = batches
    alpha, beta, mean = fused_stats.normalization(tb.samples, tb.n_samples)
    B = tb.samples.shape[0]
    halo0 = None
    if halo == "mean":
        halo0 = mean.clamp(-32768, 32767).to(torch.int16)[:, None].expand(B, 16).contiguous()
    elif halo == "shard":
        S = 40 * 256
        halo0 = tb.samples[:, S - 16 : S].contiguous()
        jb, tb = _shard(jb, tb, S)
    L = tb.samples.shape[1]
    jh = None if halo0 is None else jnp.asarray(halo0.numpy())
    wsum_r, rownz_r, e_ref = j_fused_stats_call(
        jb.samples, jnp.asarray(alpha.numpy()), jnp.asarray(beta.numpy()), halo0=jh,
        interpret=True,
    )
    before = fused_stats.LAUNCHES
    wsum, rownz, energies = fused_stats.fused_stats_call(tb.samples, alpha, beta, halo0)
    assert fused_stats.LAUNCHES == before  # a CPU tensor runs the plain version
    nbf = L // 256
    assert np.array_equal(rownz.numpy(), np.asarray(rownz_r)[:, :nbf])
    np.testing.assert_allclose(wsum.numpy(), np.asarray(wsum_r)[:, :nbf], rtol=0, atol=2e-4)
    start, end = fused_stats.trim_bounds_from_rownz(tb.samples, rownz, L)
    start_r, end_r = j_trim(jb.samples, rownz_r, L)
    assert np.array_equal(start.numpy(), np.asarray(start_r))
    assert np.array_equal(end.numpy(), np.asarray(end_r))
    assert _masked_rel_err(jb, tb, e_ref, energies, JConfig(fused_kernel=True)) < 1e-4


def test_loud_halo0_before_silence_leaves_the_energies(batches):
    """Each window's FIR restarts at the window, so no window's energy
    depends on the history before sample 0. A loud random halo0 in front of
    a silent lead-in changes the port's energies by rounding only. (JAX's
    float32 kernel cancels that history's share of z^2 there and is off by
    ~5e-3 in the first window: the PR 1 fault in ROADMAP section 3.)"""
    _, tb = batches
    alpha, beta, _ = fused_stats.normalization(tb.samples, tb.n_samples)
    loud = torch.from_numpy(_halo(tb.samples.shape[0], 16))
    _, _, quiet = fused_stats.fused_stats_call(tb.samples, alpha, beta)
    _, _, e = fused_stats.fused_stats_call(tb.samples, alpha, beta, loud)
    assert float(((e - quiet).abs() / (quiet.abs() + 1e-3)).max()) < 1e-9


@pytest.mark.parametrize("bands", sorted(BANDS))
def test_two_shards_with_halo0_compose_to_the_unsharded_stats(batches, bands):
    """A sequence split at a block boundary: the second shard, seeded with
    the first shard's last K samples as halo0, reproduces the unsharded
    per-block sums (its first block's head sums depend on that history) and
    window energies; the first shard, seeded with the integer mean as the
    mesh seeds it, reproduces the unsharded windows too (fp64 plain
    versions)."""
    _, tb = batches
    kw = BANDS[bands]
    x = tb.samples
    alpha, beta, mean = fused_stats.normalization(x, tb.n_samples)
    K = kw["band_taps"] - 1
    S = 40 * 256
    wsum, rownz, stats = fused_stats.block_stats_reference(x, alpha, beta, **kw)
    energies = fused_stats.assemble_energies(stats)

    tail = x[:, S - K : S].contiguous()
    w2, r2, s2 = fused_stats.block_stats_reference(x[:, S:].contiguous(), alpha, beta, tail, **kw)
    np.testing.assert_allclose(s2.numpy(), stats[..., S // 256 :].numpy(), rtol=1e-12, atol=1e-9)
    assert torch.equal(w2, wsum[:, S // 256 :]) and torch.equal(r2, rownz[:, S // 256 :])
    # without the history the first block's head sums are those of a cold
    # start, which differ
    _, _, cold = fused_stats.block_stats_reference(x[:, S:].contiguous(), alpha, beta, **kw)
    assert not torch.allclose(cold[..., 3:6, 0], stats[..., 3:6, S // 256], rtol=1e-6)

    _, _, e2 = fused_stats.fused_stats_call(x[:, S:].contiguous(), alpha, beta, tail, **kw)
    ref2 = energies[..., S // 256 :]
    assert float(((e2 - ref2).abs() / (ref2.abs() + 1e-3)).max()) < 1e-9

    halo_mean = mean.clamp(-32768, 32767).to(torch.int16)[:, None].expand(-1, K).contiguous()
    _, _, e1 = fused_stats.fused_stats_call(x[:, :S].contiguous(), alpha, beta, halo_mean, **kw)
    ref1 = energies[..., : S // 256 - 1]
    assert float(((e1 - ref1).abs() / (ref1.abs() + 1e-3)).max()) < 1e-9


def test_fused_all_reference_is_the_two_plain_versions(batches):
    _, tb = batches
    x, n = tb.samples, tb.n_samples
    alpha, beta, _ = fused_stats.normalization(x, n)
    halo0 = torch.from_numpy(_halo(x.shape[0], 32))
    kw = dict(nb_bands=5, band_taps=33, filterbank="firwin")
    got = fused_all.fused_all_reference(x, alpha, beta, stft.frame_counts(n), halo0, **kw)
    want = (
        *fused_stats.fused_stats_reference(x, alpha, beta, halo0, **kw),
        stft.stft_power_reference(x, n),
    )
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "case", ["dtype", "length", "alpha_dtype", "halo_shape", "halo_dtype", "conv_mode"]
)
def test_fused_stats_call_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(2, 4096, dtype=torch.int16)
    alpha, beta = torch.ones(2), torch.zeros(2)
    halo0 = torch.zeros(2, 16, dtype=torch.int16)
    kw = {}
    if case == "dtype":
        x = x.to(torch.int32)
    elif case == "length":
        x = torch.zeros(2, 4096 + 100, dtype=torch.int16)
    elif case == "alpha_dtype":
        alpha = alpha.double()
    elif case == "halo_shape":
        halo0 = torch.zeros(2, 17, dtype=torch.int16)
    elif case == "halo_dtype":
        halo0 = halo0.to(torch.int32)
    elif case == "conv_mode":
        kw = {"conv_mode": "bf16"}
    with pytest.raises(ValueError):
        fused_stats.fused_stats_call(x, alpha, beta, halo0, **kw)


# ---- K3: stft_power ------------------------------------------------------------


def _peak_rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    peak = ref.max(axis=1, keepdims=True)
    silent = peak[:, 0] == 0
    assert np.array_equal(got[silent], ref[silent])  # no frame counts: all zero
    return float((np.abs(got - ref)[~silent] / peak[~silent]).max(initial=0.0))


@pytest.mark.parametrize("offset", [None, 0, 30, 10_000], ids=["none", "0", "mid", "past"])
def test_stft_power_matches_jax(batches, offset):
    """Within 1e-5 of each song's peak bin against the 5-matmul "precise"
    JAX kernel (~2^-23 absolute), and within 1e-4 against the 3-matmul
    "fast" one (~2^-16 relative error of its spectrum)."""
    jb, tb = batches
    before = stft.LAUNCHES
    got = stft.stft_power(tb.samples, tb.n_samples, frame_offset=offset)
    assert stft.LAUNCHES == before
    assert got.shape == (3, 257) and got.dtype == torch.float32
    assert (got[:, -1] == 0).all()
    precise = j_stft_power(jb.samples, jb.n_samples, frame_offset=offset, precise=True)
    fast = j_stft_power(jb.samples, jb.n_samples, frame_offset=offset, precise=False)
    assert _peak_rel_err(got.numpy(), precise) < 1e-5
    assert _peak_rel_err(got.numpy(), fast) < 1e-4
    if offset == 10_000:
        assert (got == 0).all()


def test_stft_power_shards_sum_to_the_unsharded_spectrum(batches):
    _, tb = batches
    x, n = tb.samples, tb.n_samples
    full = stft.stft_power(x, n)
    S = 40 * 1024  # a frame boundary inside every song
    first = stft.stft_power(x[:, :S].contiguous(), n, frame_offset=0)
    offsets = torch.full((x.shape[0],), S // 1024, dtype=torch.int32)
    second = stft.stft_power(x[:, S:].contiguous(), n, frame_offset=offsets)
    assert _peak_rel_err((first + second).numpy(), full.numpy()) < 1e-5
    assert torch.equal(stft.stft_power_reference(x, n), full)


@pytest.mark.parametrize("case", ["length", "offset_dtype", "offset_shape"])
def test_stft_power_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(2, 4096, dtype=torch.int16)
    n = torch.full((2,), 4096, dtype=torch.int32)
    offset = torch.zeros(2, dtype=torch.int32)
    if case == "length":
        x = torch.zeros(2, 4096 + 256, dtype=torch.int16)
    elif case == "offset_dtype":
        offset = offset.long()
    elif case == "offset_shape":
        offset = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        stft.stft_power(x, n, frame_offset=offset)


# ---- the float64 host finish ---------------------------------------------------


@pytest.mark.parametrize("workers", [1, 4])
def test_envelope_finish_host_is_bitwise_jaxs(workers):
    rng = np.random.RandomState(workers)
    B, NB, NBF = 10, 2, 700
    fa = np.abs(rng.randn(B, NB, NBF)) * 10.0 ** rng.uniform(-2, 4, size=(B, 1, 1))
    n = rng.randint(300 * 256, NBF * 256, size=B).astype(np.int32)
    dur = rng.randint(0, 9, size=B).astype(np.int32)
    t, a, aux = envelope_finish_host(fa, n, dur, workers=workers, return_aux=True)
    jt, ja, jaux = j_envelope_finish_host(fa, n, dur, workers=workers, return_aux=True)
    assert t.dtype == a.dtype == np.float32
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(a, ja)
    for x, y in zip(aux, jaux):
        np.testing.assert_array_equal(x, y)
    t1, a1 = envelope_finish_host(fa, n, dur, workers=1)
    np.testing.assert_array_equal(t1, t)
    np.testing.assert_array_equal(a1, a)
    np.testing.assert_array_equal(envelope_finish_host(fa[:, 0], n, dur, workers=workers)[0],
                                  j_envelope_finish_host(fa[:, 0], n, dur, workers=workers)[0])


# ---- the two configurations end to end -----------------------------------------


def _check_force_vectors(port, ref):
    assert port.shape == ref.shape and port.dtype == np.float32
    assert np.isfinite(port).all()
    # tempo = 4 * beats / duration - 30.4: equal tempo is equal beat counts
    assert np.array_equal(port[:, 0], ref[:, 0])
    np.testing.assert_allclose(port[:, 1:], ref[:, 1:], rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def port_two_kernel(batches):
    _, tb = batches
    return analyze_batch(tb, AnalysisConfig(**TWO_KERNEL)).numpy()


@pytest.mark.parametrize(
    "fused_conv,stft_conv", [("split", "precise"), ("exact", "precise"), ("split", "fast")]
)
def test_two_kernel_analyze_batch_matches_jax(batches, port_two_kernel, fused_conv, stft_conv):
    """The port computes the FIR in float64 and the spectrum in float32 for
    every value of these fields, so one port result meets each JAX mode."""
    jb, tb = batches
    fields = dict(TWO_KERNEL, fused_conv=fused_conv, stft_conv=stft_conv)
    ref = np.asarray(analyze_batch_jit(jb, JConfig(**fields)))
    port = analyze_batch(tb, AnalysisConfig(**fields)).numpy()
    assert np.array_equal(port, port_two_kernel)
    _check_force_vectors(port, ref)
    beats = (port[:, 0].astype(np.float64) - JC.TEMPO_BIAS) * np.array([4, 3, 3]) / 4.0
    assert beats.min() > 3  # the clicks make real beats


def test_two_kernel_equals_single_pass(batches, port_two_kernel):
    _, tb = batches
    single = analyze_batch(tb, AnalysisConfig.for_gpu()).numpy()
    assert np.array_equal(single[:, 0], port_two_kernel[:, 0])
    np.testing.assert_allclose(single[:, 1:], port_two_kernel[:, 1:], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def hybrid(batches):
    jb, tb = batches
    ref = np.asarray(j_analyze_batch_hybrid(jb, JConfig.for_tpu_hybrid()))
    port = analyze_batch_hybrid(tb, AnalysisConfig.for_gpu_hybrid())
    return ref, port


def test_hybrid_matches_jax(hybrid, port_two_kernel):
    ref, port = hybrid
    assert isinstance(port, torch.Tensor) and port.device.type == "cpu"
    _check_force_vectors(port.numpy(), ref)
    # the two float64 finishes count the same beats
    assert np.array_equal(port.numpy()[:, 0], port_two_kernel[:, 0])


def test_hybrid_entry_points_agree(batches, hybrid):
    _, tb = batches
    _, port = hybrid
    cfg = AnalysisConfig.for_gpu_hybrid()
    songs, durs = _songs()
    assert np.array_equal(bliss_tpu_torch.analyze_pcm(songs, durs, cfg=cfg, device="cpu"), port.numpy())
    assert np.array_equal(api.analyze_features(tb, cfg), port.numpy())
    assert torch.equal(analyze_batch(tb, cfg), port)
    exact_fir = dataclasses.replace(cfg, fused_conv="exact")
    assert np.array_equal(api.analyze_features(tb, exact_fir), port.numpy())


def test_packed_stage_is_one_float64_array(batches):
    _, tb = batches
    cfg = AnalysisConfig.for_gpu_hybrid()
    packed = tanalyze._device_stage_packed(tb, cfg)
    B, L = tb.samples.shape
    assert packed.dtype == torch.float64 and packed.shape == (B, 2 + L // 256)
    amp, freq, fa, ext = tanalyze._unpack_stage(packed.numpy(), cfg, L)
    a2, f2, fa2 = tanalyze._device_stage(tb, cfg)
    assert np.array_equal(amp, a2.numpy()) and np.array_equal(freq, f2.numpy())
    assert np.array_equal(fa, fa2.numpy()) and ext is None
    # extended: the 45 columns after the energies, the beat columns left
    # zero for the host finish, the rest the extended features' own
    wide = tanalyze._device_stage_packed(tb, cfg, extended=True)
    assert wide.dtype == torch.float64 and wide.shape == (B, 2 + L // 256 + 45)
    assert torch.equal(wide[:, : packed.shape[1]], packed)
    *_, ext = tanalyze._unpack_stage(wide.numpy(), cfg, L, extended=True)
    want = extended_features(tb, cfg, beat_aux="skip").numpy()
    assert np.array_equal(ext, want) and not ext[:, 5:7].any()


@pytest.mark.parametrize("config", ["two_kernel", "hybrid"])
def test_short_clip_matches_jax(config):
    """A 20 000-sample clip: the JAX package takes its XLA path there (its
    Pallas tiles need L >= 65536, bliss_tpu/features/analyze.py:93-103); the
    port's kernels take any L that is a multiple of 1024."""
    clip = synth_pcm(np.random.RandomState(9), 20_000)
    jb = JBatch.from_arrays([clip], [1])
    tb = PCMBatch.from_arrays([clip], [1], device="cpu")
    if config == "two_kernel":
        ref = np.asarray(analyze_batch_jit(jb, JConfig(**TWO_KERNEL)))
        port = api.analyze_features(tb, AnalysisConfig(**TWO_KERNEL))
    else:
        ref = np.asarray(j_analyze_batch_hybrid(jb, JConfig.for_tpu_hybrid()))
        port = api.analyze_features(tb, AnalysisConfig.for_gpu_hybrid())
    _check_force_vectors(port, ref)


def test_cpu_tensors_move_no_launch_counter(batches):
    _, tb = batches
    counters = (fused_all.LAUNCHES, fused_stats.LAUNCHES, stft.LAUNCHES)
    analyze_batch(tb, AnalysisConfig(**TWO_KERNEL))
    analyze_batch(tb, AnalysisConfig.for_gpu())
    assert (fused_all.LAUNCHES, fused_stats.LAUNCHES, stft.LAUNCHES) == counters
