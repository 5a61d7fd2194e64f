"""The port's mesh (``bliss_tpu_torch.parallel``) on the CPU: ``[cpu] * n``
meshes stand in for JAX's 8 virtual host devices.

(i) the port's sharded rows against its own unsharded rows, (ii) against
``bliss_tpu.parallel.analyze_sharded`` on the same batch and mesh shape,
(iii) the row-sharded top-k, (iv) the dry run; and the per-shard kernel
branch: each shard's K2 and K3 (their plain versions here) with its
neighbour's ``halo0`` and its ``frame_offset``."""

import numpy as np
import pytest
import torch

import jax

from conftest import synth_pcm
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.parallel import analysis_mesh as j_mesh
from bliss_tpu.parallel import analyze_sharded as j_sharded
from bliss_tpu.parallel import sharded_distance_topk as j_topk

from bliss_tpu_torch import AnalysisConfig
from bliss_tpu_torch.features.analyze import analyze_batch, analyze_batch_ext, analyze_batch_hybrid
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import fused_stats as fs
from bliss_tpu_torch.kernels import stft
from bliss_tpu_torch.parallel import (
    analysis_mesh,
    analyze_sharded,
    analyze_sharded_async,
    shard_batch,
    sharded_distance_topk,
)
from bliss_tpu_torch.parallel import mesh as pmesh
from bliss_tpu_torch.sim import nearest_neighbors_all

torch.set_num_threads(1)

CFG64 = AnalysisConfig(dtype="float64")
DURS = [3, 4, 4, 5]
SHAPES = [(8, 1), (1, 8), (4, 2), (2, 4)]


def cpu_mesh(n_data, n_seq):
    return analysis_mesh(n_data, n_seq, devices=["cpu"] * (n_data * n_seq))


@pytest.fixture(scope="module")
def arrays():
    """``tests/test_sharding.py``'s batch: 4 songs of 50 000-77 000 samples."""
    rng = np.random.RandomState(7)
    return [np.asarray(synth_pcm(rng, 50_000 + 9_000 * i)) for i in range(4)]


@pytest.fixture(scope="module")
def batch(arrays):
    return PCMBatch.from_arrays(arrays, DURS, pad_multiple=8 * 1024, device="cpu")


@pytest.fixture(scope="module")
def kernel_arrays():
    """Two songs whose 2-way sequence shards (81 920 samples) stay on the
    kernel branch (``tests/test_sharding.py:126-149``)."""
    rng = np.random.RandomState(21)
    return [np.asarray(synth_pcm(rng, 150_000)), np.asarray(synth_pcm(rng, 140_000, amp=20000))]


@pytest.fixture(scope="module")
def kernel_batch(kernel_arrays):
    b = PCMBatch.from_arrays(kernel_arrays, [7, 6], pad_multiple=1024 * 160, device="cpu")
    assert b.samples.shape[1] // 2 >= pmesh.MIN_KERNEL_SHARD
    return b


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of the kernel wrappers the mesh stage makes (their
    plain versions run here, on CPU tensors)."""
    calls = {"prepass": 0, "fused_stats": [], "stft_power": []}
    prepass, stats, power = fs.prepass_sums, fs.fused_stats_call, stft.stft_power

    def count_prepass(*a, **k):
        calls["prepass"] += 1
        return prepass(*a, **k)

    def count_stats(x, alpha, beta, halo0=None, **k):
        calls["fused_stats"].append((x.shape, halo0))
        return stats(x, alpha, beta, halo0, **k)

    def count_power(x, n, frame_offset=None, **k):
        calls["stft_power"].append(frame_offset)
        return power(x, n, frame_offset, **k)

    monkeypatch.setattr(fs, "prepass_sums", count_prepass)
    monkeypatch.setattr(fs, "fused_stats_call", count_stats)
    monkeypatch.setattr(stft, "stft_power", count_power)
    return calls


# --- (i) the port's sharded rows against its unsharded rows -----------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_float64_matches_unsharded(batch, shape):
    sharded = analyze_sharded(batch, cpu_mesh(*shape), CFG64)
    np.testing.assert_allclose(sharded, analyze_batch(batch, CFG64).numpy(), atol=2e-6)


def test_shard_batch_places_each_shard(batch):
    mesh = analysis_mesh(2, 2, devices=["cpu", "meta", "cpu", "meta"])
    shards = shard_batch(batch, mesh)
    assert sorted(shards) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    L = batch.samples.shape[1]
    for (d, q), part in shards.items():
        assert part.samples.device.type == ("cpu" if q == 0 else "meta")
        assert tuple(part.samples.shape) == (2, L // 2) and part.samples.is_contiguous()
        if q == 0:
            assert torch.equal(part.samples, batch.samples[2 * d : 2 * d + 2, : L // 2])
            assert torch.equal(part.n_samples, batch.n_samples[2 * d : 2 * d + 2])
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(batch, cpu_mesh(3, 1))


MODES = {
    "hybrid": AnalysisConfig(dtype="float32", amplitude_mode="poly", tempo_finish="host"),
    "device_exact": AnalysisConfig(dtype="float32", amplitude_mode="poly",
                                   tempo_finish="device_exact"),
    "multiband": AnalysisConfig(dtype="float64", nb_bands=5),
    "multiband_hybrid": AnalysisConfig(dtype="float32", nb_bands=5, tempo_finish="host"),
}


@pytest.mark.parametrize("name", list(MODES))
def test_sharded_modes_match_unsharded(batch, name, counted):
    """On (2, 2) the shards (40 960 samples) take the XLA branch: no K2 or K3,
    one prepass a shard; beats identical, the rest within 1e-4 (the mesh's
    table amplitude against a ``"poly"`` config's, as in
    ``tests/test_sharding.py``)."""
    cfg = MODES[name]
    sharded = analyze_sharded(batch, cpu_mesh(2, 2), cfg)
    assert counted["prepass"] == 4 and not counted["fused_stats"] and not counted["stft_power"]
    single = analyze_batch(batch, cfg).numpy()
    np.testing.assert_array_equal(sharded[:, 0], single[:, 0])
    np.testing.assert_allclose(sharded, single, atol=1e-4 if cfg.dtype == "float32" else 2e-6)


@pytest.mark.parametrize("shape", [(1, 8), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_extended_matches_unsharded(batch, shape):
    out = analyze_sharded_async(batch, cpu_mesh(*shape), CFG64, extended=True)()
    single = analyze_batch_ext(batch, CFG64).numpy()
    assert out.shape == (4, 49)
    np.testing.assert_allclose(out[:, :4], single[:, :4], atol=2e-6)
    np.testing.assert_allclose(out[:, 4:], single[:, 4:], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("cfg", [AnalysisConfig.for_gpu(), AnalysisConfig.for_gpu_hybrid()],
                         ids=["main", "hybrid"])
def test_kernel_branch_matches_unsharded(kernel_batch, cfg, counted):
    """Shards of 81 920 samples take the kernels: a prepass, a K2 and a K3
    launch a shard, K2 with the left neighbour's last 16 samples as halo0
    (shard 0: the integer mean) on the shard and the next one's first hop
    block, K3 with the shard's frame offset; beats identical to the
    unsharded K1 (or K2 + K3) path, the rest within 5e-4."""
    sharded = analyze_sharded(kernel_batch, cpu_mesh(2, 2), cfg)
    Ls = kernel_batch.samples.shape[1] // 2
    assert counted["prepass"] == 4
    assert [shape for shape, _ in counted["fused_stats"]] == [(1, Ls + 256)] * 4
    halos = [h for _, h in counted["fused_stats"]]
    assert all(h is not None and tuple(h.shape) == (1, 16) for h in halos)
    # shard 1's history is shard 0's last 16 samples
    for d in range(2):
        np.testing.assert_array_equal(halos[2 * d + 1][0].numpy(),
                                      kernel_batch.samples[d, Ls - 16 : Ls].numpy())
    assert counted["stft_power"] == [0, Ls // 1024] * 2
    single = analyze_batch(kernel_batch, cfg).numpy()
    np.testing.assert_array_equal(sharded[:, 0], single[:, 0])
    np.testing.assert_allclose(sharded, single, atol=5e-4)


def test_kernel_branch_extended_matches_unsharded(kernel_batch):
    cfg = AnalysisConfig.for_gpu()
    out = analyze_sharded_async(kernel_batch, cpu_mesh(2, 2), cfg, extended=True)()
    single = analyze_batch_ext(kernel_batch, cfg).numpy()
    np.testing.assert_array_equal(out[:, :4], single[:, :4])
    np.testing.assert_allclose(out[:, 4:], single[:, 4:], rtol=1e-6, atol=1e-5)


def test_kernel_shard_against_plain_versions(kernel_batch):
    """Shard 1 of a (1, 2) mesh: K2 with its real, nonzero halo0 and K3 at
    a nonzero frame offset, against the same function of the whole song
    (the window energies of shard 1 are the song's windows from its
    first, the spectrum the song's frames from the offset)."""
    x = kernel_batch.samples
    n = kernel_batch.n_samples
    Ls = x.shape[1] // 2
    alpha, beta, _ = fs.normalization(x, n)
    halo0 = x[:, Ls - 16 : Ls].contiguous()
    assert halo0.abs().sum() > 0
    shard = torch.cat([x[:, Ls:], torch.zeros(2, 256, dtype=torch.int16)], dim=1)
    _, _, e = fs.fused_stats_call(shard, alpha, beta, halo0)
    _, _, e_whole = fs.fused_stats_call(x, alpha, beta)
    np.testing.assert_allclose(e[:, :, : Ls // 256 - 1].numpy(),
                               e_whole[:, :, Ls // 256 : 2 * Ls // 256 - 1].numpy(),
                               rtol=1e-9, atol=1e-6)
    p = stft.stft_power(x[:, Ls:].contiguous(), n, frame_offset=Ls // 1024)
    masked = x.clone()
    masked[:, :Ls] = 0
    np.testing.assert_allclose(p.numpy(), stft.stft_power(masked, n).numpy(), rtol=1e-5,
                               atol=1e-3)


def test_short_shards_take_the_xla_branch(kernel_batch, counted):
    """A kernel config whose shards are shorter than 65 536 samples takes
    the XLA branch, as ``bliss_tpu`` routes on the shard's length."""
    cfg = AnalysisConfig.for_gpu()
    sharded = analyze_sharded(kernel_batch, cpu_mesh(1, 4), cfg)
    assert not counted["fused_stats"] and not counted["stft_power"]
    single = analyze_batch(kernel_batch, cfg).numpy()
    np.testing.assert_array_equal(sharded[:, 0], single[:, 0])
    np.testing.assert_allclose(sharded, single, atol=1e-4)


def test_pad_songs_and_pcm(arrays):
    """B=3 on 2 data rows and L not a multiple of 1024 * n_seq: the pad song
    and the pad PCM leave the rows as they are."""
    b = PCMBatch.from_arrays(arrays[:3], DURS[:3], device="cpu")
    assert b.samples.shape[1] % (1024 * 4)
    sharded = analyze_sharded(b, cpu_mesh(2, 4), CFG64)
    assert sharded.shape == (3, 4)
    np.testing.assert_allclose(sharded, analyze_batch(b, CFG64).numpy(), atol=2e-6)


# --- (ii) against bliss_tpu's sharded rows ---------------------------------


def _jax_rows(arrays, durs, pad_multiple, shape, cfg):
    jb = JBatch.from_arrays(arrays, durs, pad_multiple=pad_multiple)
    mesh = j_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])
    return np.asarray(j_sharded(jb, mesh, cfg))


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_float64_matches_bliss_tpu_sharded(arrays, batch, shape):
    want = _jax_rows(arrays, DURS, 8 * 1024, shape, JConfig(dtype="float64"))
    np.testing.assert_allclose(analyze_sharded(batch, cpu_mesh(*shape), CFG64), want, atol=1e-5)


def test_hybrid_matches_bliss_tpu_sharded(arrays, batch):
    """The mesh-only quirks of the reference (the table amplitude and the
    blocked Parseval energies whatever the config says): the port's rows
    are held to ``bliss_tpu``'s sharded rows."""
    kw = dict(dtype="float32", amplitude_mode="poly", tempo_finish="host")
    want = _jax_rows(arrays, DURS, 8 * 1024, (2, 2), JConfig(**kw))
    got = analyze_sharded(batch, cpu_mesh(2, 2), AnalysisConfig(**kw))
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_kernel_branch_matches_bliss_tpu_sharded(kernel_arrays, kernel_batch):
    """The kernel branch under ``tempo_finish="device_exact"`` (JAX's K2 and
    K3 in interpret mode, once, at B=2) on a (1, 2) mesh."""
    kw = dict(dtype="float32", amplitude_mode="poly", fused_kernel=True,
              tempo_finish="device_exact")
    want = _jax_rows(kernel_arrays, [7, 6], 1024 * 160, (1, 2), JConfig(**kw))
    got = analyze_sharded(kernel_batch, cpu_mesh(1, 2), AnalysisConfig(**kw))
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, atol=5e-4)


# --- (iii) the row-sharded top-k --------------------------------------------


@pytest.mark.parametrize("shape", [(8, 1), (2, 2), (3, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_distance_topk(shape):
    """In query blocks of 2 rows, every device holding some: equal to
    ``nearest_neighbors_all`` (a planted exact copy included: ties in index
    order), and within 1e-6 of ``bliss_tpu``'s on rows without one (its
    float32 Gram puts a copy ~3e-3 from its twin)."""
    rng = np.random.RandomState(9)
    f = (rng.randn(37, 4) * 3).astype(np.float32)
    d, idx = sharded_distance_topk(f, cpu_mesh(*shape), k=4, block=2)
    jd, _ = j_topk(jax.numpy.asarray(f), j_mesh(8, 1), k=4)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    f[5] = f[11]
    d, idx = sharded_distance_topk(f, cpu_mesh(*shape), k=4, block=2)
    d0, idx0 = nearest_neighbors_all(f, 4, block=2, device="cpu")
    assert torch.equal(d, d0) and torch.equal(idx, idx0)
    assert idx[5, 0] == 11 and idx[11, 0] == 5 and d[5, 0] == 0


# --- (iv) the dry run -------------------------------------------------------


def test_dryrun_multichip():
    from bliss_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(8, device="cpu")
