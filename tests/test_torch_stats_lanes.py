"""``stats_kernel``'s algorithm on the CPU: ``kernels/fused_stats.
stats_lane_steps`` runs the kernel's lanes, ring, sliding FIR window,
shuffle orders and split of the warm-up correction in PyTorch. It must
give what the plain version ``block_stats_reference`` gives (rownz
identical, wsum within 1e-5 of |ref| + 1, the float64 pieces within 1e-12
of |ref| plus the block's sum of z^2, + 1: the two differ in summation
order only), and its energies what JAX's K2 gives."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import synth_pcm
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features.analyze import _mask_energies as j_mask_energies
from bliss_tpu.kernels.fused_stats import fused_stats_call as j_fused_stats_call

from bliss_tpu_torch.ablate import fused as ablate_fused
from bliss_tpu_torch.features.analyze import _mask_energies
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import fused_stats as fs

torch.set_num_threads(1)


def _batch(L=1 << 13):
    """Two songs: full-range noise; a synthetic song (tones, noise, silent
    lead-in and tail), offset by 700. alpha and beta from the prepass."""
    rng = np.random.RandomState(12)
    a = rng.randint(-32768, 32768, size=L).astype(np.int16)
    b = (synth_pcm(rng, L, amp=9000) + 700).astype(np.int16)
    x = torch.from_numpy(np.stack([a, b]))
    alpha, beta, _ = fs.normalization(x, torch.full((2,), L, dtype=torch.int32))
    return x, alpha, beta


def _loud_halo(K, seed=3):
    return torch.from_numpy(np.random.RandomState(seed).randint(-32768, 32768, size=(2, K)).astype(np.int16))


def _check(got, ref, tol=1e-12):
    (gw, gr, gs), (rw, rr, rs) = got, ref
    assert gs.dtype == rs.dtype and gs.shape == rs.shape
    assert torch.equal(gr, rr)
    assert float(((gw - rw).abs() / (rw.abs() + 1.0)).max()) < 1e-5
    scale = rs.abs() + rs[:, :, 1:2] + rs[:, :, 4:5] + 1.0
    err = float(((gs.double() - rs.double()).abs() / scale.double()).max())
    assert err < tol, err
    return err


@pytest.mark.parametrize("taps", [2, 9, 17, 33, 129])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("halo", ["none", "loud"])
def test_lane_steps_match_plain(taps, nb, halo):
    """Every FIR length the kernel takes (K = taps - 1 from 1 to 128: one
    to sixteen head lanes, 32 to 1 lanes a row of M), one and three bands,
    the history before sample 0 normalized zero or a loud halo0."""
    x, alpha, beta = _batch()
    halo0 = _loud_halo(taps - 1) if halo == "loud" else None
    kw = dict(nb_bands=nb, band_taps=taps, filterbank="firwin")
    got = fs.stats_lane_steps(x, alpha, beta, halo0, **kw)
    _check(got, fs.block_stats_reference(x, alpha, beta, halo0, **kw))


def test_lane_steps_at_a_loud_to_silence_edge():
    """Loud noise that stops mid-block (song 0) and at a block boundary
    (song 1), with a loud halo0: the head and reset pieces of the blocks
    after the edge carry the loud history, the tails do not. The energies
    assembled from the pieces agree within 1e-12 of |E| + 1e-3."""
    rng = np.random.RandomState(5)
    x = np.zeros((2, 1 << 13), np.int16)
    x[0, :2000] = rng.randint(-32768, 32768, size=2000)
    x[1, :2048] = rng.randint(-32768, 32768, size=2048)
    x = torch.from_numpy(x)
    alpha, beta, _ = fs.normalization(x, torch.full((2,), 1 << 13, dtype=torch.int32))
    kw = dict(nb_bands=1, band_taps=17, filterbank="firwin")
    got = fs.stats_lane_steps(x, alpha, beta, _loud_halo(16), **kw)
    ref = fs.block_stats_reference(x, alpha, beta, _loud_halo(16), **kw)
    _check(got, ref)
    e_got, e_ref = fs.assemble_energies(got[2]), fs.assemble_energies(ref[2])
    assert float(((e_got - e_ref).abs() / (e_ref.abs() + 1e-3)).max()) < 1e-12


@pytest.mark.parametrize("variant", list(ablate_fused.VARIANTS))
def test_lane_steps_match_plain_in_each_ablation_variant(variant):
    """A1's six template variants (CHEB, CONV, WARM, FirT) of the same
    kernel; the float32 FIR within 1e-5 (float32 summation order)."""
    _, cheb, conv, warm, fir_dtype = ablate_fused.VARIANTS[variant]
    x, alpha, beta = _batch()
    kw = dict(nb_bands=1, band_taps=17, filterbank="firwin", cheb=cheb, conv=conv,
              warm=warm, fir_dtype=fir_dtype)
    got = fs.stats_lane_steps(x, alpha, beta, **kw)
    _check(got, fs.block_stats_reference(x, alpha, beta, **kw),
           1e-5 if fir_dtype == torch.float32 else 1e-12)


def test_lane_steps_energies_match_jax_k2():
    """Against JAX's K2 (bliss_tpu/kernels/fused_stats.py fused_stats_call,
    Pallas interpret mode, its "exact" FIR: its float32 sums leave ~1e-6 in
    silent windows, which a quieter song or the "split" FIR lifts past the
    gate, see tests/test_torch_two_kernel.py) under
    tests/test_torch_kernels.py's tolerances: rownz identical, wsum within
    2e-4, masked energies within 1e-4 relative."""
    rng = np.random.RandomState(7)
    songs = [synth_pcm(rng, 90_000), synth_pcm(rng, 70_001)]
    jb, tb = JBatch.from_arrays(songs, [4, 3]), PCMBatch.from_arrays(songs, [4, 3], device="cpu")
    alpha, beta, _ = fs.normalization(tb.samples, tb.n_samples)
    wsum_r, rownz_r, e_ref = j_fused_stats_call(
        jb.samples, jnp.asarray(alpha.numpy()), jnp.asarray(beta.numpy()), interpret=True,
        conv_mode="exact",
    )
    wsum, rownz, stats = fs.stats_lane_steps(
        tb.samples, alpha, beta, nb_bands=1, band_taps=17, filterbank="firwin")
    nbf = tb.samples.shape[1] // 256
    assert np.array_equal(rownz.numpy(), np.asarray(rownz_r)[:, :nbf])
    np.testing.assert_allclose(wsum.numpy(), np.asarray(wsum_r)[:, :nbf], rtol=0, atol=2e-4)
    e_ref = np.asarray(j_mask_energies(jb, jnp.asarray(e_ref), JConfig(fused_kernel=True, fused_conv="exact")))
    e_port = _mask_energies(tb, fs.assemble_energies(stats)).numpy()
    assert e_ref.shape == e_port.shape
    assert (np.abs(e_port - e_ref) / (np.abs(e_ref) + 1e-3)).max() < 1e-4
