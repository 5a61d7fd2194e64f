"""The port's main path end to end against
analyze_batch_jit(batch, AnalysisConfig.for_tpu()), plus force_and_class and
similarity."""

import dataclasses
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import synth_pcm
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features.analyze import analyze_batch_jit, force_and_class as j_force

import bliss_tpu_torch
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.convert import config_from_reference
from bliss_tpu_torch.features.analyze import analyze_batch, force_and_class
from bliss_tpu_torch.features.types import PCMBatch

torch.set_num_threads(1)
# the plain versions' matmuls in full float32 wherever a GPU runs them
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the modules, not the functions that each sim package re-exports under their name
jdist = importlib.import_module("bliss_tpu.sim.distance")
tdist = importlib.import_module("bliss_tpu_torch.sim.distance")


def _songs():
    rng = np.random.RandomState(11)
    a = synth_pcm(rng, 70_000)
    b = rng.randint(-15000, 15000, size=66_000).astype(np.int16)
    b[:100] = 0
    c = synth_pcm(np.random.RandomState(5), 67_123, amp=3000)
    return [a, b, c], [3, 3, 3]


@pytest.fixture(scope="module")
def results():
    songs, durs = _songs()
    clip = synth_pcm(np.random.RandomState(9), 20_000)
    ref = np.asarray(analyze_batch_jit(JBatch.from_arrays(songs, durs), JConfig.for_tpu()))
    ref_clip = np.asarray(analyze_batch_jit(JBatch.from_arrays([clip], [1]), JConfig.for_tpu()))
    cfg = AnalysisConfig.for_gpu()
    port = analyze_batch(PCMBatch.from_arrays(songs, durs, device="cpu"), cfg).numpy()
    port_clip = analyze_batch(PCMBatch.from_arrays([clip], [1], device="cpu"), cfg).numpy()
    return {"ref": ref, "port": port, "ref_clip": ref_clip, "port_clip": port_clip}


def _check_force_vectors(port, ref):
    assert port.shape == ref.shape and port.dtype == np.float32
    assert np.isfinite(port).all()
    # tempo = 4 * beats / duration - 30.4: equal tempo is equal beat counts
    assert np.array_equal(port[:, 0], ref[:, 0])
    # amplitude, frequency, attack: the repo's cross-path gate
    np.testing.assert_allclose(port[:, 1:], ref[:, 1:], rtol=0, atol=1e-3)


def test_main_path_matches_jax(results):
    _check_force_vectors(results["port"], results["ref"])


def test_short_clip_matches_jax(results):
    """A 20 000-sample clip: the JAX package takes its XLA path there (its
    Pallas tiles need L >= 65536); the port's kernel takes any L that is a
    multiple of 1024."""
    _check_force_vectors(results["port_clip"], results["ref_clip"])


def test_analyze_pcm_entry_point(results):
    songs, durs = _songs()
    out = bliss_tpu_torch.analyze_pcm(songs, durs, device="cpu")
    assert isinstance(out, np.ndarray)
    assert np.array_equal(out, results["port"])
    assert bliss_tpu_torch.default_config() == AnalysisConfig.for_gpu()


@pytest.mark.parametrize(
    "jcfg",
    [
        JConfig(),
        JConfig.for_parity(),
        # the hybrid's two kernels with the working-dtype device finish;
        # for_tpu_hybrid() itself: tests/test_torch_two_kernel.py
        dataclasses.replace(JConfig.for_tpu_hybrid(), tempo_finish="device"),
    ],
    ids=["default", "parity", "hybrid"],
)
def test_unported_configs_raise(jcfg):
    """The configs that were refused until ROADMAP item M7 run and match
    ``analyze_batch_jit`` under the same config: the XLA-path stage
    (``AnalysisConfig()``, ``for_parity()``) and the two kernels with the
    float32 working-dtype finish. The float32 finish is held as
    ``test_torch_modes.check_f32_finish`` says (beats flip only within its
    own rounding, attack against the float64 finish)."""
    from bliss_tpu.features import tempo as jtempo
    from bliss_tpu.features.analyze import _fused_amp_and_energies
    from bliss_tpu_torch.features.analyze import _device_stage
    from bliss_tpu_torch.features.tempo import envelope_finish_device
    from test_torch_modes import check_f32_finish, check_rows

    cfg = config_from_reference(dataclasses.asdict(jcfg))
    songs, durs = _songs()
    jb = JBatch.from_arrays(songs, durs)
    tb = PCMBatch.from_arrays(songs, durs, device="cpu")
    port = analyze_batch(tb, cfg).numpy()
    ref = np.asarray(analyze_batch_jit(jb, jcfg))
    if jcfg.dtype == "float64":
        check_rows(port, ref, jcfg)
        return
    np.testing.assert_allclose(port[:, 1:3], ref[:, 1:3], rtol=0, atol=1e-3)
    pfa = _device_stage(tb, cfg)[2]
    jfa = (_fused_amp_and_energies(jb, jcfg)[1] if jcfg.fused_kernel
           else jtempo.band_energies(jb, jcfg))
    _, _, paux = envelope_finish_device(pfa, tb.n_samples, tb.durations, cfg, return_aux=True)
    _, _, jaux = jtempo.envelope_finish_device(jfa, jb.n_samples, jb.durations, jcfg,
                                               return_aux=True)
    fa64 = np.asarray(jtempo.band_energies(jb, JConfig(dtype="float64")))
    check_f32_finish(paux, jaux, fa64, np.asarray(jb.n_samples), np.asarray(jb.durations),
                     port[:, 3], ref[:, 3], str(jcfg.fused_kernel))


def test_force_and_class_matches_jax(results):
    feats = np.concatenate(
        [
            results["port"],
            np.array(
                [[-1.0, 0.5, 0.5, -2.0], [2.0, -1.0, -1.0, 0.0], [0.0, 0.0, 0.0, 0.0]],
                np.float32,
            ),
        ]
    )
    jf, jc = (np.asarray(x) for x in j_force(jnp.asarray(feats)))
    tf, tc = force_and_class(torch.from_numpy(feats))
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-6)
    assert np.array_equal(tc.numpy(), jc)


@pytest.fixture(scope="module")
def vectors():
    return np.random.RandomState(4).randn(12, 4).astype(np.float32) * 5.0


def test_pairwise_distance_and_cosine(vectors):
    a, b = vectors[:6], vectors[6:]
    np.testing.assert_allclose(
        tdist.distance(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jdist.distance(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        tdist.cosine_similarity(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jdist.cosine_similarity(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5,
    )
    fv = bliss_tpu_torch.ForceVector(*map(float, a[0]))
    assert abs(bliss_tpu_torch.distance(fv, b[0]) - float(np.linalg.norm(a[0] - b[0]))) < 1e-5
    cos = float(a[0] @ b[0] / np.linalg.norm(a[0]) / np.linalg.norm(b[0]))
    assert abs(bliss_tpu_torch.cosine_similarity(a[0], b[0]) - cos) < 1e-5


@pytest.mark.parametrize("self_pairs", [True, False])
def test_distance_and_cosine_matrices(vectors, self_pairs):
    a = vectors
    b = None if self_pairs else vectors[:5] * 0.5
    args_j = (jnp.asarray(a),) if self_pairs else (jnp.asarray(a), jnp.asarray(b))
    args_t = (torch.from_numpy(a),) if self_pairs else (torch.from_numpy(a), torch.from_numpy(b))
    dj = np.asarray(jdist.distance_matrix(*args_j))
    dt = tdist.distance_matrix(*args_t).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    cj = np.asarray(jdist.cosine_similarity_matrix(*args_j))
    ct = tdist.cosine_similarity_matrix(*args_t).numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-5)
    if self_pairs:
        assert (np.diag(dt) == 0).all() and np.array_equal(dt, dt.T)


def test_entry_points_default_to_the_gpu():
    """Without ``device`` the entry points run on the GPU; where there is
    none they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    songs, durs = _songs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bliss_tpu_torch.analyze_pcm(songs, durs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCMBatch.from_arrays(songs, durs)
    assert PCMBatch.from_arrays(songs, durs, device="cpu").samples.device.type == "cpu"
