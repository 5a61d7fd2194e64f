"""The spectrum kernel's algorithm on the CPU. ``stft.rfft512_power_steps``
runs ``power_kernel``'s real FFT (csrc/power.cuh) step for step in PyTorch:
its lane layout, radix stages, exchanges, float32 twiddles and split step.
It is held to ``torch.fft.rfft``, to the plain version ``power_reference``
(the dense Hann-folded DFT product) and to JAX's ``pallas_stft.stft_power``;
and the kernel's tables and entry points are checked against what the
wrappers pass."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import synth_pcm
from bliss_tpu import tables as jtables
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.kernels.pallas_stft import stft_power as j_stft_power

from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import _build, stft

torch.set_num_threads(1)

CSRC = Path(stft.__file__).resolve().parent / "csrc"


def _windowed(mono: np.ndarray) -> torch.Tensor:
    """float32 mono frames [..., 512] times the kernel's float32 window."""
    hann = device_tables(1, 17, "firwin", "cpu")["hann"]
    return torch.from_numpy(mono.astype(np.float32)) * hann


def _frames(kind: str) -> np.ndarray:
    """[16, 512] integer mono frames: full-scale noise, a tone over noise,
    quiet noise (|x| <= 3, bins far below the peak), single impulses."""
    rng = np.random.RandomState(11)
    t = np.arange(16 * 512).reshape(16, 512)
    if kind == "noise":
        return rng.randint(-32768, 32768, size=t.shape)
    if kind == "tone":
        return np.rint(9000 * np.sin(2 * np.pi * t / 37.3) + 40 * rng.randn(*t.shape))
    if kind == "quiet":
        return rng.randint(-3, 4, size=t.shape)
    out = np.zeros(t.shape)
    out[np.arange(16), rng.randint(0, 512, size=16)] = rng.randint(-32768, 32768, size=16)
    return out


def _peak_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    peak = ref.amax(dim=-1, keepdim=True)
    silent = (peak == 0).expand_as(ref)
    assert torch.equal(got[silent], ref[silent])  # nothing counted: all zero
    rel = ((got - ref).abs() / peak.clamp_min(1e-300))[~silent]
    return float(rel.max()) if rel.numel() else 0.0


@pytest.mark.parametrize("kind", ["noise", "tone", "quiet", "impulse"])
def test_fft_steps_match_torch_rfft(kind):
    """Each frame's |X_k|^2, bins 0..255, within 1e-5 of its peak bin of
    float64 ``torch.fft.rfft`` of the same float32 windowed frame."""
    y = _windowed(_frames(kind))
    got = stft.rfft512_power_steps(y)
    assert got.shape == (16, 256) and got.dtype == torch.float32
    ref = torch.fft.rfft(y.double(), dim=-1)[:, :256].abs() ** 2
    assert _peak_rel(got, ref) < 1e-5


def _songs():
    rng = np.random.RandomState(5)
    a = synth_pcm(rng, 70_000)
    b = rng.randint(-32768, 32768, size=66_561).astype(np.int16)
    c = synth_pcm(rng, 48_000, amp=300)
    return [a, b, c], [3, 3, 2]


@pytest.fixture(scope="module")
def batches():
    songs, durs = _songs()
    return JBatch.from_arrays(songs, durs), PCMBatch.from_arrays(songs, durs, device="cpu")


def _fft_power(tb, offset) -> torch.Tensor:
    """[B, 257]: the kernel's algorithm summed over the frames that count."""
    n_frames = stft.frame_counts(tb.n_samples)
    off = None if offset is None else torch.full_like(n_frames, offset)
    mono = stft.mono_frames(tb.samples, n_frames, off)
    return stft.fold_power(stft.rfft512_power_steps(_windowed(mono.numpy())).sum(dim=1))


@pytest.mark.parametrize("offset", [None, 0, 30, 10_000], ids=["none", "0", "mid", "past"])
def test_fft_steps_summed_match_plain_and_jax(batches, offset):
    """Summed over the frames that count: within 1e-5 of each song's peak
    bin of the plain version (the dense float32 DFT product) and of the
    5-matmul "precise" JAX kernel; past every song's frames exactly 0."""
    jb, tb = batches
    got = _fft_power(tb, offset)
    assert got.shape == (3, 257) and (got[:, -1] == 0).all()
    plain = stft.stft_power_reference(tb.samples, tb.n_samples, frame_offset=offset)
    jax_ref = j_stft_power(jb.samples, jb.n_samples, frame_offset=offset, precise=True)
    assert _peak_rel(got, plain) < 1e-5
    assert _peak_rel(got, torch.from_numpy(np.asarray(jax_ref))) < 1e-5
    if offset == 10_000:
        assert (got == 0).all()


def test_twiddle_and_window_tables_are_their_float64_construction():
    tabs = device_tables(1, 17, "firwin", "cpu")
    k = np.arange(512)
    w = np.exp(-2j * np.pi * k / 512)
    assert tabs["twiddle"].dtype == torch.float32 and tabs["twiddle"].shape == (512, 2)
    assert np.array_equal(tabs["twiddle"].numpy(), np.stack([w.real, w.imag], 1).astype(np.float32))
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * k / 511))
    assert tabs["hann"].dtype == torch.float32 and tabs["hann"].shape == (512,)
    assert np.array_equal(tabs["hann"].numpy(), hann.astype(np.float32))
    assert np.array_equal(tabs["hann"].numpy(), jtables.hann_window().astype(np.float32))


def _c_argtypes(source: str, fn: str) -> list:
    """The ctypes types of ``int fn(...)``'s parameters in ``source``:
    c_void_p for a pointer, c_int for an int, c_float for a float."""
    m = re.search(rf"\bint {fn}\(([^)]*)\)", source)
    assert m, fn
    params = [p.strip() for p in m.group(1).split(",") if p.strip()]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    return [ctypes.c_void_p if "*" in p else kinds[p.split()[0]] for p in params]


@pytest.mark.parametrize("fn", sorted(_build._SIGNATURES["fused_all"]))
def test_entry_points_take_the_bound_arguments(fn):
    """Each C entry point of csrc/fused_all.cu takes the arguments, in
    order and type, that ``_build`` binds it with (the stream last)."""
    source = (CSRC / "fused_all.cu").read_text()
    assert _c_argtypes(source, fn) == _build._SIGNATURES["fused_all"][fn]
