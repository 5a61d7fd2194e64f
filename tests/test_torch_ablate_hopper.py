"""The Hopper designs of the measurement kernels A2 (``bliss_probe``) and
A3 (``bliss_matred_stats``) of ``kernels/csrc/ablate.cu``, step for step on
the CPU.

``probe.probe_lane_steps`` runs A2's stripes of 32 rows, its lanes' 16-byte
reads and its shuffle order; ``matred.matred_mma_steps`` runs A3's runs of
8 hop blocks, its swizzled ring, the FIR as im2col tiles times the banded
Toeplitz fragments, delta as one product a run, and its reduce-scatter.
Each twin is held to its plain version (``probe_reference``,
``matred_reference``) and, on the scripts' shape, to the TPU harness it
replaces (``scripts/ablate_*.py``, ``scripts/proto_matred.py`` in Pallas
interpret mode; the plain versions are held to them in
``tests/test_torch_ablate.py``).

Tolerances: A2's copies (zero, slice, convert) identical, and so are sums
of int16 values in float32 (exact in any order); other float32 sums within
1e-6 (16 float32 ulps) of the row's sum of |term|. A3's float64 columns
within 1e-12 of |ref| plus the block's sum of z^2, + 1 (the two differ in
summation order only), counts identical, wsum within 1e-6 relative; NaN
at the same places (a silent song's infinite normalization).
"""

import numpy as np
import pytest
import torch

from test_torch_ablate import BLK, CHUNK, X, _base, _close, _defs, _exec, _nested, _torch_inputs
from bliss_tpu_torch.ablate import dma, fused, matred, packread, probe
from bliss_tpu_torch.kernels import fused_stats

torch.set_num_threads(1)

# (mode, dtype) pairs the kernel takes
PROBES = [(m, d) for d in (torch.int16, torch.int32, torch.float32) for m in probe.MODES
          if m != "packed" or d == torch.int32]
# (R, nblk): stripes of 32 with a ragged last one, one short stripe, whole
# stripes, and chunks wider than a row (slice's j >= 256 is zero)
SHAPES = [(80, 40), (32, 16), (64, 64), (288, 288)]


def _rows(dtype, R, seed=5):
    rng = np.random.RandomState(seed)
    if dtype == torch.int32:  # full-range words: their float32 sums round
        x = rng.randint(-2**31, 2**31 - 1, size=(2, R, 256), dtype=np.int64)
    else:
        x = rng.randint(-3000, 3000, size=(2, R, 256))
        x[0, : R // 3] = 0
    return torch.from_numpy(x).to(dtype)


def _probe_err(got, ref, x, nblk, mode):
    scale = probe.probe_reference(x, nblk, mode, absolute=True).double() + 1.0
    return float(((got.double() - ref.double()).abs() / scale).max())


@pytest.mark.parametrize("R,nblk", SHAPES, ids=[f"R{r}_nblk{n}" for r, n in SHAPES])
@pytest.mark.parametrize("mode,dtype", PROBES, ids=[f"{m}-{str(d)[6:]}" for m, d in PROBES])
def test_probe_lane_steps_match_plain(mode, dtype, R, nblk):
    x = _rows(dtype, R)
    got = probe.probe_lane_steps(x, nblk, mode)
    ref = probe.probe_reference(x, nblk, mode)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, R // nblk, 8, nblk)
    if mode in ("zero", "slice", "convert") or (mode in ("sum1", "packed") and dtype != torch.int32):
        assert torch.equal(got, ref)
    else:
        assert _probe_err(got, ref, x, nblk, mode) <= 1e-6


def test_probe_lane_steps_read_each_lanes_elements():
    """A lane's 8 elements: 8l .. 8l+7 of an int16 row, 4l .. 4l+3 and
    128+4l .. 128+4l+3 of a 4-byte row (two coalesced 16-byte loads)."""
    idx = torch.arange(256, dtype=torch.int32).reshape(1, 1, 256)
    lanes16 = probe._lane_terms(idx.to(torch.int16), "sum1")[0, 0]
    lanes32 = probe._lane_terms(idx, "sum1")[0, 0]
    assert torch.equal(lanes16[3], torch.arange(24, 32, dtype=torch.float32))
    assert torch.equal(lanes32[3], torch.tensor([12, 13, 14, 15, 140, 141, 142, 143.0]))
    for lanes in (lanes16, lanes32):
        assert torch.equal(lanes.flatten().sort().values, torch.arange(256, dtype=torch.float32))


# ---- the twins on the scripts' shape, against the TPU harnesses ---------------


def _dma_ns():
    d = _defs("ablate_dma.py")
    return _exec([d["kernel_noin"], d["call_noin"], d["make_call_x"], d["make_call_touch"]],
                 dict(_base()))


def _script_probe(name):
    """(JAX output, the twin's, the twin's rows and mode) for one of the
    scripts' read-and-reduce functions on the shared input X."""
    import jax.numpy as jnp

    x = torch.from_numpy(X.copy())
    if name.startswith("body_"):
        body = name[5:]
        d = _defs("ablate_fused.py")
        ns = _exec([d[f"v_{body}"]], dict(_base()))
        ns["body_fn"] = ns[f"v_{body}"]
        _exec([_nested(d["run_variant2"], "_kernel"), _nested(d["run_variant2"], "call")], ns)
        ref, rows, mode = ns["call"](jnp.asarray(X)), probe.rows(x, CHUNK), fused.BODIES[body]
    elif name == "noin":
        ref, rows, mode = _dma_ns()["call_noin"](None)(), probe.rows(x, CHUNK), "zero"
    elif name.startswith("x_") or name.startswith("touch_"):
        kind, dt = name.split("_")
        np_t, t_t = {"int16": (np.int16, torch.int16), "int32": (np.int32, torch.int32),
                     "float32": (np.float32, torch.float32)}[dt]
        xd = X.astype(np_t)
        ns = _dma_ns()
        fn = ns["make_call_x"](getattr(jnp, dt), BLK) if kind == "x" else ns["make_call_touch"](getattr(jnp, dt))
        ref = fn(jnp.asarray(xd))
        rows, mode = probe.rows(torch.from_numpy(xd), CHUNK), "slice" if kind == "x" else "sum1"
    else:
        d = _defs("ablate_packread.py")
        ns = _exec([d[name]], dict(_base()))
        words = X if name == "call_i16" else X.view(np.int32)
        ref = ns[name](jnp.asarray(words))
        t = x if name == "call_i16" else packread.packed_words(x)
        rows = probe.rows(t, CHUNK // (1 if name == "call_i16" else 2))
        mode = "packed" if name == "call_packed" else "sum1"
    return np.asarray(ref), probe.probe_lane_steps(*rows, mode), rows, mode


SCRIPT_PROBES = ([f"body_{b}" for b in fused.BODIES] + ["noin"]
                 + [f"x_{d}" for d in ("int16", "int32", "float32")]
                 + [f"touch_{d}" for d in ("int16", "float32")]
                 + ["call_i16", "call_packed", "call_packed_nounpack"])


@pytest.mark.parametrize("name", SCRIPT_PROBES)
def test_probe_lane_steps_match_the_scripts(name):
    ref, got, (x, nblk), mode = _script_probe(name)
    got = got.numpy()
    assert got.shape == ref.shape
    if mode == "sum6" or (mode == "sum1" and x.dtype == torch.int32):
        scale = probe.probe_reference(x, nblk, mode, absolute=True).numpy().astype(np.float64) + 1.0
        _close(got, ref, scale, 1e-6, name)
    else:
        assert np.array_equal(got, ref)


# ---- A3 -----------------------------------------------------------------------


def _matred_inputs(L, seed=7, silent=False):
    """B=2: the scripts' uniform int16 with silent stretches and a loud
    burst; the second song full-range noise, or all zero (``silent``: an
    infinite normalization). alpha and beta from the prepass."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-3000, 3000, size=(2, L)).astype(np.int16)
    x[0, :600] = 0
    x[0, 3000:3300] = 0
    x[0, 5000:5200] = rng.randint(-32768, 32768, size=200)
    x[1] = 0 if silent else rng.randint(-32768, 32768, size=L)
    x = torch.from_numpy(x)
    alpha, beta, _ = fused_stats.normalization(x, torch.full((2,), L, dtype=torch.int32))
    return x, alpha, beta


def _check_matred(got, ref):
    assert got.dtype == ref.dtype == torch.float64 and got.shape == ref.shape
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    ok = ~torch.isnan(ref[..., 0])
    g, r = got[ok], ref[ok]
    assert torch.equal(g[:, 7], r[:, 7]), "count"
    assert float(((g[:, 6] - r[:, 6]).abs() / (r[:, 6].abs() + 1.0)).max()) <= 1e-6, "wsum"
    scale = r[:, :6].abs() + r[:, 2:3] + 1.0
    err = float(((g[:, :6] - r[:, :6]).abs() / scale).max())
    assert err <= 1e-12, f"z and delta columns: {err:.3e}"


# 35 hop blocks: four runs of 8 and a ragged run of 3
@pytest.mark.parametrize("fit", [(18, 200), (14, 128)], ids=["cheb18_200", "cheb14_128"])
@pytest.mark.parametrize("taps", [2, 17, 129])
def test_matred_mma_steps_match_plain(taps, fit):
    L = 35 * 256
    x, a, b = _matred_inputs(L)
    got = matred.matred_mma_steps(x, a, b, *fit, chunk=L, taps=taps)
    ref = matred.matred_reference(x, a, b, *fit, chunk=L, taps=taps)
    assert got.shape == (2, 1, 35, 8)
    _check_matred(got, ref)


def test_matred_mma_steps_make_a_silent_songs_columns_nan():
    L = 35 * 256
    x, a, b = _matred_inputs(L, silent=True)
    got = matred.matred_mma_steps(x, a, b, chunk=L)
    ref = matred.matred_reference(x, a, b, chunk=L)
    assert torch.isnan(ref[1]).all() and not torch.isnan(ref[0]).any()
    _check_matred(got, ref)


@pytest.mark.parametrize("fit", [(18, 200), (14, 128)], ids=["cheb18_200", "cheb14_128"])
def test_matred_mma_steps_match_proto_matred(fit):
    """The script's own tolerances (its float32 sums): counts identical,
    wsum within 1e-5 of |ref| + 1, the z and delta columns within 1e-5 of
    the block's sum of z^2 (+1)."""
    import jax.numpy as jnp

    deg, hw = fit
    d = _defs("proto_matred.py")
    ns = _exec([d["cheb_coeffs"], d["reduce_mats"], d["make_proto"], d["proto_call"]],
               dict(_base()))
    ref = np.asarray(ns["proto_call"](jnp.asarray(X), ns["cheb_coeffs"](deg, hw), float(hw)))
    x, a, b = _torch_inputs()
    got = matred.matred_mma_steps(x, a, b, deg, hw, chunk=CHUNK).numpy()
    assert got.shape == ref.shape
    assert np.array_equal(got[..., 7], ref[..., 7]), "nonzero count"
    _close(got[..., 6], ref[..., 6], np.abs(ref[..., 6]) + 1.0, 1e-5, "wsum")
    _close(got[..., :6], ref[..., :6], got[..., 2:3] + 1.0, 1e-5, "z, delta sums")


def _slots(pairs):
    return matred.ring_slot(torch.as_tensor(pairs)) % 8  # 16-byte slot of a 128-byte line


def test_ring_slots_are_a_bijection_free_of_bank_conflicts():
    """The ring's 256 pairs land on 256 distinct slots; a quarter-warp's
    four 16-byte stores (lanes 8p .. 8p+7, pair 4l + j) and its A-fragment
    loads (8 consecutive pairs from a multiple of 4) each hit 8 distinct
    slots of a 128-byte line."""
    assert torch.equal(matred.ring_slot(torch.arange(256)).sort().values, torch.arange(256))
    base = matred.MRING // 4  # pair of the block's sample 0
    for p in range(4):
        for j in range(4):
            lanes = torch.arange(8 * p, 8 * p + 8)
            assert len(set(_slots(base + 4 * lanes + j).tolist())) == 8
    for start in range(0, 256, 4):
        assert len(set(_slots(torch.arange(start, start + 8)).tolist())) == 8


def test_reduce_scatter_adds_every_lane_once():
    v = torch.from_numpy(np.random.RandomState(1).randn(3, 32, 8))
    got = matred._reduce_scatter(v)
    assert got.shape == (3, 8)
    assert torch.allclose(got, v.sum(dim=1), rtol=1e-14, atol=1e-13)
