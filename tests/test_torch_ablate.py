"""The port's measurement kernels (``bliss_tpu_torch.ablate``) against the
TPU harnesses under ``scripts/``: each function of the scripts that reaches
``pl.pallas_call`` runs in Pallas interpret mode on the CPU, against the
plain PyTorch version that a CPU tensor runs, on the same seeded int16
input.

The scripts run their TPU benchmarks when imported, so they are not
imported: each is parsed with ``ast`` and only the function definitions a
test needs (including the nested ``call`` of ``run_variant`` and
``run_variant2``) are executed, in a namespace with small shapes (B=2,
chunks of 4096 samples, L=8192) and ``pallas_call`` in interpret mode.

Tolerances: sums of int16 values (|x| < 3000, at most 256 terms, below
2^24) are exact in float32 in any order; sums of squares and of int32
words read as float32 within 1e-6 of the row's sum of |term|; weight sums
within 1e-5 of |ref| + 1; the FIR statistics within 1e-5 of the block's
sum of z^2 (+1), 1e-4 for the float32 FIR (JAX's are float32 sums, the
port's float64).
"""

import ast
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bliss_tpu import tables as jtables

from bliss_tpu_torch.ablate import dma, fused, matred, packread, probe
from bliss_tpu_torch.kernels import fused_stats

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, CHUNK, BLK, K = 2, 8192, 4096, 256, 16


def _x() -> np.ndarray:
    """The scripts' input (uniform int16 in [-3000, 3000)) with silent
    stretches, so that some blocks are all zero."""
    x = np.random.RandomState(11).randint(-3000, 3000, size=(B, L)).astype(np.int16)
    x[0, :600] = 0
    x[1, 3000:3300] = 0
    return x


X = _x()
ALPHA, BETA = 1e-3, 1e-5


def _defs(script: str) -> dict:
    with open(os.path.join(REPO, "scripts", script)) as f:
        tree = ast.parse(f.read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _nested(fn: ast.FunctionDef, name: str) -> ast.FunctionDef:
    return next(n for n in fn.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _exec(nodes, ns: dict) -> dict:
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]), "<script>", "exec"), ns)
    return ns


@functools.lru_cache(maxsize=None)
def _base() -> dict:
    pl_interpret = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    pl_interpret.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    A, _, c_pos = jtables.amplitude_cdf_poly()
    return dict(
        jax=jax, jnp=jnp, np=np, pl=pl_interpret, pltpu=pltpu, functools=functools,
        tables=jtables, B=B, L=L, CHUNK=CHUNK, NBLK=CHUNK // BLK, NBLKP=CHUNK // BLK // 2,
        NC=L // CHUNK, BLK=BLK, K=K,
        alpha=jnp.full((B,), ALPHA, jnp.float32), beta=jnp.full((B,), BETA, jnp.float32),
        CHEB=tuple(float(v) for v in c_pos), HW=float(A),
        WARM=jnp.asarray(jtables.fir_warmup_correction()[0], jnp.float32),
        CONV=jnp.asarray(jtables.conv_band_matrix(), jnp.float32),
    )


def _torch_inputs():
    return (
        torch.from_numpy(X.copy()),
        torch.full((B,), ALPHA, dtype=torch.float32),
        torch.full((B,), BETA, dtype=torch.float32),
    )


def _close(got, ref, scale, tol, what):
    err = float((np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)) / scale).max())
    assert err <= tol, f"{what}: max error {err:.3e} of its scale > {tol:.0e}"


def _term_scale(x: torch.Tensor, nblk: int, mode: str) -> np.ndarray:
    """Each output's sum of |term| (the plain version on absolute terms),
    plus 1 for the rows of zeros."""
    return probe.probe_reference(x, nblk, mode, absolute=True).numpy().astype(np.float64) + 1.0


# ---- S1a: scripts/ablate_fused.py make_kernel / run_variant ------------------

S1A = {  # port variant -> make_kernel(do_cheb, do_conv, do_warm, prec)
    "full": (True, True, True, "HIGHEST"),
    "no_cheb": (False, True, True, "HIGHEST"),
    "no_conv": (True, False, True, "HIGHEST"),
    "no_warm": (True, True, False, "HIGHEST"),
    "fir_fp32": (True, True, True, "DEFAULT"),
    "bare": (False, False, False, "HIGHEST"),
}


@pytest.mark.parametrize("variant", list(S1A))
def test_stats_variant_matches_ablate_fused(variant):
    d = _defs("ablate_fused.py")
    ns = _exec([d["make_kernel"]], dict(_base()))
    cheb, conv, warm, prec = S1A[variant]
    ns["kern"] = ns["make_kernel"](cheb, conv, warm, getattr(jax.lax.Precision, prec))
    _exec([_nested(d["run_variant"], "call")], ns)
    ref = np.asarray(ns["call"](jnp.asarray(X)))  # [B, NC, 8, NBLK]

    x, a, b = _torch_inputs()
    got = fused.stats_variant(x, a, b, variant, chunk=CHUNK).numpy()
    assert got.shape == ref.shape == (B, L // CHUNK, 8, CHUNK // BLK)
    assert np.array_equal(got[:, :, 7], ref[:, :, 7]), "rownz"
    assert (got[:, :, 7] == 0).any() and (got[:, :, 7] == 1).any()
    _close(got[:, :, 6], ref[:, :, 6], np.abs(ref[:, :, 6]) + 1.0, 1e-5, "wsum")
    block_z2 = got[:, :, 1:2].astype(np.float64) + 1.0
    tol = 1e-4 if variant == "fir_fp32" else 1e-5
    _close(got[:, :, :6], ref[:, :, :6], block_z2, tol, f"{variant} s1..da")
    if variant in ("no_warm", "bare"):
        assert (got[:, :, 3:6] == 0).all()


def test_full_variant_is_the_shipped_kernels_plain_version():
    """``full`` is ``fused_stats``'s plain version, rearranged: its window
    energies assemble to ``fused_stats_reference``'s."""
    x, a, b = _torch_inputs()
    o = fused.stats_variant(x, a, b, "full", chunk=L)[:, 0]  # [B, 8, NBF]
    s1, s2, sa, d1, d2, da = (o[:, i] for i in range(6))
    en = 256.0 * (s2[:, :-1] + s2[:, 1:] + d2[:, :-1]) + (
        (s1[:, :-1] + s1[:, 1:] + d1[:, :-1]) ** 2 + (sa[:, :-1] + sa[:, 1:] + da[:, :-1]) ** 2
    ) / 2.0
    wsum, rownz, en0 = fused_stats.fused_stats_reference(x, a, b)
    assert torch.equal(o[:, 7], rownz.double()) and torch.equal(o[:, 6], wsum.double())
    en, en0 = en.numpy(), en0[:, 0].numpy()
    _close(en, en0, np.abs(en0) + 1e-3, 1e-12, "energies")


# ---- S1b: scripts/ablate_fused.py run_variant2 bodies ------------------------


@pytest.mark.parametrize("body", list(fused.BODIES))
def test_reduce_probe_matches_ablate_fused_bodies(body):
    d = _defs("ablate_fused.py")
    ns = _exec([d[f"v_{body}"]], dict(_base()))
    ns["body_fn"] = ns[f"v_{body}"]
    _exec([_nested(d["run_variant2"], "_kernel"), _nested(d["run_variant2"], "call")], ns)
    ref = np.asarray(ns["call"](jnp.asarray(X)))

    x = torch.from_numpy(X.copy())
    got = fused.reduce_probe(x, body, chunk=CHUNK).numpy()
    assert got.shape == ref.shape == (B, L // CHUNK, 8, CHUNK // BLK)
    if body == "six_sums":  # rows 1 and 7 sum squares; the others are exact
        exact = [0, 2, 3, 4, 5, 6]
        scale = _term_scale(*probe.rows(x, CHUNK), "sum6")
        _close(got[:, :, [1, 7]], ref[:, :, [1, 7]], scale[:, :, [1, 7]], 1e-6, "sum x^2")
        assert np.array_equal(got[:, :, exact], ref[:, :, exact])
    else:
        assert np.array_equal(got, ref)


# ---- S2: scripts/ablate_dma.py -----------------------------------------------


def _dma_ns():
    d = _defs("ablate_dma.py")
    return _exec([d["kernel_noin"], d["call_noin"], d["make_call_x"], d["make_call_touch"]],
                 dict(_base()))


def test_call_noin_matches_ablate_dma():
    ref = np.asarray(_dma_ns()["call_noin"](None)())
    got = dma.call_noin(torch.from_numpy(X.copy()), chunk=CHUNK).numpy()
    assert got.shape == ref.shape and np.array_equal(got, ref)


DTYPES = {"int16": (np.int16, torch.int16), "int32": (np.int32, torch.int32),
          "float32": (np.float32, torch.float32)}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_call_x_matches_ablate_dma(dtype):
    np_t, _ = DTYPES[dtype]
    xd = X.astype(np_t)
    ref = np.asarray(_dma_ns()["make_call_x"](getattr(jnp, dtype), BLK)(jnp.asarray(xd)))
    got = dma.call_x(torch.from_numpy(xd), chunk=CHUNK).numpy()
    assert got.shape == ref.shape and np.array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_call_touch_matches_ablate_dma(dtype):
    np_t, _ = DTYPES[dtype]
    xd = X.astype(np_t)
    ref = np.asarray(_dma_ns()["make_call_touch"](getattr(jnp, dtype))(jnp.asarray(xd)))
    got = dma.call_touch(torch.from_numpy(xd), chunk=CHUNK).numpy()
    assert got.shape == ref.shape and np.array_equal(got, ref)


# ---- S3: scripts/ablate_packread.py ------------------------------------------


@pytest.mark.parametrize("name", ["call_i16", "call_packed", "call_packed_nounpack"])
def test_packread_matches_ablate_packread(name):
    d = _defs("ablate_packread.py")
    ns = _exec([d[name]], dict(_base()))
    xin = X if name == "call_i16" else X.view(np.int32)
    ref = np.asarray(ns[name](jnp.asarray(xin)))
    x = torch.from_numpy(X.copy())
    arg = x if name == "call_i16" else packread.packed_words(x)
    got = getattr(packread, name)(arg, chunk=CHUNK).numpy()
    assert got.shape == ref.shape
    if name == "call_packed_nounpack":  # int32 words as float32: rounded sums
        scale = _term_scale(*probe.rows(arg, CHUNK // 2), "sum1")
        _close(got, ref, scale, 1e-6, "packed words")
    else:
        assert np.array_equal(got, ref)
    if name == "call_packed":  # the same sums as the int16 read, pairwise
        i16 = packread.call_i16(x, chunk=CHUNK).numpy()
        assert np.array_equal(got, i16[..., 0::2] + i16[..., 1::2])


# ---- S4: scripts/proto_matred.py ---------------------------------------------


@pytest.mark.parametrize("fit", [(18, 200), (14, 128)], ids=["cheb18_200", "cheb14_128"])
def test_proto_call_matches_proto_matred(fit):
    deg, hw = fit
    d = _defs("proto_matred.py")
    ns = _exec([d["cheb_coeffs"], d["reduce_mats"], d["make_proto"], d["proto_call"]],
               dict(_base()))
    ref = np.asarray(ns["proto_call"](jnp.asarray(X), ns["cheb_coeffs"](deg, hw), float(hw)))

    x, a, b = _torch_inputs()
    got = matred.proto_call(x, a, b, deg, hw, chunk=CHUNK).numpy()
    assert got.shape == ref.shape == (B, L // CHUNK, CHUNK // BLK, 8)
    assert np.array_equal(got[..., 7], ref[..., 7]), "nonzero count"
    _close(got[..., 6], ref[..., 6], np.abs(ref[..., 6]) + 1.0, 1e-5, "wsum")
    _close(got[..., :6], ref[..., :6], got[..., 2:3] + 1.0, 1e-5, "z, delta sums")


def test_numerics_report_on_the_plain_versions():
    """The script's own check: the shipped fit's energies equal the shipped
    kernel's (float64 both), the narrower fit moves only wsum."""
    x, a, b = _torch_inputs()
    r18 = matred.numerics_report(x, a, b, 18, 200)
    r14 = matred.numerics_report(x, a, b, 14, 128)
    assert r18["energy_max_rel"] < 1e-12 and r18["wsum_max_diff"] < 1e-3 and r18["rownz_agree"]
    assert r14["energy_max_rel"] < 1e-12 and r14["rownz_agree"]
    assert np.isfinite(r14["wsum_max_diff"])


# ---- the wrappers' contract on the CPU ---------------------------------------


def _counts():
    return fused.LAUNCHES, probe.LAUNCHES, matred.LAUNCHES


@pytest.mark.parametrize("mode", list(probe.MODES))
def test_probe_error_scale_is_positive(mode):
    """The scale each probe's rounding is stated against: the sum of |term|
    (for a copy, |value|), never negative or zero once 1 is added."""
    x = torch.from_numpy(X.view(np.int32).copy() if mode == "packed" else X.copy())
    rows, nblk = probe.rows(x, CHUNK // (2 if mode == "packed" else 1))
    scale = probe.probe_reference(rows, nblk, mode, absolute=True)
    ref = probe.probe_reference(rows, nblk, mode)
    assert (scale >= 0).all() and (scale * (1 + 1e-6) >= ref.abs()).all()


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    x, a, b = _torch_inputs()
    before = _counts()
    fused.stats_variant(x, a, b, "bare", chunk=CHUNK)
    fused.reduce_probe(x, "one_sum", chunk=CHUNK)
    dma.call_touch(x, chunk=CHUNK)
    packread.call_packed(packread.packed_words(x), chunk=CHUNK)
    matred.proto_call(x, a, b, chunk=CHUNK)
    assert _counts() == before


@pytest.mark.parametrize(
    "call",
    [
        lambda x, a, b: fused.stats_variant(x, a, b, "no_such_stage", chunk=CHUNK),
        lambda x, a, b: fused.stats_variant(x.int(), a, b, "full", chunk=CHUNK),
        lambda x, a, b: fused.stats_variant(x, a, b, "full", chunk=3000),
        lambda x, a, b: fused.reduce_probe(x, "seven_sums", chunk=CHUNK),
        lambda x, a, b: dma.call_x(x.double(), chunk=CHUNK),
        lambda x, a, b: dma.call_touch(x.double(), chunk=CHUNK),
        lambda x, a, b: dma.call_noin(x, chunk=1024),
        lambda x, a, b: packread.call_packed(x, chunk=CHUNK),
        lambda x, a, b: packread.call_i16(x.int(), chunk=CHUNK),
        lambda x, a, b: matred.proto_call(x, a[:1], b, chunk=CHUNK),
        lambda x, a, b: matred.proto_call(x, a, b, 40, 200, chunk=CHUNK),
        lambda x, a, b: probe.probe(x.reshape(B, -1, 128), 8, "sum1"),
    ],
    ids=["variant", "dtype", "chunk", "body", "x_float64", "float64", "small_chunk",
         "packed_int16", "i16_int32", "alpha_shape", "cheb_degree", "row_width"],
)
def test_wrappers_raise_on_what_the_kernels_do_not_take(call):
    x, a, b = _torch_inputs()
    before = _counts()
    with pytest.raises(ValueError):
        call(x, a, b)
    assert _counts() == before
