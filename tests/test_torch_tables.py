"""The port's constants, tables and config against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import bliss_tpu.constants as jC
import bliss_tpu.constants_filterbanks as jFB
from bliss_tpu import tables as jtables
from bliss_tpu.config import AnalysisConfig as JConfig

import bliss_tpu_torch.constants as tC
import bliss_tpu_torch.constants_filterbanks as tFB
from bliss_tpu_torch import tables as ttables
from bliss_tpu_torch.config import AnalysisConfig, check_supported, uses_kernels
from bliss_tpu_torch.convert import (
    FLOAT64_TABLES,
    config_from_reference,
    device_tables,
    reference_arrays,
    tables_from_numpy,
)
from bliss_tpu_torch.kernels.stft import fft_twiddles, hann_dft_table

torch.set_num_threads(1)


def _public(mod):
    return {k: v for k, v in vars(mod).items() if k.isupper()}


@pytest.mark.parametrize("pair", [(jC, tC), (jFB, tFB)], ids=["constants", "filterbanks"])
def test_constants_are_verbatim(pair):
    ref, port = (_public(m) for m in pair)
    assert ref.keys() == port.keys()
    for k, v in ref.items():
        assert np.array_equal(np.asarray(v), np.asarray(port[k])), k


TABLE_CALLS = [
    ("smoothing_kernel_iterated", ()),
    ("amplitude_weight_table", ()),
    ("amplitude_cdf_poly", ()),
    ("hann_window", ()),
    ("rdft_matrices", ()),
    ("rdft_matrices", (True,)),
    ("bandpass_filterbank", (1, 17, "firwin")),
    ("bandpass_filterbank", (3, 17, "firwin")),
    ("bandpass_filterbank", (5, 17, "reference5")),
    ("bandpass_filterbank", (36, 33, "reference36")),
    ("fir_warmup_correction", (1, 17, "firwin")),
    ("fir_warmup_correction", (5, 17, "reference5")),
    ("fir_warmup_correction", (36, 33, "reference36")),
    ("parseval_alt_sign", ()),
    ("iir_block_operator", (256,)),
    ("iir_block_operator", (64,)),
]


@pytest.mark.parametrize(
    "name,args", TABLE_CALLS, ids=[f"{n}{a}" for n, a in TABLE_CALLS]
)
def test_table_copy_equals_original(name, args):
    ref = getattr(jtables, name)(*args)
    port = getattr(ttables, name)(*args)
    ref = ref if isinstance(ref, tuple) else (ref,)
    port = port if isinstance(port, tuple) else (port,)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert np.array_equal(np.asarray(r), np.asarray(p))


def test_filterbank_shape_mismatch_raises_like_original():
    for mod in (jtables, ttables):
        with pytest.raises(ValueError):
            mod.bandpass_filterbank(4, 17, "reference5")


def test_hann_dft_table_is_the_jax_downmix_table_undone():
    """The JAX kernel's [1024, 512] duplicated-row matrix is this table
    halved with each row repeated per stereo pair."""
    dre, dim = jtables.rdft_matrices()
    h = jtables.hann_window()[:, None]
    cat = np.concatenate([h * dre[:, :256], h * dim[:, :256]], axis=1)
    tab = hann_dft_table()
    assert tab.shape == (512, 512)
    assert np.array_equal(tab, cat)


PRESETS = {
    "default": lambda: JConfig(),
    "for_tpu": JConfig.for_tpu,
    "for_parity": JConfig.for_parity,
    "for_tpu_hybrid": JConfig.for_tpu_hybrid,
    # the hybrid's two kernels with the working-dtype device finish (M7)
    "hybrid_device_finish": lambda: dataclasses.replace(
        JConfig.for_tpu_hybrid(), tempo_finish="device"
    ),
    "reference5": lambda: JConfig(
        fused_kernel=True, single_pass=True, filterbank="reference5",
        tempo_finish="device_exact",
    ),
}


def _port(preset):
    return config_from_reference(dataclasses.asdict(PRESETS[preset]()))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_config_from_reference_roundtrip(preset):
    ref = PRESETS[preset]()
    port = _port(preset)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port == AnalysisConfig(**dataclasses.asdict(ref))


def test_for_gpu_hybrid_is_for_tpu_hybrid():
    assert config_from_reference(dataclasses.asdict(JConfig.for_tpu_hybrid())) == (
        AnalysisConfig.for_gpu_hybrid()
    )


def test_for_gpu_is_for_tpu():
    assert config_from_reference(dataclasses.asdict(JConfig.for_tpu())) == (
        AnalysisConfig.for_gpu()
    )
    assert AnalysisConfig.for_gpu().torch_dtype == torch.float32


def test_config_fields_and_defaults_match():
    ref = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(AnalysisConfig)]
    assert ref == port
    with pytest.raises(ValueError):
        config_from_reference({"dtype": "float32"})


@pytest.mark.parametrize(
    "kwargs",
    [
        {"tempo_finish": "nope"},
        {"stft_conv": "nope"},
        {"single_pass": True, "fused_conv": "exact"},
        {"filterbank": "reference5", "nb_bands": 3},
        {"filterbank": "nope"},
    ],
)
def test_config_validation_matches(kwargs):
    with pytest.raises(ValueError):
        JConfig(**kwargs)
    with pytest.raises(ValueError):
        AnalysisConfig(**kwargs)


@pytest.mark.parametrize(
    "preset,item",
    [("default", "M7"), ("for_parity", "M7"), ("hybrid_device_finish", "M7"),
     ("band_taps_161", "M7")],
)
def test_unported_configs_name_their_roadmap_item(preset, item):
    """The configs that ROADMAP item ``item`` ported run: ``check_supported``
    takes them, and each takes the route ``bliss_tpu``'s ``_use_fused``
    gives it (the kernels for the fused float32 configs of at most 129
    taps, the XLA-path stage otherwise); an unknown mode name is refused
    with ValueError, as ``bliss_tpu`` refuses it at analysis time."""
    assert item == "M7"
    cfg = (AnalysisConfig(fused_kernel=True, band_taps=161) if preset == "band_taps_161"
           else _port(preset))
    check_supported(cfg)
    assert uses_kernels(cfg) == (preset == "hybrid_device_finish")
    for ok in (AnalysisConfig.for_gpu(), _port("reference5"), _port("for_tpu_hybrid"),
               AnalysisConfig.for_parity()):
        check_supported(ok)
        assert uses_kernels(ok) == (ok.dtype == "float32")
    assert AnalysisConfig.for_parity() == _port("for_parity")
    for field in ("amplitude_mode", "spectrum_mode", "tempo_energy_mode", "iir_mode"):
        with pytest.raises(ValueError, match=field):
            check_supported(dataclasses.replace(cfg, **{field: "nope"}))


def test_tables_from_numpy_takes_the_reference_tables():
    """Fed the arrays bliss_tpu built, the converter gives the same tensors
    as the port's own cache: in the kernels' dtypes, and all in float64 for
    the XLA-path stage."""
    _, _, c_pos = jtables.amplitude_cdf_poly()
    L, Z, M, N = jtables.iir_block_operator(256)
    rdft_re, rdft_im = jtables.rdft_matrices(zero_nyquist=True)
    ref = {
        "cheb": c_pos,
        "fir": jtables.bandpass_filterbank(1, 17, "firwin"),
        "warm": jtables.fir_warmup_correction(1, 17, "firwin"),
        "dft": hann_dft_table(),
        "twiddle": fft_twiddles(),
        "hann": jtables.hann_window(),
        "iir_L": L, "iir_Z": Z, "iir_M": M, "iir_N": N,
        "amp_table": jtables.amplitude_weight_table(),
        "rdft_re": rdft_re, "rdft_im": rdft_im,
        "alt": jtables.parseval_alt_sign(),
    }
    wide = tables_from_numpy(ref, "cpu", torch.float64)
    own64 = device_tables(1, 17, "firwin", "cpu", dtype=torch.float64)
    for k, t in wide.items():
        assert t.dtype == torch.float64 and torch.equal(t, own64[k]), k
        assert np.array_equal(t.numpy(), np.asarray(ref[k], np.float64)), k
    got = tables_from_numpy(ref, "cpu")
    own = device_tables(1, 17, "firwin", "cpu")
    assert got.keys() == own.keys() == reference_arrays(1, 17, "firwin").keys()
    for k, t in got.items():
        want = torch.float64 if k in FLOAT64_TABLES else torch.float32
        assert t.dtype == want and t.is_contiguous(), k
        assert torch.equal(t, own[k]), k
        assert np.array_equal(t.numpy(), np.asarray(ref[k], t.numpy().dtype)), k
