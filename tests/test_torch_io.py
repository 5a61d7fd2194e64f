"""The port's decode layer against bliss_tpu's: the native sources, the FLAC
writer, decode, probe, iter_decode and encode, on files written from seeded
NumPy PCM (conftest.synth_pcm) with bliss_tpu's writer."""

import dataclasses
import os

import numpy as np
import pytest

from conftest import synth_pcm
from bliss_tpu import io as jio
from bliss_tpu.io.flac_writer import write_flac as j_write_flac

from bliss_tpu_torch import io as tio
from bliss_tpu_torch.io import decoder as tdecoder
from bliss_tpu_torch.io.flac_writer import write_flac

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (interleaved samples written, channels, sample rate)
FILES = {
    "stereo22k": (70_000, 2, 22050),
    "mono": (50_000, 1, 22050),
    "stereo44k": (120_000, 2, 44100),  # decode resamples it to 22.05 kHz
}


@pytest.fixture(scope="session")
def library(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_io")
    paths = {}
    for i, (name, (n, ch, sr)) in enumerate(FILES.items()):
        pcm = synth_pcm(np.random.RandomState(40 + i), n)
        paths[name] = str(d / f"{name}.flac")
        j_write_flac(paths[name], pcm.reshape(-1, ch), sr,
                     tags={"ARTIST": "synth", "TITLE": name, "TRACKNUMBER": str(i)})
    bad = d / "broken.flac"
    bad.write_bytes(b"fLaC but not really")
    paths["broken"] = str(bad)
    return paths


@pytest.mark.parametrize("name", ["decoder.cc", "Makefile"])
def test_native_sources_are_byte_identical(name):
    port = os.path.join(REPO, "bliss_tpu_torch", "io", "_native", name)
    orig = os.path.join(REPO, "bliss_tpu", "io", "_native", name)
    with open(port, "rb") as f, open(orig, "rb") as g:
        assert f.read() == g.read()


def test_native_library_builds_outside_the_package():
    """The shim builds at first use into build/bliss_tpu_torch/, never into
    the package directory."""
    assert tio.native_version() == jio.native_version()
    lib = tdecoder._ensure_built()
    assert os.path.commonpath([lib, os.path.join(REPO, "build", "bliss_tpu_torch")]) == \
        os.path.join(REPO, "build", "bliss_tpu_torch")
    assert not [f for f in os.listdir(tdecoder._NATIVE_DIR) if f.endswith(".so")]


def test_flac_writer_writes_the_same_bytes(tmp_path):
    frames = synth_pcm(np.random.RandomState(7), 2 * 9000).reshape(-1, 2)
    tags = {"ARTIST": "a", "TITLE": "t"}
    write_flac(str(tmp_path / "port.flac"), frames, 44100, tags=tags)
    j_write_flac(str(tmp_path / "jax.flac"), frames, 44100, tags=tags)
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()


@pytest.mark.parametrize("name", sorted(FILES))
def test_decode_matches_jax(library, name):
    got, ref = tio.decode(library[name]), jio.decode(library[name])
    assert got.samples.dtype == np.int16
    np.testing.assert_array_equal(got.samples, ref.samples)
    fields = {f.name for f in dataclasses.fields(ref)} - {"samples"}
    assert {k: getattr(got, k) for k in fields} == {k: getattr(ref, k) for k in fields}
    assert got.channels == 2 and got.sample_rate == 22050
    assert got.resampled == (FILES[name][2] != 22050 or FILES[name][1] != 2)
    np.testing.assert_array_equal(got.as_frames(), ref.as_frames())


@pytest.mark.parametrize("name", sorted(FILES))
def test_probe_matches_jax(library, name):
    got, ref = tio.probe(library[name]), jio.probe(library[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.title == name


def test_broken_file_raises_decode_error(library):
    with pytest.raises(tio.DecodeError):
        tio.decode(library["broken"])
    with pytest.raises(tio.DecodeError):
        tio.probe(library["broken"])
    with pytest.raises(tio.DecodeError):
        tio.decode(os.path.join(os.path.dirname(library["broken"]), "missing.flac"))


def test_iter_decode_keeps_order_and_skips_a_broken_file(library):
    names = ["stereo44k", "broken", "stereo22k", "mono"]
    files = [library[n] for n in names]
    perf = {}
    out = list(tio.iter_decode(files, num_workers=2, prefetch=1, perf=perf))
    assert [f for f, _ in out] == files
    assert out[1][1] is None
    for (_, d), f in zip(out, files):
        if d is not None:
            np.testing.assert_array_equal(d.samples, jio.decode(f).samples)
    assert perf["decoded"] == 4
    assert perf["decode_seconds"] > 0
    batch = tio.decode_batch(files, num_workers=2, on_error="skip")
    assert [b is None for b in batch] == [False, True, False, False]
    with pytest.raises(tio.DecodeError):
        tio.decode_batch(files, num_workers=2)


def test_encode_decodes_the_same_in_both_packages(tmp_path):
    """A compressed FLAC from the port's encoder decodes bit-exactly, and to
    the same PCM in both packages."""
    pcm = synth_pcm(np.random.RandomState(8), 2 * 22050)
    p = str(tmp_path / "enc.flac")
    tio.encode(p, pcm)
    got = tio.decode(p)
    np.testing.assert_array_equal(got.samples, pcm)
    np.testing.assert_array_equal(got.samples, jio.decode(p).samples)
    with pytest.raises(tio.EncodeError):
        tio.encode(str(tmp_path / "odd.flac"), np.zeros(3, np.int16))

