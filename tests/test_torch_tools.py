"""The port's tools (``bliss_tpu_torch/tools/``) on the CPU: ``gen_library``
writes ``scripts/gen_library.py``'s files byte for byte (and reuses a
larger run's files as it does), its ``library_pcm`` is what the decoder
reads back, and the port's ``analyze_library`` scans them;
``bench_similarity`` at N = 2000 checks row 0 and gives
``nearest_neighbors_all``'s distances; ``demo_scale`` runs its three parts
at small sizes; each tool needs a GPU unless it is given ``--device cpu``."""

import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

from bliss_tpu_torch import api
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.io import decode
from bliss_tpu_torch.pipeline import analyze_library
from bliss_tpu_torch.sim.distance import nearest_neighbors_all
from bliss_tpu_torch.tools import bench_similarity, demo_scale, gen_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import gen_library as jgen  # noqa: E402  (imports bliss_tpu.io.flac_writer, no JAX)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen_library")
    return (jgen.make_library(str(root / "jax"), 3, 2, 7),
            gen_library.make_library(str(root / "port"), 3, 2, 7), root)


def test_gen_library_writes_the_scripts_files(libraries):
    jax_files, port_files, root = libraries
    assert [os.path.basename(p) for p in port_files] == [os.path.basename(p) for p in jax_files]
    assert all(filecmp.cmp(a, b, shallow=False) for a, b in zip(jax_files, port_files))
    assert sorted(os.listdir(root / "port")) == sorted(os.listdir(root / "jax"))
    assert len({open(p, "rb").read() for p in port_files}) == 3  # distinct songs


def test_gen_library_reuses_a_larger_run(libraries, monkeypatch):
    _, port_files, root = libraries
    monkeypatch.setattr(gen_library, "frame_bytes", lambda *a: pytest.fail("regenerated"))
    assert gen_library.make_library(str(root / "port"), 2, 2, 7) == port_files[:2]
    assert gen_library.make_library(str(root / "port"), 3, 2, 7) == port_files
    assert not os.path.exists(root / "port" / ".generated-2-2-7")


def test_gen_library_main(tmp_path, capsys):
    assert gen_library.main([str(tmp_path), "2", "1", "3"]) == 0
    assert capsys.readouterr().out.startswith(f"2 songs in ")
    assert sorted(os.listdir(tmp_path)) == [".generated-2-1-3", "song00000.flac", "song00001.flac"]
    assert gen_library.main([]) == 2


def test_library_pcm_is_what_the_decoder_reads(libraries):
    _, port_files, _ = libraries
    pcm = gen_library.library_pcm(3, 2, 7)
    for path, samples in zip(port_files, pcm):
        d = decode(path)
        assert (d.channels, d.sample_rate, d.duration) == (2, 22050, 2)
        np.testing.assert_array_equal(d.samples, samples)


def test_the_port_scans_the_generated_library(libraries):
    _, port_files, _ = libraries
    res = analyze_library(port_files, batch_size=3, device="cpu", handle_sigint=False)
    assert res.ok.all() and not res.errors and np.isfinite(res.features).all()
    want = api.analyze_pcm(gen_library.library_pcm(3, 2, 7), [2] * 3, device="cpu")
    np.testing.assert_array_equal(res.features[:, 0], want[:, 0])
    np.testing.assert_allclose(res.features, want, rtol=0, atol=1e-5)


def test_bench_similarity_on_the_cpu(capsys):
    assert bench_similarity.main(["--device", "cpu", "--n", "2000", "--trials", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct_row0"] is True
    assert (line["n"], line["dim"], line["k"], line["block"], line["device"]) == (2000, 4, 5, 4096, "cpu")
    assert line["seconds"] >= 0 and line["pairs_per_sec"] > 0


@pytest.mark.parametrize("dim", [4, 49])
def test_bench_similarity_gives_nearest_neighbors_alls_distances(dim):
    record, dists = bench_similarity.bench(2000, dim, 5, 512, 1, "cpu")
    assert record["correct_row0"] is True and record["dim"] == dim
    feats = np.random.RandomState(0).randn(2000, dim).astype(np.float32) * 3
    want, _ = nearest_neighbors_all(feats, 5, block=512, device="cpu")
    np.testing.assert_array_equal(dists, want.numpy())


def test_demo_scale_similarity_at_small_sizes():
    lines = []
    out = demo_scale.similarity(torch.device("cpu"), n_pairs=600, n_kmeans=3000, top=10,
                                clusters=4, iters=5, log=lines.append)
    assert set(out) == {"distance_matrix", "topk", "kmeans"} and all(v > 0 for v in out.values())
    assert lines[0].startswith("600 x 600 distance matrix:") and "top-10 neighbors" in lines[1]
    assert lines[2].startswith("3k-song k-means (k=4, 5 iters):")


def test_demo_scale_scan_at_small_sizes():
    lines = []
    res, secs = demo_scale.scan(torch.device("cpu"), n_songs=4, seconds=2, batch_size=4,
                                log=lines.append)
    assert res.ok.all() and secs > 0 and len(res.files) == 4
    assert lines[0].startswith("e2e library scan (4/4 songs") and lines[1].startswith("stage seconds:")
    want = api.analyze_pcm(gen_library.library_pcm(4, 2), [2] * 4, cfg=AnalysisConfig.for_gpu(),
                           device="cpu")
    np.testing.assert_array_equal(res.features[:, 0], want[:, 0])
    np.testing.assert_allclose(res.features, want, rtol=0, atol=1e-5)
    assert not any(os.path.exists(os.path.dirname(p)) for p in res.files)  # cleaned up


@pytest.mark.parametrize("tool", [bench_similarity, demo_scale])
def test_tools_need_a_gpu_unless_asked_for_the_cpu(tool, monkeypatch):
    monkeypatch.delenv("BLISS_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])


def test_the_device_variable_is_read_as_the_cli_reads_it(monkeypatch, capsys):
    monkeypatch.setenv("BLISS_TPU_TORCH_DEVICE", "cpu")
    assert bench_similarity.main(["--n", "300", "--trials", "1"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["device"] == "cpu"
