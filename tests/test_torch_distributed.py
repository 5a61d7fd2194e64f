"""``bliss_tpu_torch/parallel/distributed.py`` against
``tests/test_distributed.py``: the set-up with ``torch.distributed``
monkeypatched where those tests patch ``jax.distributed``, and one real
two-process gloo run whose (1, 2) mesh, one shard a rank, gives the rows
of the in-process (1, 2) mesh bit for bit."""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from bliss_tpu_torch import AnalysisConfig
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.parallel import analysis_mesh, analyze_sharded_async, sharded_distance_topk
from bliss_tpu_torch.parallel import distributed as dist
from bliss_tpu_torch.parallel.collectives import LocalGroup

torch.set_num_threads(1)


@pytest.fixture
def alone(monkeypatch):
    """No group yet and no launcher environment."""
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl")])
def test_init_distributed_passes_arguments(monkeypatch, alone, device, backend):
    calls = {}

    def fake_init(backend, init_method=None, world_size=-1, rank=-1):
        calls.update(backend=backend, addr=init_method, n=world_size, pid=rank)

    monkeypatch.setattr(tdist, "init_process_group", fake_init)
    monkeypatch.setattr(tdist, "get_world_size", lambda: 4)
    monkeypatch.setattr(tdist, "get_rank", lambda: 2)
    dist.init_distributed("10.0.0.1:1234", 4, 2, device=device)
    assert calls == {"backend": backend, "addr": "tcp://10.0.0.1:1234", "n": 4, "pid": 2}
    dist.init_distributed("file:///shared/store", 4, 2, device=device)
    assert calls["addr"] == "file:///shared/store"


def test_init_distributed_survives_single_process(monkeypatch, alone):
    def fake_init(*a, **kw):
        raise RuntimeError("the coordinator cannot be reached")

    monkeypatch.setattr(tdist, "init_process_group", fake_init)
    dist.init_distributed("10.0.0.1:1234", 4, 2, device="cpu")  # must not raise


def test_init_distributed_without_a_cluster_stays_alone(monkeypatch, alone):
    called = []
    monkeypatch.setattr(tdist, "init_process_group", lambda *a, **kw: called.append(kw))
    events = []
    monkeypatch.setattr(dist, "log_event", lambda logger, msg, **kw: events.append(msg))
    dist.init_distributed(device="cpu")
    assert called == [] and events == ["single-process mode"]


def test_init_distributed_noop_when_already_initialized(monkeypatch):
    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    called = []
    monkeypatch.setattr(tdist, "init_process_group", lambda *a, **kw: called.append(kw))
    dist.init_distributed("10.0.0.1:1234", 4, 2, device="cpu")
    assert called == []


def test_pod_mesh_spans_all_devices(alone):
    mesh = dist.pod_mesh(n_seq=2, devices=["cpu"] * 8)
    assert mesh.axis_names == ("data", "seq")
    assert mesh.size == 8 and mesh.process is None
    assert mesh.shape == {"data": 4, "seq": 2}


def test_pod_mesh_runs_a_collective(alone):
    """The pod mesh is usable by the collectives the sharded stage runs."""
    mesh = dist.pod_mesh(devices=["cpu"] * 8)
    group = LocalGroup([dev for _, dev in mesh.cells()])
    out = group.psum([torch.ones(()) for _ in range(mesh.size)])
    assert [t.item() for t in out] == [mesh.size] * mesh.size


# --- two processes over gloo ------------------------------------------------

CONFIGS = {
    "main_extended": (AnalysisConfig.for_gpu(), True),
    "hybrid": (AnalysisConfig.for_gpu_hybrid(), False),
    "float64": (AnalysisConfig(dtype="float64"), True),
}


def _batch():
    """Two songs whose (1, 2) shards of 81 920 samples take the kernels."""
    rng = np.random.RandomState(5)
    t = np.arange(150_000)
    songs = []
    for i, n in enumerate((150_000, 131_000)):
        beat = 0.15 + 0.85 * ((t[:n] // 4096) % 2)
        sig = (9000 - 900 * i) * beat * np.sin(2 * np.pi * t[:n] / 47.0) + 400 * rng.randn(n)
        songs.append(np.clip(sig, -32768, 32767).astype(np.int16))
    return PCMBatch.from_arrays(songs, [7, 6], pad_multiple=1024 * 160, device="cpu")


def _features():
    return (np.random.RandomState(3).randn(29, 4) * 3).astype(np.float32)


def _rows(mesh):
    out = {name: analyze_sharded_async(_batch(), mesh, cfg, ext)()
           for name, (cfg, ext) in CONFIGS.items()}
    d, i = sharded_distance_topk(_features(), mesh, 3, block=4)
    out["topk_d"], out["topk_i"] = d.numpy(), i.numpy()
    return out


def _gloo_rank(rank, store, out_dir):
    torch.set_num_threads(1)
    dist.init_distributed(f"file://{store}", 2, rank, device="cpu")
    try:
        mesh = dist.pod_mesh(n_seq=2)
        assert mesh.process is not None and mesh.shape == {"data": 1, "seq": 2}
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **_rows(mesh))
    finally:
        tdist.destroy_process_group()


def test_two_gloo_processes_match_the_in_process_mesh(tmp_path):
    ctx = tmp.start_processes(_gloo_rank, args=(str(tmp_path / "store"), str(tmp_path)),
                              nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError("the two gloo processes did not finish within 240 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    local = _rows(analysis_mesh(1, 2, devices=["cpu", "cpu"]))
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert sorted(got.files) == sorted(local)
        for name, rows in local.items():
            np.testing.assert_array_equal(got[name], rows, err_msg=f"rank {rank} {name}")
