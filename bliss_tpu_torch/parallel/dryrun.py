"""A correctness dry run of the mesh (counterpart of
``__graft_entry__.dryrun_multichip``).

On a ('data', 'seq') mesh of ``device`` repeated N times (N even: 'seq' 2),
every sharded result is held to the same batch analyzed unsharded: the
device-exact path, the hybrid path with two bands and the extended columns,
the kernel branch (shards of at least 65536 samples: the prepass, K2 and
K3 a shard, their plain versions on the CPU), then the row-sharded top-k
against ``nearest_neighbors_all`` and a dense NumPy distance matrix. A
collective that corrupts its data fails the run rather than passing a
finiteness probe.
"""

from __future__ import annotations

import numpy as np
import torch


def _example_arrays(B: int, L: int):
    """``__graft_entry__._example_batch``'s songs: strong amplitude-modulated
    beats, so that the beat-derived features are stable, zeros at both
    ends."""
    rng = np.random.RandomState(0)
    t = np.arange(L)
    beat = 0.15 + 0.85 * ((t // 4096) % 2)
    sig = 9000 * beat * np.sin(2 * np.pi * t / 50.0) + rng.randn(L) * 300
    pcm = np.clip(sig, -32768, 32767).astype(np.int16)
    pcm[: L // 64] = 0
    pcm[-L // 64 :] = 0
    return [np.roll(pcm, 13 * i) for i in range(B)], [max(1, L // 44100)] * B


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Raises AssertionError unless each sharded result over ``n_devices``
    shards of ``device`` equals the unsharded one (see the module
    docstring)."""
    from bliss_tpu_torch.config import AnalysisConfig
    from bliss_tpu_torch.features.analyze import analyze_batch, analyze_batch_hybrid
    from bliss_tpu_torch.features.types import PCMBatch, resolve_device
    from bliss_tpu_torch.parallel import (
        analysis_mesh,
        analyze_sharded,
        analyze_sharded_async,
        sharded_distance_topk,
    )
    from bliss_tpu_torch.sim import nearest_neighbors_all

    device = resolve_device(device)
    n_seq = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_seq
    mesh = analysis_mesh(n_data, n_seq, devices=[device] * n_devices)

    # 1: the beat-exact production finish, sharded == unsharded
    cfg = AnalysisConfig(iir_block=64, tempo_finish="device_exact")
    arrays, durs = _example_arrays(max(2, n_data), 16 * 1024 * n_seq)
    batch = PCMBatch.from_arrays(arrays, durs, device=device)
    feats = analyze_sharded(batch, mesh, cfg)
    assert feats.shape == (batch.samples.shape[0], 4), feats.shape
    ref = analyze_batch(batch, cfg).cpu().numpy()
    np.testing.assert_allclose(feats, ref, atol=1e-5, rtol=0,
                               err_msg="sharded analysis != unsharded (collective corruption?)")

    # 2: the hybrid path with two bands and the extended columns
    cfg_h = AnalysisConfig(iir_block=64, nb_bands=2, tempo_finish="host")
    feats_h = analyze_sharded_async(batch, mesh, cfg_h, extended=True)()
    ref_h = analyze_batch_hybrid(batch, cfg_h, extended=True).numpy()
    np.testing.assert_allclose(feats_h[:, :4], ref_h[:, :4], atol=1e-5, rtol=0,
                               err_msg="sharded hybrid core != unsharded")
    np.testing.assert_allclose(feats_h[:, 4:], ref_h[:, 4:], atol=1e-4, rtol=1e-4,
                               err_msg="sharded extended != unsharded")

    # 3: the kernel branch, each shard >= 65536 samples
    rng = np.random.RandomState(23)
    t = np.arange(150_000)
    fused = []
    for i in range(max(2, n_data)):
        beat = 0.15 + 0.85 * ((t // 4096) % 2)
        sig = (9000 - 700 * i) * beat * np.sin(2 * np.pi * t / (50.0 + 3 * i))
        fused.append(np.clip(sig + rng.randn(t.size) * 300, -32768, 32767).astype(np.int16))
    batch_f = PCMBatch.from_arrays(fused, [7] * len(fused), pad_multiple=1024 * 160,
                                   device=device)
    assert batch_f.samples.shape[1] // n_seq >= 65536
    cfg_f = AnalysisConfig.for_gpu()
    got = analyze_sharded(batch_f, mesh, cfg_f)
    want = analyze_batch(batch_f, cfg_f).cpu().numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0],
                                  err_msg="kernel branch beats != unsharded")
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0,
                               err_msg="kernel branch != unsharded")

    # 4: the row-sharded top-k against the dense one
    d, idx = sharded_distance_topk(feats, mesh, k=1, block=1)
    d0, idx0 = nearest_neighbors_all(feats, 1, block=1, device=device)
    assert torch.equal(d, d0.cpu()) and torch.equal(idx, idx0.cpu()), "top-k != nearest_neighbors_all"
    diff = feats[:, None, :].astype(np.float64) - feats[None, :, :]
    dense = np.sqrt((diff**2).sum(-1))
    np.fill_diagonal(dense, np.inf)
    np.testing.assert_allclose(d.numpy()[:, 0], dense.min(axis=1), atol=5e-4, rtol=5e-4,
                               err_msg="sharded distance top-k != dense distances")
