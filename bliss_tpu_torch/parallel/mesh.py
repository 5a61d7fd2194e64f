"""Analysis over a 2-D device mesh (counterpart of
``bliss_tpu/parallel/mesh.py``).

The batch shards over a ('data', 'seq') grid of devices:

- 'data': independent songs, pure data parallelism;
- 'seq': each song's PCM splits into sequence shards. Each shard computes
  its partial amplitude sums, spectra and window energies, and the shards
  of a song combine through the collectives of ``collectives.py``: psum
  for the sums, pmin/pmax for the global zero-trim bounds, a ring ppermute
  for the samples (or block sums) at the shard boundaries, and an
  all_gather of the window energies before the envelope finish.

As ``shard_map`` is, the mesh is single-controller: one process drives the
grid, and the per-shard stage is written once against a group of shards
(``LocalGroup``: every shard of a row in this process; ``ProcessGroup``: one
shard a ``torch.distributed`` rank, ``distributed.process_mesh``). Devices
may repeat: ``[cpu] * 8`` stands in for the 8 virtual host devices JAX's
tests get (``tests/conftest.py``), and ``[cuda:0] * 4`` lets one GPU hold a
2x2 mesh, its shards run one after another.

The stage routes as ``bliss_tpu``'s does, on the shard's length: the
kernels (``config.uses_kernels`` and a shard of at least 65536 samples)
take the prepass, K2 (``fused_stats_call`` on the shard and its right
neighbour's first hop block, with the left neighbour's last K samples as
``halo0``) and K3 (``stft_power`` with the shard's ``frame_offset``); every
other config or shorter shard takes ``bliss_tpu``'s mesh XLA branch,
whatever the config's modes say: the table amplitude weights, the DFT-matrix
spectrum and the blocked Parseval energies (``features/tempo.blocked_sums``)
with the right neighbour's first-block sums. On either branch the mean and
variance come from the prepass's exact int64 sums, psummed: the exact
integer variance of F4, where ``bliss_tpu``'s float32 mesh sums float32
squares. Extended features take each shard as a streamed row
(``features/streaming.py``): ``extended.partials`` of its payload frames
and of its mono pairs up to the first of the next shard, psummed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables
from bliss_tpu_torch.config import AnalysisConfig, check_supported, uses_kernels
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.features.amplitude import _weights, trim_bounds
from bliss_tpu_torch.features.analyze import _amplitude_score, finish_packed
from bliss_tpu_torch.features.extended import Partials, finish, partials
from bliss_tpu_torch.features.frequency import _frame_spectra
from bliss_tpu_torch.features.tempo import (
    beat_metrics,
    blocked_energies,
    blocked_sums,
    envelope_finish_device,
    normalized,
)
from bliss_tpu_torch.features.types import PCMBatch, resolve_device, row_blocks
from bliss_tpu_torch.kernels import fused_stats as fs
from bliss_tpu_torch.kernels import stft
from bliss_tpu_torch.parallel.collectives import LocalGroup, all_gather_flat

FRAME = stft.FRAME  # 1024 interleaved samples: the unit of a sequence shard
MIN_KERNEL_SHARD = 65536  # shortest shard the kernels take (bliss_tpu/parallel/mesh.py:170-173)
_NONE = 1 << 30  # first nonzero index of a shard without one


class Mesh:
    """A [n_data, n_seq] grid of torch devices with the axes ('data',
    'seq'). ``process``: for a mesh across ``torch.distributed`` ranks, the
    (data row, seq ``ProcessGroup``) of this rank (``distributed.
    process_mesh``); None when this process holds every shard."""

    axis_names = ("data", "seq")

    def __init__(self, devices, process=None):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.shape = {"data": len(self.devices), "seq": len(self.devices[0])}
        self.process = process

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["seq"]

    def rows(self):
        """(data index, seq group) of each data row this process holds."""
        if self.process is not None:
            return [self.process]
        return [(d, LocalGroup(row)) for d, row in enumerate(self.devices)]

    def cells(self):
        """(flat index d * n_seq + q, device) of each shard this process
        holds."""
        n_seq = self.shape["seq"]
        return [(d * n_seq + q, group.devices[i])
                for d, group in self.rows() for i, q in enumerate(group.ranks)]

    def gather(self, parts: dict, replicas: int = 1) -> torch.Tensor:
        """The blocks ``parts`` {index: tensor}, every block the same shape,
        concatenated along dim 0 in index order on the CPU. A mesh across
        ranks all-gathers them: each rank gives its block, and with
        ``replicas`` > 1 (the ranks of one data row hold the same block)
        the first of every ``replicas`` ranks is kept."""
        if self.process is None:
            return torch.cat([parts[i].cpu() for i in sorted(parts)])
        import torch.distributed as dist

        (block,) = parts.values()
        block = block.contiguous()
        world = dist.get_world_size()
        out = torch.empty(world * block.numel(), dtype=block.dtype, device=block.device)
        all_gather_flat(out, block.reshape(-1))
        return out.view(world, *block.shape)[::replicas].flatten(0, 1).cpu()


def analysis_mesh(n_data: int | None = None, n_seq: int = 1, devices=None) -> Mesh:
    """A ('data', 'seq') mesh of ``n_data`` x ``n_seq`` devices, row by row
    from ``devices`` (default: every visible CUDA device; RuntimeError
    without one). ``n_data`` defaults to len(devices) // n_seq. Devices may
    repeat: ``["cpu"] * 8`` is the CPU's 8-device mesh."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_seq
    if n_data < 1 or n_seq < 1 or n_data * n_seq != len(devices):
        raise ValueError(f"a {n_data}x{n_seq} mesh needs {n_data * n_seq} devices, "
                         f"got {len(devices)}")
    return Mesh([devices[d * n_seq : (d + 1) * n_seq] for d in range(n_data)])


def shard_batch(batch: PCMBatch, mesh: Mesh) -> dict:
    """Place a PCMBatch on the mesh: songs over 'data', PCM over 'seq'.
    Returns {(d, q): PCMBatch} of the shards this process holds, each
    contiguous on its device (B divisible by n_data and L by n_seq)."""
    n_data, n_seq = mesh.shape["data"], mesh.shape["seq"]
    B, L = batch.samples.shape
    if B % n_data or L % n_seq:
        raise ValueError(f"[{B}, {L}] does not divide over a {n_data}x{n_seq} mesh")
    Bl, Ls = B // n_data, L // n_seq
    out = {}
    for d, group in mesh.rows():
        rows = slice(d * Bl, (d + 1) * Bl)
        for q, dev in zip(group.ranks, group.devices):
            out[(d, q)] = PCMBatch(
                batch.samples[rows, q * Ls : (q + 1) * Ls].to(dev).contiguous(),
                batch.n_samples[rows].to(dev), batch.durations[rows].to(dev),
            )
    return out


def pad_batch(batch: PCMBatch, mesh: Mesh) -> PCMBatch:
    """Pad songs to divide 'data' and the PCM to a multiple of 1024 * n_seq.
    A pad song is silent but for a blip of 1000 at sample 100, with
    n = 2048 and a duration of 1, so that its math stays finite."""
    s, n, d = batch
    n_data, n_seq = mesh.shape["data"], mesh.shape["seq"]
    B, L = s.shape
    pad_b, pad_l = (-B) % n_data, (-L) % (FRAME * n_seq)
    if pad_l:
        s = F.pad(s, (0, pad_l))
    if pad_b:
        dummy = torch.zeros(pad_b, s.shape[1], dtype=s.dtype, device=s.device)
        dummy[:, 100] = 1000
        s = torch.cat([s, dummy])
        n = torch.cat([n, torch.full((pad_b,), 2048, dtype=n.dtype, device=n.device)])
        d = torch.cat([d, torch.ones(pad_b, dtype=d.dtype, device=d.device)])
    return PCMBatch(s, n, d)


def analyze_sharded_async(
    batch: PCMBatch, mesh: Mesh, cfg: AnalysisConfig | None = None, extended: bool = False,
):
    """Launch the sharded analysis of ``batch`` (tensors on any device; the
    shards are copied to theirs) and return a callable that blocks for the
    [B, 4] (with ``extended``, [B, 49]) float32 NumPy rows. The device work
    is queued here; the callable copies the rows back and, for a
    ``tempo_finish="host"`` config, runs the float64 envelope finish on the
    gathered energies, whose aux gives the extended bpm and beat_loudness.
    Raises ValueError for an unknown mode name."""
    cfg = cfg or AnalysisConfig()
    check_supported(cfg)
    B = batch.samples.shape[0]
    n_data, n_seq = mesh.shape["data"], mesh.shape["seq"]
    padded = pad_batch(batch, mesh)
    L = padded.samples.shape[1]
    shards = shard_batch(padded, mesh)
    host = cfg.tempo_finish == "host"
    replicas = n_seq if mesh.process is not None else 1
    outs, firsts = {}, {}
    for d, group in mesh.rows():
        parts = [shards[(d, q)] for q in group.ranks]
        outs[d], firsts[d] = _row_stage(group, parts, cfg, extended), parts[0]

    def result() -> np.ndarray:
        if not host:
            return mesh.gather(outs, replicas)[:B].numpy()
        rows = {}
        for d, packed in outs.items():
            n, dur = (t.cpu().numpy() for t in firsts[d][1:])
            rows[d] = torch.from_numpy(
                finish_packed(packed.cpu().numpy(), cfg, L, extended, n, dur)).to(packed.device)
        return mesh.gather(rows, replicas)[:B].numpy()

    return result


def analyze_sharded(batch: PCMBatch, mesh: Mesh, cfg: AnalysisConfig | None = None) -> np.ndarray:
    """[B, 4] float32 force vectors computed over the mesh. The batch is
    padded so that songs divide 'data' and the PCM divides 'seq' in
    1024-sample units; the pad rows and columns are sliced off the
    result."""
    return analyze_sharded_async(batch, mesh, cfg)()


def _nonzero_bounds(s: torch.Tensor, offset: int):
    """Global index of each row's first and last nonzero sample of the
    shard ``s`` [b, Ls] starting at ``offset`` ([b] int64 each;
    ``_NONE`` and -1 for a row without one)."""
    first, last = trim_bounds(s)
    has = (s != 0).any(dim=1)
    return (torch.where(has, first + offset, torch.full_like(first, _NONE)),
            torch.where(has, last + offset, torch.full_like(last, -1)))


def _row_stage(group, parts: list, cfg: AnalysisConfig, extended: bool) -> torch.Tensor:
    """The per-shard stage of one data row: ``parts`` the row's shards this
    process holds (PCMBatch each, on its device, in the order of
    ``group.ranks``). Returns on the first part's device the row's [Bl, 4]
    (with ``extended``, [Bl, 49]) float32 force vectors, or for a
    ``tempo_finish="host"`` config the packed float64 device stage of
    ``analyze._device_stage_packed`` ([Bl, 2 + NB * L/256 (+ 45)])."""
    n_seq, qs = group.size, group.ranks
    Bl, Ls = parts[0].samples.shape
    K = cfg.band_taps - 1
    hop, W = C.TEMPO_HOP, C.WINDOW_SIZE
    NBF_l, slots_l = Ls // hop, Ls // FRAME
    fwd = [(i, (i + 1) % n_seq) for i in range(n_seq)]
    bwd = [(i, (i - 1) % n_seq) for i in range(n_seq)]
    kernels = uses_kernels(cfg) and Ls >= MIN_KERNEL_SHARD

    # the global zero-trim bounds
    bounds = [_nonzero_bounds(p.samples, q * Ls) for q, p in zip(qs, parts)]
    start = group.pmin([b[0] for b in bounds])
    end = group.pmax([b[1] for b in bounds])

    # the moments: the prepass over each shard's valid samples (global index
    # < n), its exact int64 sums psummed
    sums = [fs.prepass_sums(p.samples, (p.n_samples.to(torch.int64) - q * Ls).clamp(0, Ls))
            for q, p in zip(qs, parts)]
    sum_s = group.psum([a for a, _ in sums])
    sum_s2 = group.psum([b for _, b in sums])

    # the right neighbour's first hop block: K2's boundary window, and the
    # extended features' first mono sample after the shard
    right = None
    if kernels or extended:
        right = group.ppermute([p.samples[:, :hop] for p in parts], bwd)

    if kernels:
        amp, powers, energies = _kernel_shards(group, parts, cfg, sum_s, sum_s2, start, end,
                                               right, fwd)
    else:
        amp, powers, energies = _xla_shards(group, parts, cfg, sum_s, sum_s2, start, end, fwd,
                                            bwd)
    amp_dot = group.psum(amp)
    power = group.psum(powers)

    # each shard's windows masked by their global index, then every shard
    # holds the row's energies [Bl, NB, L / 256]
    masked = []
    for q, p, e in zip(qs, parts, energies):
        n = p.n_samples.to(torch.int64)
        n_windows = -torch.div(-(n - n % W - W), hop, rounding_mode="floor")  # ceil
        gwin = q * NBF_l + torch.arange(NBF_l, device=e.device)
        masked.append(e * (gwin[None, :] < n_windows[:, None])[:, None, :].to(e.dtype))
    fa = group.all_gather(masked, axis=2, tiled=True)[0]

    # the row's finish, once, on the first part's device
    p0 = parts[0]
    n, dur = p0.n_samples, p0.durations
    span = end[0] - start[0]
    if kernels:
        integral = amp_dot[0] * 100.0 / span.to(torch.float64)
    else:
        span_d = span.to(cfg.torch_dtype)
        integral = amp_dot[0] * (torch.full_like(span_d, 100.0) / span_d)
    amplitude = _amplitude_score(integral)
    frequency = stft.frequency_scores_from_power(power[0], cfg)

    ext_sums = None
    if extended:
        pad = torch.zeros(Bl, FRAME - hop, dtype=torch.int16, device=p0.samples.device)
        ps = []
        for q, p, r in zip(qs, parts, right):
            # the shard as a streamed row: its payload frames, and its mono
            # pairs up to the next shard's first (the last shard's ring
            # neighbour is shard 0, but no pair reaches past the song)
            x = torch.cat([p.samples, r, pad.to(p.samples.device)], dim=1)
            n_song = p.n_samples.to(torch.int64)
            n_frames = (torch.div(n_song, FRAME, rounding_mode="floor") - q * slots_l).clamp(0, slots_l)
            n_mono = (torch.div(n_song, 2, rounding_mode="floor") - q * Ls // 2).clamp(0, Ls // 2 + 1)
            ps.append(partials(x, n_frames, n_mono, cfg.torch_dtype))
        ext_sums = Partials(*(group.psum(list(field))[0] for field in zip(*ps)))

    if cfg.tempo_finish == "host":
        cols = [amplitude[:, None], frequency[:, None], fa.reshape(Bl, -1)]
        if extended:
            zero = torch.zeros(Bl, dtype=torch.float32, device=fa.device)
            cols.append(finish(ext_sums, n, sum_s2[0], zero, zero))
        return torch.cat([c.to(torch.float64) for c in cols], dim=1)
    if not extended:
        tempo, attack = envelope_finish_device(fa, n, dur, cfg)
        return torch.stack([tempo, amplitude, frequency, attack], dim=1)
    tempo, attack, aux = envelope_finish_device(fa, n, dur, cfg, return_aux=True)
    bpm, loud = beat_metrics(fa, n, dur, cfg, aux=aux)
    core = torch.stack([tempo, amplitude, frequency, attack], dim=1)
    return torch.cat([core, finish(ext_sums, n, sum_s2[0], bpm, loud)], dim=1)


def _kernel_shards(group, parts, cfg, sum_s, sum_s2, start, end, right, fwd):
    """The kernel branch, a launch of K3 and of K2 a shard: (amplitude
    parts [Bl] float64, spectra [Bl, 257], window energies [Bl, NB,
    Ls/256] float64) of each shard."""
    Bl, Ls = parts[0].samples.shape
    K, NBF_l, slots_l = cfg.band_taps - 1, Ls // C.TEMPO_HOP, Ls // FRAME
    left = group.ppermute([p.samples[:, -K:] for p in parts], fwd)
    amp, powers, energies = [], [], []
    for i, (q, p) in enumerate(zip(group.ranks, parts)):
        s, n = p.samples, p.n_samples
        alpha, beta, mean = fs.normalization_from_sums(sum_s[i], sum_s2[i], n)
        if q == 0:
            # the history before the song must be zero after normalization:
            # the raw value that normalizes to zero is the integer mean (the
            # ring would hand shard 0 the last shard's tail)
            halo0 = mean.clamp(-32768, 32767).to(torch.int16)[:, None].expand(Bl, K).contiguous()
        else:
            halo0 = left[i].contiguous()
        x_ext = torch.cat([s, right[i]], dim=1)
        wsum, _, e = fs.fused_stats_call(
            x_ext, alpha, beta, halo0, nb_bands=cfg.nb_bands, band_taps=cfg.band_taps,
            filterbank=cfg.filterbank, conv_mode=cfg.fused_conv,
        )
        del x_ext
        # this shard's own blocks' weight sums (not the ring block's),
        # less w(0) = 1 for each of its samples outside the global trim
        offset = q * Ls
        lo_in = (start[i] - offset).clamp(0, Ls)
        hi_in = (end[i] + 1 - offset).clamp(0, Ls)
        inside = (hi_in - lo_in).clamp(min=0)
        amp.append(wsum[:, :NBF_l].sum(dim=1, dtype=torch.float64) - (Ls - inside))
        energies.append(e[:, :, :NBF_l])
        powers.append(stft.stft_power(s, n, frame_offset=q * slots_l,
                                      precise=cfg.stft_conv == "precise"))
    return amp, powers, energies


def _xla_shards(group, parts, cfg, sum_s, sum_s2, start, end, fwd, bwd):
    """``bliss_tpu``'s mesh XLA branch (``bliss_tpu/parallel/mesh.py:188-
    224, 314-365``) in the config's dtype: (amplitude parts [Bl], spectra
    [Bl, 257], window energies [Bl, NB, Ls/256]) of each shard, from the
    table amplitude weights over the global trim, the DFT-matrix spectra of
    the frames counted by their global index, and the blocked Parseval
    energies with the left neighbour's last K normalized samples as the
    FIR's history and the right neighbour's first-block sums."""
    dtype = cfg.torch_dtype
    Bl, Ls = parts[0].samples.shape
    K, slots_l = cfg.band_taps - 1, Ls // FRAME
    table_cfg = dataclasses.replace(cfg, amplitude_mode="table", spectrum_mode="matmul")
    fb = tables.bandpass_filterbank(cfg.nb_bands, cfg.band_taps, cfg.filterbank)
    moments = [fs.moments(a, b, p.n_samples) for a, b, p in zip(sum_s, sum_s2, parts)]

    def norm(s, i, rows, g0):
        """The normalized samples of ``s``, rows ``rows`` of shard i, whose
        first column has the global index ``g0``; zero past the song."""
        n = parts[i].n_samples[rows].to(torch.int64)
        mean, var = (m[rows] for m in moments[i])
        g = g0 + torch.arange(s.shape[1], device=s.device)
        x = normalized(s, mean, var, dtype)
        return torch.where(g[None, :] < n[:, None], x, torch.zeros_like(x))

    everything = slice(None)
    tails = [norm(p.samples[:, Ls - K :], i, everything, q * Ls + Ls - K)
             for i, (q, p) in enumerate(zip(group.ranks, parts))]
    halo = group.ppermute(tails, fwd)

    amp, powers, S_all, D_all = [], [], [], []
    for i, (q, p) in enumerate(zip(group.ranks, parts)):
        s, dev = p.samples, p.samples.device
        tabs = device_tables(cfg.nb_bands, cfg.band_taps, cfg.filterbank, dev, cfg.iir_block,
                             dtype=dtype)
        # shard 0's history is the zeros before the song
        hist = torch.zeros_like(halo[i]) if q == 0 else halo[i]
        n_frames = (stft.frame_counts(p.n_samples) - q * slots_l).clamp(0, slots_l)
        g = q * Ls + torch.arange(Ls, device=dev)
        pieces = []
        for b0, b1 in row_blocks(Bl, Ls * fb.shape[0]):
            rows = slice(b0, b1)
            x = s[rows]
            seg = (g[None, :] >= start[i][rows, None]) & (g[None, :] <= end[i][rows, None])
            a = torch.sum(_weights(x, table_cfg, tabs) * seg.to(dtype), dim=1)
            del seg
            re, im = _frame_spectra(x, n_frames[rows], table_cfg, tabs)
            pw = torch.sum((re * re + im * im).to(dtype), dim=1)
            del re, im
            S, D = blocked_sums(torch.cat([hist[rows], norm(x, i, rows, q * Ls)], dim=1), fb, tabs)
            pieces.append((a, pw, S, D))
        a, pw, S, D = (torch.cat(t) for t in zip(*pieces))
        amp.append(a)
        powers.append(pw)
        S_all.append(S)
        D_all.append(D)
    # this shard's last window ends in the right neighbour's first block
    S_next = group.ppermute([S[:, :, 0] for S in S_all], bwd)
    energies = [blocked_energies(S, D, Sn) for S, D, Sn in zip(S_all, D_all, S_next)]
    return amp, powers, energies


def sharded_distance_topk(features, mesh: Mesh, k: int, block: int = 4096):
    """Every song's k nearest others, the rows of its [N, D] force vectors
    split over the mesh's devices (flattened) in whole query blocks of
    ``block`` rows: each device takes its blocks through
    ``sim/distance._block_topk`` (the float64 Gram matrix, equal distances
    in index order, as ``jax.lax.top_k``), so that no device holds more
    than a [block, N] piece of the distance matrix and every block is the
    one ``nearest_neighbors_all(..., block=block)`` computes. Returns ([N,
    k] distances float32, [N, k] indices int32) on the CPU, equal to
    ``nearest_neighbors_all``'s; ``k`` is clamped to N - 1."""
    from bliss_tpu_torch.sim.distance import _block_topk

    if not isinstance(features, torch.Tensor):
        features = torch.from_numpy(np.asarray(features))
    feats = features.to(torch.float32).cpu().to(torch.float64)
    n = feats.shape[0]
    k = min(k, max(n - 1, 0))
    rows = -(-n // mesh.size)
    rows = -(-rows // block) * block  # whole blocks a device
    dists, idxs = {}, {}
    for i, dev in mesh.cells():
        f = feats.to(dev)
        r0, r1 = min(i * rows, n), min((i + 1) * rows, n)
        parts = [_block_topk(f[b0 : min(b0 + block, r1)], f, b0, k) for b0 in range(r0, r1, block)]
        d = torch.cat([p[0] for p in parts]) if parts else torch.zeros(0, k, device=dev)
        idx = (torch.cat([p[1] for p in parts]) if parts
               else torch.zeros(0, k, dtype=torch.int32, device=dev))
        # equal blocks for the gather: a short device's block is padded
        dists[i] = F.pad(d, (0, 0, 0, rows - (r1 - r0)))
        idxs[i] = F.pad(idx, (0, 0, 0, rows - (r1 - r0)))
    return mesh.gather(dists)[:n], mesh.gather(idxs)[:n]
