"""The benchmark's inputs, made on the device from ``--seed`` with a
``torch.Generator`` of the device in a few large calls: the same seed on
the same kind of device gives the same inputs.

``songs`` rewrites ``chip_smoke.py::synth_song`` (commit 18c3400) in torch:
two tones, noise and a periodic decaying click (a beat), with silent
lead-in and tail. ``library_rows`` follows ``chip_smoke.py::sim_library``:
rows about a set of centres with Gaussian noise, and planted exact copies.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CLICK = 3000  # samples of a click's decay


def song_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` even interleaved-stereo lengths spread evenly over [lo, hi]:
    every seed gets this same set, in its own order."""
    return (np.linspace(lo, hi, n) // 2 * 2).astype(np.int64)


def songs(lengths, seed: int, device, *, sample_rate: int = 22050, chunk: int = 16) -> np.ndarray:
    """[len(lengths), max(lengths)] int16 host array: row i holds a song of
    ``lengths[i]`` interleaved stereo samples, zero past its end. Made
    ``chunk`` songs at a time on ``device``."""
    lengths = np.asarray(lengths, np.int64)
    n, width = len(lengths), int(lengths.max())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out = torch.empty((n, width), dtype=torch.int16)
    t = torch.arange(width, device=device, dtype=torch.int64)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand((m, 1), generator=g, device=device, dtype=torch.float64)

        amp = uniform(4000.0, 14000.0).float()
        p1 = torch.randint(30, 90, (m, 1), generator=g, device=device)
        p2 = torch.randint(5, 12, (m, 1), generator=g, device=device)
        beat = 2 * (sample_rate * 60.0 / uniform(70.0, 170.0)).long()
        click = torch.randn((m, CLICK), generator=g, device=device)
        noise = torch.randn((m, width), generator=g, device=device)
        two_pi = 2 * math.pi
        sig = amp * torch.sin(two_pi * (t % p1).float() / p1.float())
        sig += 0.3 * amp * torch.sin(two_pi * (t % p2).float() / p2.float())
        sig += noise.mul_(0.05 * amp)
        del noise
        phase = t % beat
        decay = torch.exp(-phase.clamp(max=CLICK - 1).float() / 400.0)
        shape = torch.gather(click, 1, phase.clamp(max=CLICK - 1))
        sig += torch.where(phase < CLICK, 1.5 * amp * decay * shape, 0.0)
        del phase, decay, shape
        ln = torch.as_tensor(lengths[s : s + m], device=device)[:, None]
        lead = ln // 50
        sig.masked_fill_((t < lead) | (t >= ln - lead), 0.0)
        out[s : s + m].copy_(sig.clamp_(-32768, 32767).to(torch.int16))
        del sig
    return out.numpy()


def library_rows(n: int, dim: int, seed: int, device, *, centres: int, centre_mean: float,
                 centre_sd: float, noise_sd: float, dupes: int):
    """(rows [n, dim] float32 on ``device``, pairs [dupes, 2] int64 numpy of
    (source, copy) rows). Each row is one of ``centres`` centres (each
    column normal, ``centre_mean``, ``centre_sd``) plus normal noise of
    ``noise_sd`` in every column, computed in float64; then ``dupes`` rows
    are overwritten as exact copies of as many others, no row in two
    pairs."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    c = centre_mean + centre_sd * torch.randn((centres, dim), generator=g, device=device, dtype=torch.float64)
    pick = torch.randint(centres, (n,), generator=g, device=device)
    rows = c[pick] + noise_sd * torch.randn((n, dim), generator=g, device=device, dtype=torch.float64)
    perm = torch.randperm(n, generator=g, device=device)[: 2 * dupes]
    src, dst = perm[:dupes], perm[dupes:]
    rows = rows.to(torch.float32)
    rows[dst] = rows[src]
    return rows, torch.stack([src, dst], 1).cpu().numpy()
