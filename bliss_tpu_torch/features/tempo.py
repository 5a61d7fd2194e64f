"""Tempo + attack envelope finish (counterpart of
``bliss_tpu/features/tempo.py``).

From the per-band window energies fa [B, NB, NBF]: log-compress (mu=100),
upsample x2 with zero stuffing, 6th-order Butterworth low-pass,
half-wave-rectified differentiation, weighted envelope; attack = sum of the
envelope; two width-19 rectangular smoothings with the reference's edge
behavior, epsilon-peak count; tempo = 4*beats/duration - 30.4
(reference: src/tempo_atk_sort.c:163-284).

The reference computes this chain in C ``double`` and its eps=1e-6 peak
compare needs ~2^-27 relative precision, so it runs here in native float64
on the tensor's device: the "device_exact" finish, stage for stage as
``envelope_finish_host``. The JAX package's double-single emulation
(``tempo_exact.py``, ``dsp/ddmath.py``) exists only because the TPU lacks
float64 and has no counterpart here.
"""

from __future__ import annotations

import math

import torch

from bliss_tpu_torch import constants as C
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.dsp.boxfilter import box_sum_same
from bliss_tpu_torch.dsp.iir import lfilter_blocked


def _envelope_pipeline(fa, n, cfg: AnalysisConfig):
    """Band energies -> weighted envelope, in float64.

    Returns (wa [B, NB, 2*NBF], wa_edges, ss_src, last_excluded, j, n2)."""
    fa = fa.to(torch.float64)
    B, NB, NBF = fa.shape
    n = n.to(torch.int64)
    nbf = torch.div(n - n % C.WINDOW_SIZE, C.TEMPO_HOP, rounding_mode="floor")

    comp = torch.log(1.0 + C.MU * fa) / math.log(1.0 + C.MU)
    u = torch.stack([comp, torch.zeros_like(comp)], dim=-1).reshape(B, NB, 2 * NBF)
    tabs = device_tables(
        cfg.nb_bands, cfg.band_taps, cfg.filterbank, fa.device, cfg.iir_block
    )
    lp = lfilter_blocked(u, (tabs["iir_L"], tabs["iir_Z"], tabs["iir_M"], tabs["iir_N"]))

    diff = torch.cat(
        [lp[..., :1], torch.clamp_min(lp[..., 1:] - lp[..., :-1], 0.0)], dim=-1
    )
    wa = C.ENV_LP_WEIGHT * lp + C.ENV_DIFF_WEIGHT * diff / 10.0  # [B, NB, 2*NBF]

    n2 = 2 * nbf  # per-song envelope length
    j = torch.arange(2 * NBF, device=fa.device)[None, :]
    last_excluded = j <= (n2 - 2)[:, None]  # sum runs to 2*nb_frames - 2

    # The band-summed envelope is smoothed; the reference's pass-1 output
    # buffer is band 0's envelope, whose stale values survive at the edge
    # slots (reference: src/tempo_atk_sort.c:267-270, for any band count).
    wa_edges = wa[:, 0]
    ss_src = torch.sum(wa, dim=1)
    return wa, wa_edges, ss_src, last_excluded, j, n2


def _count_beats(ss_src, wa, last_excluded, j, n2):
    """Two rectangular filters + epsilon peak count (reference :258-280).

    ss_src: band-summed envelope; wa: the buffer whose stale values the
    reference's in-place pass 1 leaves at the edges. Returns int64 [B]."""
    width = C.RECT_FILTER_WIDTH
    n2c = n2[:, None]

    ss = ss_src * last_excluded  # the envelope with its final slot zeroed
    box1 = box_sum_same(ss, width)
    # Pass 1 writes box sums into slots half-1..n-half-1 of the envelope
    # buffer itself; slot n-half accumulates the tail sum on top of the
    # stale envelope value; the other edge slots keep stale envelope values.
    half = width // 2  # 9; the reference's half_smooth_w is 10
    edge = (j <= half - 1) | (j >= n2c - half)
    r1 = torch.where(edge, wa, torch.where(j == n2c - half - 1, wa + box1, box1))
    r1 = r1 / width

    box2 = box_sum_same(r1, width)
    # Pass 2 runs on a zeroed output buffer: only slots 9..n-10 get values.
    mid = (j >= half) & (j <= n2c - half - 1)
    r2 = torch.where(mid, box2 / width, torch.zeros_like(box2))

    d_prev = r2[:, 1:-1] - r2[:, :-2]
    d_next = r2[:, 1:-1] - r2[:, 2:]
    inrange = j[:, 1:-1] <= (n2 - 2)[:, None]
    peaks = (d_prev > C.PEAK_EPSILON) & (d_next > C.PEAK_EPSILON) & inrange
    return torch.sum(peaks, dim=1)


def envelope_finish_device(fa, n, durations, cfg: AnalysisConfig):
    """fa [B, NB, NBF] band energies, n/durations [B] -> ([B] tempo,
    [B] attack) float32, computed in float64 on fa's device."""
    if cfg.tempo_finish != "device_exact":
        raise NotImplementedError(
            f"tempo_finish={cfg.tempo_finish!r} is not ported (ROADMAP M7/M9)"
        )
    wa, wa_edges, ss_src, last_excluded, j, n2 = _envelope_pipeline(fa, n, cfg)
    atk_sum = torch.sum(wa * last_excluded[:, None, :], dim=(1, 2))
    beat = _count_beats(ss_src, wa_edges, last_excluded, j, n2)
    # duration <= 0 gives an inf/nan tempo: the reference's own behavior
    tempo = C.TEMPO_SCALE * beat.to(torch.float64) / durations.to(torch.float64) + C.TEMPO_BIAS
    attack = C.ATTACK_SCALE * atk_sum / n.to(torch.float64) + C.ATTACK_BIAS
    return tempo.to(torch.float32), attack.to(torch.float32)
