"""Frequency analyzer pieces around the spectrum (counterpart of
``bliss_tpu/kernels/pallas_stft.py``).

The summed power spectrum itself comes from the fused kernel
(``kernels/fused_all.py``); the stand-alone spectrum kernel (K3) that the
two-kernel configs use is not ported yet. This module holds the Hann-folded
DFT table that kernel and its plain version read, and the reference's
band-dB scoring.
"""

from __future__ import annotations

import numpy as np
import torch

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables

NBINS = C.WINDOW_SIZE // 2  # 256 computed bins (0..255; Nyquist dropped)


def hann_dft_table() -> np.ndarray:
    """[512, 512] float64: Hann-folded DFT of a 512-sample mono frame;
    columns 0..255 hold the real part of bins 0..255, columns 256..511 the
    imaginary part. The Nyquist bin is dropped: the reference never
    accumulates it (reference: src/frequency_sort.c:86-93)."""
    dre, dim = tables.rdft_matrices()
    h = tables.hann_window()[:, None]
    return np.concatenate([h * dre[:, :NBINS], h * dim[:, :NBINS]], axis=1)


def frequency_scores_from_power(power: torch.Tensor, cfg) -> torch.Tensor:
    """Reference band-dB scoring from accumulated power spectra [B, 257]
    (reference: src/frequency_sort.c:97-139). Returns [B] float32."""
    dtype = cfg.torch_dtype
    W = C.WINDOW_SIZE
    power = power.to(dtype)
    p = torch.sqrt(power[:, 1:] / float(W))
    peak = torch.amax(p, dim=1, keepdim=True)
    db = 20.0 * torch.log10(p / peak) - (-C.DB_ATTENUATION)
    lo, ls, hi, hs = (
        C.FREQ_LOW_INF, C.FREQ_LOW_SUP, C.FREQ_HIGH_INF, C.FREQ_HIGH_SUP,
    )
    b0 = (db[:, 1] + db[:, 3]) / 2.0
    b1 = (db[:, 5] + db[:, 7]) / 2.0
    b2 = torch.sum(db[:, lo - 1 : ls], dim=1) / (ls - lo)
    b3 = torch.sum(db[:, ls:hi], dim=1) / (hi - (ls + 1))
    b4 = torch.sum(db[:, hi:hs], dim=1) / (hs - (hi + 1))
    score = b4 + b3 + b2 - b0 - b1
    score = C.FREQUENCY_SCALE * score + C.FREQUENCY_BIAS
    return score.to(torch.float32)
