"""Every tunable constant of the analysis pipeline, in one place.

The reference hard-codes these across five C files; this module is the
exhaustive list (see SURVEY.md §5 "Config / flag system") with citations.
Defaults reproduce the reference numerically.
"""

from __future__ import annotations

import numpy as np

# --- Canonical PCM contract (reference: src/decode.c:7-9) -------------------
SAMPLE_RATE = 22050
CHANNELS = 2
NB_BYTES_PER_SAMPLE = 2

# --- Status codes (reference: include/bliss.h:20-24) ------------------------
BL_LOUD = 0
BL_CALM = 1
BL_UNKNOWN = 2
BL_UNEXPECTED = -2
BL_OK = 0

VERSION = "0.1.0"
COMPAT_REFERENCE_VERSION = 1.2  # reference: include/bliss.h:12

# --- Amplitude analyzer (reference: src/amplitude_sort.c:5-10,79) -----------
HISTOGRAM_SIZE = 1 << 16
N_SMOOTH_PASSES = 300  # applied N+1 times (loop is `g <= N_PASSES`)
INTEGRAL_INF = (1 << 15) - 1 - 1000  # 31767
INTEGRAL_SUP = (1 << 15) - 1 + 1000  # 33767
SMOOTH_KERNEL = np.array([1.0, 3.0, 6.0, 7.0, 6.0, 3.0, 1.0]) / 27.0
AMPLITUDE_SCALE = -0.2
AMPLITUDE_BIAS = 6.0

# --- Frequency analyzer (reference: src/frequency_sort.c:5-18,110-139) ------
WINDOW_SIZE = 512  # also tempo fft_winsize (src/tempo_atk_sort.c:50)
FREQ_LOW_INF = 10   # * 43 Hz ~ 430 Hz
FREQ_LOW_SUP = 60   # ~2.0 kHz
FREQ_HIGH_INF = 118  # ~5.1 kHz
FREQ_HIGH_SUP = 234  # ~10.1 kHz
FREQUENCY_SCALE = 1.0 / 3.0
FREQUENCY_BIAS = 68.0 / 3.0
DB_ATTENUATION = -3.0

# --- Tempo / attack analyzer (reference: src/tempo_atk_sort.c) --------------
TEMPO_HOP = 256  # half_fft_winsize
NB_FIR_COEFFS = 17
MU = 100.0          # log-compression constant (:170)
LAMBDA = 0.8        # envelope weighting (:171)
# C computes `1 - lambda` and `lambda * 172` in float32; the rounded values
# are observable in the golden attack scores, so carry them exactly.
ENV_LP_WEIGHT = float(np.float32(1.0) - np.float32(LAMBDA))
ENV_DIFF_WEIGHT = float(np.float32(np.float32(LAMBDA) * np.float32(172.0)))
RECT_FILTER_WIDTH = 19  # (:267-270)
PEAK_EPSILON = float(np.float32(1e-6))  # (:275)
TEMPO_SCALE = 4.0
TEMPO_BIAS = -30.4
ATTACK_SCALE = -1.74e4  # -1.74 * 10000
ATTACK_BIAS = 58.3

# 17-tap symmetric FIR bandpass, band 0 of the (mostly commented-out)
# filterbank (reference: include/bandpass_coeffs.h:1-7). NB_BANDS=1 in the
# reference "for CPU-consumption reasons" (src/tempo_atk_sort.c:13-14).
FIR_BANDPASS = np.array(
    [
        -0.0023470, 0.0044613, -0.0114627, 0.0226382,
        -0.0405147, 0.0580037, -0.0779167, 0.0882711,
        0.9065095, 0.0882711, -0.0779167, 0.0580037,
        -0.0405147, 0.0226382, -0.0114627, 0.0044613,
        -0.0023470,
    ]
)

# 6th-order Butterworth low-pass (reference: include/bandpass_coeffs.h:484-492)
BUTTER_B = np.array(
    [1.9510e-05, 1.1706e-04, 2.9266e-04, 3.9021e-04, 2.9266e-04, 1.1706e-04,
     1.9510e-05]
)
BUTTER_A = np.array(
    [1.00000, -4.59007, 8.91034, -9.34191, 5.56998, -1.78845, 0.24136]
)

FORCE_VECTOR_FIELDS = ("tempo", "amplitude", "frequency", "attack")
