"""Scalar NumPy/SciPy oracle of the reference analyzers: a copy of the
repository's ``tests/oracle.py`` that the port carries, since the port
imports nothing outside its own package.

A direct, readable re-derivation of the reference's DSP in NumPy, replicating
its arithmetic (including float32 stores and accumulation order where they
are observable in the golden values). The reference binary that
``scripts/fuzz_differential.py`` compares ``bliss_tpu`` with is built from a
checkout of the reference C library, which this repository does not carry;
``bliss_tpu_torch/fuzz.py`` compares the port with this oracle in its place.
``tests/test_torch_fuzz.py`` holds the copy equal to the original, bit for bit.

Behavioral citations (file:line into the reference checkout):
- amplitude: src/amplitude_sort.c:12-80
- frequency: src/frequency_sort.c:20-140
- tempo/attack: src/tempo_atk_sort.c:42-296, src/helpers.c:30-49
- aggregation: src/analyze.c:67-80
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

HISTOGRAM_SIZE = 1 << 16
N_PASSES = 300
INTEGRAL_INF = (1 << 15) - 1 - 1000  # 31767
INTEGRAL_SUP = (1 << 15) - 1 + 1000  # 33767

WINDOW_SIZE = 512
LOW_INF, LOW_SUP, HIGH_INF, HIGH_SUP = 10, 60, 118, 234

# 17-tap symmetric FIR bandpass (reference: include/bandpass_coeffs.h:1-7).
FIR_COEFFS = np.array(
    [
        -0.0023470, 0.0044613, -0.0114627, 0.0226382,
        -0.0405147, 0.0580037, -0.0779167, 0.0882711,
        0.9065095, 0.0882711, -0.0779167, 0.0580037,
        -0.0405147, 0.0226382, -0.0114627, 0.0044613,
        -0.0023470,
    ]
)

# 6th-order Butterworth low-pass (reference: include/bandpass_coeffs.h:484-492).
BUTTER_B = np.array(
    [1.9510e-05, 1.1706e-04, 2.9266e-04, 3.9021e-04, 2.9266e-04, 1.1706e-04,
     1.9510e-05]
)
BUTTER_A = np.array(
    [1.00000, -4.59007, 8.91034, -9.34191, 5.56998, -1.78845, 0.24136]
)


def c_trunc_div(a: int, b: int) -> int:
    """C integer division: truncation toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def amplitude_oracle(samples: np.ndarray) -> float:
    """Loudness via smoothed sample-value histogram (amplitude_sort.c)."""
    s = samples.astype(np.int32)
    nz = np.nonzero(s)[0]
    start, end = int(nz[0]), int(nz[-1])
    hist = np.bincount(
        s[start : end + 1] + 32768, minlength=HISTOGRAM_SIZE
    ).astype(np.float32)

    smooth = np.zeros(HISTOGRAM_SIZE, np.float32)
    inv27 = np.float64(1.0) / np.float64(27.0)
    for _ in range(N_PASSES + 1):  # loop bound is `g <= N_PASSES`
        smooth[0] = hist[0]
        smooth[1] = np.float32(0.25 * (np.float64(hist[0]) + 2.0 * hist[1] + hist[2]))
        smooth[2] = np.float32(
            (np.float64(hist[0]) + 2.0 * hist[1] + 3.0 * hist[2] + 2.0 * hist[3] + hist[4]) / 9.0
        )
        # Interior bins 3 .. HISTOGRAM_SIZE-6; C sums in float32 left-to-right,
        # multiplies by double 1/27, stores float32.
        acc = hist[0:-8] + np.float32(3) * hist[1:-7]
        acc = acc + np.float32(6) * hist[2:-6]
        acc = acc + np.float32(7) * hist[3:-5]
        acc = acc + np.float32(6) * hist[4:-4]
        acc = acc + np.float32(3) * hist[5:-3]
        acc = acc + hist[6:-2]
        smooth[3 : HISTOGRAM_SIZE - 5] = (acc.astype(np.float64) * inv27).astype(
            np.float32
        )
        hist[3 : HISTOGRAM_SIZE - 5] = smooth[3 : HISTOGRAM_SIZE - 5]

    smooth = smooth / np.float32(start - end)
    smooth = (smooth.astype(np.float64) * 100.0).astype(np.float32)
    smooth = np.abs(smooth)

    integral = np.float32(0.0)
    for v in smooth[INTEGRAL_INF : INTEGRAL_SUP + 1]:
        integral = np.float32(integral + v)
    return float(np.float32(np.float32(-0.2) * integral) + np.float32(6.0))


def frequency_oracle(samples: np.ndarray, channels: int = 2) -> float:
    """Spectral balance score over 5 bands (frequency_sort.c)."""
    n_samples = samples.shape[0]
    n_frames = (n_samples // channels) // WINDOW_SIZE

    i = np.arange(WINDOW_SIZE)
    hann = (0.5 * (1.0 - np.cos(2.0 * np.pi * i / (WINDOW_SIZE - 1)))).astype(
        np.float32
    )

    frames = samples[: n_frames * WINDOW_SIZE * channels].astype(np.int32)
    frames = frames.reshape(n_frames, WINDOW_SIZE, channels)
    if channels == 2:
        t = frames[:, :, 0] + frames[:, :, 1]
        # C `(l + r) / 2` truncates toward zero.
        mono = np.where((t < 0) & (t % 2 != 0), t // 2 + 1, t // 2)
    else:
        mono = frames[:, :, 0]
    x = mono.astype(np.float32) * hann  # [n_frames, 512] float32

    X = np.fft.rfft(x.astype(np.float64), axis=-1)
    re = X.real.astype(np.float32)
    im = X.imag.astype(np.float32)
    raw = re * re + im * im  # float32, as in C

    # Sequential float32 accumulation over frames (C += per frame).
    ps = np.zeros(WINDOW_SIZE // 2 + 1, np.float32)
    for f in range(n_frames):
        ps[1 : WINDOW_SIZE // 2] += raw[f, 1 : WINDOW_SIZE // 2]

    ps = ps.astype(np.float64)
    p = np.zeros_like(ps)
    p[1:] = np.sqrt(ps[1:] / WINDOW_SIZE)
    p = p.astype(np.float32)
    peak = np.float32(np.max(p[1:]))
    with np.errstate(divide="ignore"):
        # zero bins legitimately give -inf dB (the C code hits the same
        # log10(0) and relies on IEEE semantics downstream)
        db = (
            20.0 * np.log10(p.astype(np.float64) / peak) - 3.0
        ).astype(np.float32)

    b0 = np.float32((db[2] + db[4]) / 2.0)
    b1 = np.float32((db[6] + db[8]) / 2.0)
    b2 = np.float32(0.0)
    for d in range(LOW_INF, LOW_SUP + 1):
        b2 = np.float32(b2 + db[d])
    b2 = np.float32(b2 / np.float32(LOW_SUP - LOW_INF))
    b3 = np.float32(0.0)
    for d in range(LOW_SUP + 1, HIGH_INF + 1):
        b3 = np.float32(b3 + db[d])
    b3 = np.float32(b3 / np.float32(HIGH_INF - (LOW_SUP + 1)))
    b4 = np.float32(0.0)
    for d in range(HIGH_INF + 1, HIGH_SUP + 1):
        b4 = np.float32(b4 + db[d])
    b4 = np.float32(b4 / np.float32(HIGH_SUP - (HIGH_INF + 1)))

    bands_sum = np.float32(np.float32(np.float32(np.float32(b4 + b3) + b2) - b0) - b1)
    return float(np.float32((1.0 / 3.0) * np.float64(bands_sum) + 68.0 / 3.0))


def envelope_oracle(
    samples: np.ndarray, duration: int
) -> tuple[float, float]:
    """Klapuri-style tempo + attack scores (tempo_atk_sort.c). Returns
    (tempo, attack)."""
    n_samples = samples.shape[0]
    s = samples.astype(np.int64)

    # Integer mean/variance (helpers.c:30-49); C int accumulation would wrap,
    # real audio never gets near the limit.
    mean = c_trunc_div(int(s.sum()), n_samples)
    var = c_trunc_div(int(((s - mean) ** 2).sum()), n_samples)
    mean_d = mean / 32768.0
    var_d = var / 32768.0 / 32768.0
    normalized = (s / 32768.0 - mean_d) / var_d

    fft_winsize = 512
    half = fft_winsize // 2
    trunc_n = n_samples - (n_samples % fft_winsize)
    nb_frames = trunc_n * 2 // fft_winsize
    iteration_number = trunc_n - fft_winsize
    n_windows = -(-iteration_number // half)  # ceil

    filtered_array = np.zeros(nb_frames, np.float64)
    for w in range(n_windows):
        b = w * half
        win = normalized[b : b + fft_winsize]
        # 17-tap symmetric FIR with zero state at each window start
        # (the registry code at tempo_atk_sort.c:121-138 is an explicitly
        # symmetric form of this causal FIR).
        y = lfilter(FIR_COEFFS, [1.0], win)
        X = np.fft.rfft(y)
        abs2 = (X.real * X.real + X.imag * X.imag)
        # C accumulates into a float32 with per-step double->float rounding.
        sf = np.float32(0.0)
        for v in abs2:
            sf = np.float32(np.float64(sf) + v)
        filtered_array[w] = np.float64(sf)

    mu = np.float32(100.0)
    lam = np.float32(0.8)
    n2 = 2 * nb_frames
    u = np.zeros(n2, np.float64)
    u[0::2] = np.log(1.0 + np.float64(mu) * filtered_array) / np.log(
        np.float64(np.float32(1.0 + mu))
    )

    lp = lfilter(BUTTER_B, BUTTER_A, u)

    v = np.empty_like(lp)
    v[0] = lp[0]
    v[1:] = np.maximum(lp[1:] - lp[:-1], 0.0)

    c1 = np.float64(np.float32(1.0) - lam)          # 1 - 0.8f, float32-rounded
    c2 = np.float64(np.float32(lam * np.float32(172.0)))  # 0.8f * 172
    wa = c1 * lp + c2 * v / 10.0

    atk_sum = float(np.sum(wa[: n2 - 1]))

    ss = np.zeros(n2, np.float64)
    ss[: n2 - 1] = wa[: n2 - 1]

    wa1 = rectangular_filter_oracle(wa.copy(), ss, n2, 19)
    ss2 = rectangular_filter_oracle(np.zeros(n2, np.float64), wa1, n2, 19)

    eps = np.float64(np.float32(0.000001))
    d_prev = ss2[1:-1] - ss2[:-2]
    d_next = ss2[1:-1] - ss2[2:]
    beat = int(np.sum((d_prev > eps) & (d_next > eps)))

    tempo = float(
        np.float32(
            np.float64(np.float32(np.float32(4 * np.float32(beat)) / np.float32(duration)))
            - 30.4
        )
    )
    attack = float(np.float32(-1.74 * atk_sum * 10000.0 / n_samples + 58.3))
    return tempo, attack


def rectangular_filter_oracle(
    out: np.ndarray, inp: np.ndarray, n: int, width: int = 19
) -> np.ndarray:
    """Replicates bl_rectangular_filter (tempo_atk_sort.c:19-40) including its
    edge behavior: out[half-1 .. n-half-1] get true box sums, out[n-half] is
    *accumulated* into (not overwritten), and the first/last few slots keep
    whatever was in `out` — all then divided by `width`."""
    half = int(round(width / 2.0))  # 10 for width 19
    sums = np.convolve(inp, np.ones(width), mode="valid")  # [n - width + 1]
    # Main loop writes out[k + half - 1] = sum(inp[k:k+width]) for k < n-width.
    out[half - 1 : n - width + half - 1] = sums[: n - width]
    out[n - half] += inp[n - width :].sum()
    out /= width
    return out


def analyze_oracle(samples: np.ndarray, duration: int, channels: int = 2):
    """Full force-vector + aggregation (analyze.c:33-80)."""
    amplitude = amplitude_oracle(samples)
    frequency = frequency_oracle(samples, channels)
    tempo, attack = envelope_oracle(samples, duration)
    force = float(
        np.float32(max(tempo, 0.0))
        + np.float32(amplitude)
        + np.float32(frequency)
        + np.float32(max(attack, 0.0))
    )
    return {
        "tempo": tempo,
        "amplitude": amplitude,
        "frequency": frequency,
        "attack": attack,
        "force": force,
    }


def multiband_envelope_oracle(samples, duration, fb):
    """Literal NumPy transcription of the reference's envelope stage for an
    arbitrary filterbank (the NB_BANDS loops of tempo_atk_sort.c:155-296):
    per-band zero-state window FIR + FFT energies, per-band log-compress /
    upsample / Butterworth / rectified diff / weighted average, attack =
    sum over bands, band-summed envelope smoothed twice with the pass-1
    output buffer aliasing BAND 0's envelope (weighted_average[0], whose
    stale values survive at the edges), epsilon peak count. Clean float64
    accumulation (the float32-replay quirks live in the 1-band
    envelope_oracle). Returns (tempo, attack)."""
    from bliss_tpu_torch import constants as C

    n_samples = samples.shape[0]
    s = samples.astype(np.int64)
    mean = c_trunc_div(int(s.sum()), n_samples)
    var = c_trunc_div(int(((s - mean) ** 2).sum()), n_samples)
    normalized = (s / 32768.0 - mean / 32768.0) / (var / 32768.0 / 32768.0)

    W, half = 512, 256
    trunc_n = n_samples - n_samples % W
    nb_frames = trunc_n * 2 // W
    n_windows = -(-(trunc_n - W) // half)
    NB = fb.shape[0]
    filtered = np.zeros((NB, nb_frames))
    for w in range(n_windows):
        win = normalized[w * half : w * half + W]
        for b in range(NB):
            X = np.fft.rfft(lfilter(fb[b], [1.0], win))
            filtered[b, w] = np.sum(X.real**2 + X.imag**2)

    n2 = 2 * nb_frames
    lp = np.zeros((NB, n2))
    wa = np.zeros((NB, n2))
    for b in range(NB):
        u = np.zeros(n2)
        u[0::2] = np.log(1.0 + C.MU * filtered[b]) / np.log(1.0 + C.MU)
        lp[b] = lfilter(BUTTER_B, BUTTER_A, u)
        v = np.empty(n2)
        v[0] = lp[b][0]
        v[1:] = np.maximum(np.diff(lp[b]), 0.0)
        wa[b] = C.ENV_LP_WEIGHT * lp[b] + C.ENV_DIFF_WEIGHT * v / 10.0

    atk_sum = float(wa[:, : n2 - 1].sum())

    ss = np.zeros(n2)
    ss[: n2 - 1] = wa[:, : n2 - 1].sum(axis=0)
    wa0 = rectangular_filter_oracle(wa[0].copy(), ss, n2, 19)
    ss2 = rectangular_filter_oracle(np.zeros(n2), wa0, n2, 19)

    d_prev = ss2[1:-1] - ss2[:-2]
    d_next = ss2[1:-1] - ss2[2:]
    beat = int(np.sum((d_prev > C.PEAK_EPSILON) & (d_next > C.PEAK_EPSILON)))

    tempo = float(
        np.float32(
            np.float64(np.float32(np.float32(4 * np.float32(beat)) / np.float32(duration)))
            - 30.4
        )
    )
    attack = float(np.float32(-1.74 * atk_sum * 10000.0 / n_samples + 58.3))
    return tempo, attack
