"""Precomputed operator tables derived from the analysis constants.

NumPy-only copies of the builders in ``bliss_tpu/tables.py`` that the main
analysis path reads. They are copied rather than imported because importing
anything under ``bliss_tpu`` imports JAX, which the port's machines do not
have; ``tests/test_torch_tables.py`` holds each copy equal to the original.

- ``amplitude_weight_table`` / ``amplitude_cdf_poly``: the iterated
  smoothing kernel's windowed sum as a 65 536-entry table, and a Chebyshev
  fit of its CDF, so the amplitude analyzer is one weighted sum over sample
  values.
- ``hann_window`` / ``rdft_matrices``: the frequency analyzer's windowed DFT.
- ``bandpass_filterbank`` / ``fir_warmup_correction``: the tempo analyzer's
  FIR and the per-window warm-up correction that lets window energies be
  assembled from per-block sums.
- ``iir_block_operator``: the Butterworth recurrence as block operators.

All tables are computed once in float64 NumPy and cached.
"""

from __future__ import annotations

import functools

import numpy as np

from bliss_tpu_torch import constants as C


@functools.lru_cache(maxsize=None)
def smoothing_kernel_iterated() -> np.ndarray:
    """The 7-tap binomial-like kernel composed with itself 301 times.

    Length 301*6 + 1 = 1807, centered, sums to 1 (within f64).
    """
    k = np.array([1.0])
    base = C.SMOOTH_KERNEL
    for _ in range(C.N_SMOOTH_PASSES + 1):
        k = np.convolve(k, base)
    return k


@functools.lru_cache(maxsize=None)
def amplitude_weight_table() -> np.ndarray:
    """w[j] = sum over the integral window of the iterated smoothing kernel.

    amplitude = AMPLITUDE_SCALE * (100/(end-start)) * sum_i w[s_i + 2^15]
                + AMPLITUDE_BIAS
    reproduces histogram -> 301x smoothing -> windowed integral exactly: the
    kernel's support is +-903 bins and the window sits >= 30864 bins from
    either edge, so the reference's boundary handling never reaches it.
    """
    K = smoothing_kernel_iterated()
    half = (len(K) - 1) // 2  # 903
    Sp = np.concatenate([[0.0], np.cumsum(K)])
    js = np.arange(C.HISTOGRAM_SIZE)
    lo = np.clip(C.INTEGRAL_INF - js + half, 0, len(K))
    hi = np.clip(C.INTEGRAL_SUP - js + half + 1, 0, len(K))
    return Sp[hi] - Sp[lo]


@functools.lru_cache(maxsize=None)
def amplitude_cdf_poly(degree: int = 18, halfwidth: int = 200):
    """Chebyshev fits of the smoothing kernel's CDF for gather-free
    amplitude evaluation.

    The weight w[j] = T(33767-j) - T(31766-j) where T is the iterated
    kernel's CDF; T saturates to exactly 0/1 outside +-halfwidth. Each half
    of the transition is fit with a degree-`degree` Chebyshev series (max
    error ~2.5e-7). Returns (halfwidth, coeffs_neg, coeffs_pos) with each
    coeff array indexed ascending.
    """
    from numpy.polynomial import chebyshev as Ch

    K = smoothing_kernel_iterated()
    Sp = np.concatenate([[0.0], np.cumsum(K)])
    half = (len(K) - 1) // 2  # 903

    def T(m):
        return Sp[np.clip(m + half + 1, 0, len(K))]

    A = halfwidth
    m_neg = np.arange(-A, 1)
    m_pos = np.arange(0, A + 1)
    t_neg = (2.0 * m_neg + A) / A
    t_pos = (2.0 * m_pos - A) / A
    c_neg = Ch.chebfit(t_neg, T(m_neg), degree)
    c_pos = Ch.chebfit(t_pos, T(m_pos), degree)
    return A, c_neg, c_pos


@functools.lru_cache(maxsize=None)
def hann_window() -> np.ndarray:
    """Hann window as the reference computes it
    (reference: src/frequency_sort.c:40-42), float64."""
    i = np.arange(C.WINDOW_SIZE)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * i / (C.WINDOW_SIZE - 1)))


@functools.lru_cache(maxsize=None)
def rdft_matrices(zero_nyquist: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices [WINDOW_SIZE, WINDOW_SIZE//2 + 1].

    X = x @ (re + i*im) equals numpy's unnormalized rfft.

    zero_nyquist=True zeroes the last (Nyquist) column: the reference's
    av_rdft packs the Nyquist real part into bin 0's imaginary slot and its
    accumulation loop never writes power_spectrum[256]
    (reference: src/frequency_sort.c:86-93), so the frequency analyzer's
    peak runs over bins 1..255 only.
    """
    n = C.WINDOW_SIZE
    k = np.arange(n // 2 + 1)
    t = np.arange(n)
    ang = -2.0 * np.pi * np.outer(t, k) / n
    re, im = np.cos(ang), np.sin(ang)
    if zero_nyquist:
        re = re.copy()
        im = im.copy()
        re[:, -1] = 0.0
        im[:, -1] = 0.0
    return re, im


@functools.lru_cache(maxsize=None)
def bandpass_filterbank(
    nb_bands: int = 1, taps: int = 17, kind: str = "firwin"
) -> np.ndarray:
    """[nb_bands, taps] FIR bandpass filterbank for the tempo analyzer.

    nb_bands=1, taps=17 is the reference's published single band
    (constants.FIR_BANDPASS). For nb_bands > 1, kind="firwin" designs a
    log-spaced filterbank with scipy.signal.firwin, while
    kind="reference5"/"reference36" return the reference author's own
    filterbanks (constants_filterbanks).
    """
    if kind != "firwin":
        from bliss_tpu_torch import constants_filterbanks as FB

        table = {"reference5": FB.REFERENCE5, "reference36": FB.REFERENCE36}[
            kind
        ]
        if table.shape != (nb_bands, taps):
            raise ValueError(
                f"filterbank {kind!r} is {table.shape}, not "
                f"({nb_bands}, {taps})"
            )
        return table
    if nb_bands == 1 and taps == 17:
        return C.FIR_BANDPASS[None, :]
    from scipy.signal import firwin

    nyq = C.SAMPLE_RATE / 2.0
    edges = np.geomspace(50.0, nyq * 0.92, nb_bands + 1)
    rows = [
        firwin(taps, [edges[i], edges[i + 1]], pass_zero=False, fs=C.SAMPLE_RATE)
        for i in range(nb_bands)
    ]
    return np.stack(rows)


@functools.lru_cache(maxsize=None)
def fir_warmup_correction(
    nb_bands: int = 1, taps: int = 17, kind: str = "firwin"
) -> np.ndarray:
    """[nb_bands, taps-1, taps-1] matrices M with delta = M @ history.

    The tempo analyzer resets its FIR state at every 512-sample window
    (hop 256). The per-window FIR output equals the GLOBAL causal
    convolution z everywhere except the first taps-1 warm-up positions,
    where it differs by
        delta_j = y_w[j] - z[b+j] = -sum_{k=j..K-1} c_{j+K-k} * h_k,
    (K = taps-1) with h the K samples preceding the window.
    """
    fb = bandpass_filterbank(nb_bands, taps, kind)
    K = taps - 1
    M = np.zeros((nb_bands, K, K))
    for b in range(nb_bands):
        for j in range(K):
            for k in range(j, K):
                M[b, j, k] = -fb[b, j + K - k]
    return M


@functools.lru_cache(maxsize=None)
def parseval_alt_sign() -> np.ndarray:
    """(-1)^n vector for the Nyquist-bin term of the Parseval identity."""
    s = np.ones(C.WINDOW_SIZE)
    s[1::2] = -1.0
    return s


@functools.lru_cache(maxsize=None)
def iir_block_operator(block: int = 256) -> tuple[np.ndarray, ...]:
    """Dense block operator (L, Z, M, N) for the Butterworth low-pass.

    For a block of T inputs u and incoming direct-form-II-transposed state z
    (dimension 6):   y = u @ L.T + z @ Z.T     z' = u @ M.T + z @ N.T

    L [T,T] lower-triangular Toeplitz of the impulse response; Z [T,6] the
    zero-input responses; M [6,T] state response to each in-block impulse;
    N [6,6] the state transition. Computed with scipy.signal.lfilter probes.
    """
    from scipy.signal import lfilter

    b, a = C.BUTTER_B, C.BUTTER_A
    order = len(a) - 1
    T = block

    imp = np.zeros(T)
    imp[0] = 1.0
    h = lfilter(b, a, imp)
    L = np.zeros((T, T))
    for j in range(T):
        L[j:, j] = h[: T - j]

    Z = np.zeros((T, order))
    N = np.zeros((order, order))
    for k in range(order):
        zi = np.zeros(order)
        zi[k] = 1.0
        y, zf = lfilter(b, a, np.zeros(T), zi=zi)
        Z[:, k] = y
        N[:, k] = zf

    M = np.zeros((order, T))
    for j in range(T):
        u = np.zeros(T)
        u[j] = 1.0
        _, zf = lfilter(b, a, u, zi=np.zeros(order))
        M[:, j] = zf

    return L, Z, M, N
