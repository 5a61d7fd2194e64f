"""The least time an NVIDIA H100 SXM could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the operations its function needs on these inputs over the peak rate
of the pipe that does them (the larger of the per-pipe times, since the
pipes run side by side). Peaks are NVIDIA's data-sheet figures for the SXM
part at its 700 W limit, dense: 3.35 TB/s of HBM3, 67 TFLOP/s float32 and
34 TFLOP/s float64 on the CUDA cores, 67 TFLOP/s float64 on the tensor
cores ("fp64_tc").

Each ``*_work`` function counts, from its call's shapes (and, where the
work depends on the data, from the data's own frame counts), the bytes and
the least floating-point operations by pipe of the function that the
port's kernel of that name computes, whatever algorithm the kernel uses;
``bound_ms`` turns a count into (milliseconds, "bytes" or "operations").
"""

from __future__ import annotations

import math

PEAK = {
    "bytes": 3.35e12,
    "fp32": 67e12,
    "fp64": 34e12,
    "fp64_tc": 67e12,
}
BLK = 256  # hop block: the stats kernel's row
CHEB_COEFFS = 19  # the shipped amplitude fit: degree 18
CHEB_HALFWIDTH = 200  # over +-200
FRAME = 512  # STFT window, mono samples


def bound_ms(work: dict) -> tuple[float, str]:
    """(ms, "bytes" or "operations") for ``work`` = {"bytes": n, pipe:
    operations, ...} with pipes named as in ``PEAK``."""
    t_bytes = work.get("bytes", 0) / PEAK["bytes"]
    t_ops = max((n / PEAK[k] for k, n in work.items() if k != "bytes"), default=0.0)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def add(*works: dict) -> dict:
    """The work of several kernels launched in turn."""
    out: dict = {}
    for w in works:
        for k, n in w.items():
            out[k] = out.get(k, 0) + n
    return out


def _cheb_flops(ncheb: int) -> int:
    # one value of the weight: 1000 - |s + 1|, the fold and clamp, then
    # Clenshaw: an FMA and a subtract a coefficient
    return 12 + 3 * (ncheb - 1)


def weight_table_flops(ncheb: int, halfwidth: float) -> int:
    """The amplitude weight T(1000 - |s + 1|) of an int16 sample is 1 or 0
    but for the 2 ceil(halfwidth) values of |s + 1| around 1000, which
    depend on the fit alone: the function needs its series once for each,
    once a call; a sample then needs a lookup (integer work) and an add."""
    return 2 * math.ceil(halfwidth) * _cheb_flops(ncheb)


def stats_work(
    B: int, L: int, *, nb: int = 1, taps: int = 17, cheb: bool = True,
    conv: bool = True, warm: bool = True, fir_bytes: int = 8,
    ncheb: int = CHEB_COEFFS, halfwidth: float = CHEB_HALFWIDTH,
    fir_pipe: str = "fp64",
) -> dict:
    """``stats_kernel`` (K2, K1's first launch, the ablation A1): per sample
    the normalization (an FMA); per band the FIR (``taps`` FMAs), z^2 and
    the sums of z, z^2 and (-1)^t z (an add or a subtract each; a sample
    goes to its block's tail or head pieces, never both); per block head
    sample the correction (K FMAs), y = z + delta and y's own square and
    three sums; all in the FIR's type. The amplitude weights' table
    (``weight_table_flops``) and their sum, an add a sample, in float32.
    Reads int16 [B, L]; writes wsum and rownz (float32) and
    [B, nb, 9, L/256] sums. ``fir_pipe="fp64_tc"`` counts the float64 FIR's
    FMAs on the fp64 tensor cores, the rest on the CUDA cores: the least
    time of the same function where the FIR runs as matrix products."""
    n, nbf, K = B * L, B * (L // BLK), taps - 1
    fir = 2 * taps if conv else 0
    per_band = 4 + fir + (K * (2 * K + 5) / BLK if warm else 0)
    work = {
        "bytes": 2 * n + 8 * nbf + fir_bytes * 9 * nb * nbf,
        "fp32": n + (weight_table_flops(ncheb, halfwidth) if cheb else 0),
    }
    pipe = "fp64" if fir_bytes == 8 else "fp32"
    if fir_pipe != "fp64" and (fir_pipe not in PEAK or fir_bytes != 8):
        raise ValueError(f"fir_pipe must be 'fp64' or, for a float64 FIR, 'fp64_tc'; got {fir_pipe!r}")
    if fir_pipe != "fp64" and fir:
        work[fir_pipe] = n * nb * fir
        per_band -= fir
    work[pipe] = work.get(pipe, 0) + n * (2 + nb * per_band)
    return work


def prepass_work(valid: int, B: int) -> dict:
    """``prepass_kernel`` over ``valid`` = sum_b min(n_b, L) samples that
    count: reads each once (2 bytes) and the [B] int32 counts, and writes
    two int64 sums a song; the padding past n_b is no part of its function.
    Its integer adds and products are not on the floating-point pipes, so
    the bytes bound it."""
    return {"bytes": 2 * valid + 4 * B + 16 * B}


def power_work(frames: int, B: int) -> dict:
    """``power_kernel`` (K3, K1's second launch) over ``frames`` 512-sample
    stereo frames that count: reads them (2048 bytes each) and writes the
    [B, 257] float32 spectra. Its function's least work a frame, all
    float32: the downmix (2 a sample), the Hann window (1 a sample), a real
    FFT (2.5 N log2 N for N = 512) and |X|^2 summed over frames (4 a bin,
    257 bins)."""
    fft = 2.5 * FRAME * math.log2(FRAME)
    return {
        "bytes": 2048 * frames + 4 * B * (FRAME // 2 + 1),
        "fp32": frames * (3 * FRAME + fft + 4 * (FRAME // 2 + 1)),
    }


def fused_all_work(B: int, L: int, frames: int, *, fir_pipe: str = "fp64") -> dict:
    """``bliss_fused_all`` (K1): K2's and K3's work, with the PCM read once
    (the stats pass reads every sample, so K3's frames add no bytes);
    ``fir_pipe`` as ``stats_work``'s."""
    work = add(stats_work(B, L, fir_pipe=fir_pipe), power_work(frames, B))
    work["bytes"] -= 2048 * frames
    return work


def probe_work(mode: str, B: int, R: int, nblk: int, elem_bytes: int) -> dict:
    """The probe kernel A2 on rows [B, R, 256]: reads what its mode reads
    (nothing; 8 rows of each chunk, min(256, nblk) elements each; one
    element a chunk; every element), writes [B, R, 8] float32; float32 adds
    and products a read element: 1 for a sum, 2 for a packed word's lo + hi,
    11 for the six sums."""
    nc = R // nblk
    read = {
        "zero": 0,
        "slice": B * nc * 8 * min(BLK, nblk),
        "convert": B * nc,
    }.get(mode, B * R * BLK)
    ops = {"sum1": 1, "sum6": 11, "packed": 2}.get(mode, 0)
    return {"bytes": elem_bytes * read + 4 * B * R * 8, "fp32": ops * read}


def matred_work(
    B: int, L: int, *, taps: int = 17, ncheb: int = CHEB_COEFFS,
    halfwidth: float = CHEB_HALFWIDTH,
) -> dict:
    """The matrix-reduction kernel A3 computes ``stats_kernel``'s function
    in another layout (the head's pieces are delta's share, 2 z delta +
    delta^2 in place of y^2), so its least work is the same operations,
    with the FIR's FMAs on the fp64 tensor cores where A3 runs them and
    the weights added in float64; whatever products the tiles spend on the
    Toeplitz matrix's zeros are its algorithm's, not its function's. Reads
    int16 [B, L]; writes [B, L/256, 8] float64."""
    work = stats_work(B, L, taps=taps, ncheb=ncheb, halfwidth=halfwidth, fir_pipe="fp64_tc")
    work["bytes"] = 2 * B * L + 8 * 8 * B * (L // BLK)
    work["fp32"] -= B * L
    work["fp64"] += B * L
    return work


def knn_work(n: int, dim: int, k: int) -> dict:
    """The k-NN kernel (``csrc/knn.cu``) over all n rows of [n, dim] float32
    features: every pair's float64 product, 2 n^2 dim operations at the
    fp64 tensor cores' peak (the symmetric half is the kernel's algorithm,
    not its function); reads the rows once, writes [n, k] float32
    distances and int32 indices."""
    return {"bytes": 4 * n * dim + 8 * n * k, "fp64_tc": 2 * n * n * dim}
