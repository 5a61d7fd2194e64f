"""The least time the card could take for the work that a cell's timed
path does, from its shapes alone, through the frozen copy of the port's
counting (``reference/bounds.py``). The count is the same whichever
kernels do the work, so a later redesign is judged on the same yardstick.
"""

from __future__ import annotations

from portbench.reference import bounds

FRAME_SAMPLES = 2 * bounds.FRAME  # interleaved stereo samples a spectrum frame


def device_pass_work(lengths) -> dict:
    """One batch's analysis: its songs of ``lengths`` interleaved int16
    samples. Reads the valid samples once and the two int32 inputs a song,
    writes the [B, 4] float32 rows; ``stats_kernel``'s function's float64
    operations on the valid samples, all counted at the fp64 tensor cores'
    peak, and its float32 weight sums with the spectrum's float32 work
    (``bounds.power_work``) on the CUDA cores. The padding past each song
    is no part of the function."""
    B, valid = len(lengths), int(sum(lengths))
    frames = sum(int(n) // FRAME_SAMPLES for n in lengths)
    stats = bounds.stats_work(1, valid)
    return {
        "bytes": 2 * valid + 8 * B + 16 * B,
        "fp64_tc": stats["fp64"],
        "fp32": stats["fp32"] + bounds.power_work(frames, B)["fp32"],
    }


def device_pass_least_s(batches) -> float:
    """Seconds: the sum over ``batches`` (each a list of song lengths) of
    each batch's least time."""
    return sum(bounds.bound_ms(device_pass_work(b))[0] for b in batches) / 1e3


def knn_work(n: int, dim: int, k: int) -> dict:
    """One whole-library k-NN call over [n, dim] float32 rows: the Gram
    matrix's 2 n^2 dim float64 operations at the fp64 tensor cores' peak;
    reads the rows once and writes [n, k] float32 distances and int32
    indices."""
    return {"bytes": 4 * n * dim + 8 * n * k, "fp64_tc": 2 * n * n * dim}


def knn_least_s(n: int, dim: int, k: int) -> float:
    return bounds.bound_ms(knn_work(n, dim, k))[0] / 1e3
