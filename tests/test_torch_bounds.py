"""The kernels' bounds (``bliss_tpu_torch/kernels/bounds.py``) count each
function's least work: the stats kernel's pieces per sample, an FFT for the
spectrum, and the PCM read once in the fused kernel."""

import math

import pytest

from bliss_tpu_torch.kernels import bounds

B, L = 64, 1 << 23  # the main batch
FRAMES = 450_000


def test_stats_work_counts_each_sample_once_per_piece():
    """Per sample: normalization 2, FIR 34, z^2 and three sums 4; each of
    the 16 head samples of a 256-sample block adds the correction (32),
    y = z + delta and y's square and sums (5)."""
    w = bounds.stats_work(1, 256)
    assert w["fp64"] == pytest.approx(256 * (2 + 34 + 4) + 16 * (32 + 5))
    assert w["fp32"] == 256 * (12 + 3 * 18 + 1)
    assert w["bytes"] == 2 * 256 + 8 + 8 * 9
    bare = bounds.stats_work(1, 256, cheb=False, conv=False, warm=False)
    assert bare["fp64"] == 256 * (2 + 4) and bare["fp32"] == 256


def test_power_bound_is_the_frame_read_not_a_dense_dft():
    work = bounds.power_work(FRAMES, B)
    assert work["fp32"] == pytest.approx(
        FRAMES * (3 * 512 + 2.5 * 512 * math.log2(512) + 4 * 257))
    # the frames read once and the [B, 257] float32 output: no table, no scratch
    assert work["bytes"] == 2048 * FRAMES + 4 * B * 257
    ms, by = bounds.bound_ms(work)
    assert by == "bytes" and ms == pytest.approx(work["bytes"] / 3.35e12 * 1e3)


@pytest.mark.parametrize("frames", [0, FRAMES, B * (L // 1024)])
def test_fused_all_reads_the_pcm_once(frames):
    k1 = bounds.fused_all_work(B, L, frames)
    k2, k3 = bounds.stats_work(B, L), bounds.power_work(frames, B)
    assert k1["bytes"] == k2["bytes"] + k3["bytes"] - 2048 * frames
    assert k1["fp32"] == k2["fp32"] + k3["fp32"] and k1["fp64"] == k2["fp64"]
    assert bounds.bound_ms(k1)[0] >= max(bounds.bound_ms(k2)[0], bounds.bound_ms(k3)[0]) - 1e-9


def test_matred_work_is_the_stats_function_in_its_layout():
    a3, k2 = bounds.matred_work(B, L), bounds.stats_work(B, L)
    assert a3["fp64"] == k2["fp64"] and a3["fp32"] == k2["fp32"]
    assert a3["bytes"] == 2 * B * L + 64 * B * (L // 256)
