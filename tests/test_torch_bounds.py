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
    y = z + delta and y's square and sums (5). The amplitude weight: its
    series once for each of the 400 values of |s + 1| around 1000 that are
    not 0 or 1 (66 FLOP each, once a call), then an add a sample."""
    w = bounds.stats_work(1, 256)
    assert w["fp64"] == pytest.approx(256 * (2 + 34 + 4) + 16 * (32 + 5))
    assert w["fp32"] == 256 + 400 * (12 + 3 * 18)
    assert bounds.stats_work(64, 256)["fp32"] == 64 * 256 + 400 * (12 + 3 * 18)
    assert bounds.stats_work(1, 256, ncheb=15, halfwidth=127.5)["fp32"] == 256 + 256 * (12 + 3 * 14)
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
    """A3's work is K2's, with the FIR's FMAs on the fp64 tensor cores and
    the float32 weights added in float64."""
    a3, k2 = bounds.matred_work(B, L), bounds.stats_work(B, L)
    assert a3["fp64"] + a3["fp64_tc"] == k2["fp64"] + B * L
    assert a3["fp32"] == k2["fp32"] - B * L == bounds.weight_table_flops(19, 200)
    assert a3["fp64_tc"] == B * L * 34
    assert a3["bytes"] == 2 * B * L + 64 * B * (L // 256)


def test_stats_work_counts_the_fir_on_the_tensor_cores_when_asked():
    """``fir_pipe="fp64_tc"``: the 17-tap FIR's 34 FLOP a sample on the fp64
    tensor cores (67 TFLOP/s), the normalization, sums and correction on
    the CUDA cores; the default moves nothing."""
    assert bounds.PEAK["fp64_tc"] == 67e12
    tc, cc = bounds.stats_work(1, 256, fir_pipe="fp64_tc"), bounds.stats_work(1, 256)
    assert tc["fp64_tc"] == 256 * 34
    assert tc["fp64"] == pytest.approx(256 * (2 + 4) + 16 * (32 + 5))
    assert tc["fp32"] == cc["fp32"] and tc["bytes"] == cc["bytes"]
    assert "fp64_tc" not in cc
    assert "fp64_tc" not in bounds.stats_work(1, 256, conv=False, fir_pipe="fp64_tc")
    with pytest.raises(ValueError):
        bounds.stats_work(1, 256, fir_bytes=4, fir_pipe="fp64_tc")
    # at the main batch the FIR leaves the fp64 pipe: the bound drops from
    # the fp64 CUDA cores (0.668 ms) to the bytes (0.371 ms), above the
    # FIR's 0.272 on the tensor cores and the rest's 0.131 on the CUDA cores
    k2, k2_tc = bounds.stats_work(B, L), bounds.stats_work(B, L, fir_pipe="fp64_tc")
    assert bounds.bound_ms(k2) == (pytest.approx(0.66813, abs=1e-5), "operations")
    assert bounds.bound_ms(k2_tc) == (pytest.approx(0.37060, abs=1e-5), "bytes")
    assert k2_tc["fp64_tc"] / 67e12 * 1e3 == pytest.approx(0.27244, abs=1e-5)
    assert k2_tc["fp64"] / 34e12 * 1e3 == pytest.approx(0.13126, abs=1e-5)
    k1_tc = bounds.fused_all_work(B, L, FRAMES, fir_pipe="fp64_tc")
    assert k1_tc["fp64_tc"] == k2_tc["fp64_tc"] and k1_tc["fp64"] == k2_tc["fp64"]
    assert k1_tc["bytes"] == bounds.fused_all_work(B, L, FRAMES)["bytes"]
    assert bounds.bound_ms(k1_tc)[1] == "bytes"
    # A3 under either fit: its bytes (8 float64 columns a block), 0.361 ms
    for ncheb, hw in ((19, 200), (15, 128)):
        a3 = bounds.matred_work(B, L, ncheb=ncheb, halfwidth=hw)
        assert bounds.bound_ms(a3) == (pytest.approx(0.36058, abs=1e-5), "bytes")


def test_prepass_bound_is_one_read():
    """The prepass reads each valid int16 sample once (not the padding past
    n_b) and the counts, and writes two int64 sums a song; its integer
    arithmetic is on no floating-point pipe. A full batch reads all B * L
    samples; one of ~0.86 B L valid samples is bound ~0.86 as long."""
    work = bounds.prepass_work(B * L, B)
    assert work == {"bytes": 2 * B * L + 20 * B}
    ms, by = bounds.bound_ms(work)
    assert by == "bytes" and ms == pytest.approx(0.3205, abs=1e-4)
    part = bounds.prepass_work(int(0.86 * B * L), B)
    assert part["bytes"] == 2 * int(0.86 * B * L) + 20 * B
    assert bounds.bound_ms(part)[0] == pytest.approx(0.86 * ms, rel=1e-4)


@pytest.mark.parametrize("dim, want_ms", [(4, 1.19403), (49, 14.62687)])
def test_knn_bound_is_every_pair_at_the_tensor_cores(dim, want_ms):
    work = bounds.knn_work(100_000, dim, 5)
    assert work["fp64_tc"] == 2 * 10**10 * dim
    assert work["bytes"] == 4 * 100_000 * dim + 8 * 100_000 * 5
    ms, by = bounds.bound_ms(work)
    assert by == "operations" and ms == pytest.approx(want_ms, rel=1e-5)
