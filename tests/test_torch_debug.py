"""The port's debugging and profiling helpers (``bliss_tpu_torch/utils``)
against ``bliss_tpu``'s (``tests/test_utils.py:53-77``): ``validate_features``,
``nan_debugging`` as a PyTorch dispatch mode, ``trace_annotation`` and
``device_trace`` over ``torch.profiler``."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from bliss_tpu.utils import validate_features as jax_validate_features

from bliss_tpu_torch import AnalysisConfig, analyze_pcm
from bliss_tpu_torch.utils import nan_debugging, trace_annotation, validate_features
from bliss_tpu_torch.utils.profiling import device_trace

torch.set_num_threads(1)


def test_validate_features_flags_problems():
    feats = np.array(
        [
            [-8.9, -10.6, -10.1, -15.5],
            [np.nan, 0, 0, 0],
            [1e6, 0, 0, 0],
        ],
        np.float32,
    )
    files = ["good", "bad-nan", "bad-range"]
    problems = validate_features(feats, files=files)
    assert len(problems) == 2
    assert any("bad-nan" in p for p in problems)
    assert any("bad-range" in p for p in problems)
    assert problems == jax_validate_features(feats, files=files)
    assert validate_features(feats) == jax_validate_features(feats)


def test_nan_debugging_context():
    x = torch.tensor([4.0, 9.0])
    with nan_debugging():
        # healthy computation passes
        assert torch.sqrt(x).tolist() == [2.0, 3.0]
        # uninitialized memory is not a result
        torch.empty(4096).fill_(1.0)
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            torch.sqrt(torch.tensor([-1.0]))
        with pytest.raises(FloatingPointError, match="aten.div"):
            torch.zeros(3, dtype=torch.float64) / 0.0
        # integer outputs hold no NaN
        assert torch.arange(3).sum().item() == 3
    # the mode is off again
    assert torch.isnan(torch.sqrt(torch.tensor([-1.0]))).all()


@contextlib.contextmanager
def _nan_in_unwritten_memory():
    """Every buffer the allocator hands out unwritten (``empty`` and its
    kin) holds NaN: PyTorch's deterministic mode fills it so. That is the
    worst heap a test worker can leave behind, made certain: NaN-filled
    tensors that an earlier test freed reach the same buffers only now and
    then (F8)."""
    was = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def test_views_of_unwritten_memory_are_not_results():
    """F8: a view computes nothing, so ``t[0]`` of a NaN tensor made outside
    the mode does not raise; a product of it does."""
    t = torch.full((3, 4), float("nan"))
    with nan_debugging():
        row = t[0]
        t.view(-1)[:2].unsqueeze(0).expand(2, 2)
        t.t()[1:3].diagonal()
        with pytest.raises(FloatingPointError, match="aten.mul"):
            row * 1
        # an in-place write is checked: its output is what it wrote
        with pytest.raises(FloatingPointError, match="aten.copy_"):
            torch.zeros(4).copy_(row)
    assert torch.isnan(row).all()


def test_main_path_produces_no_nan():
    """The port's main path on the CPU (the kernels' plain versions) runs
    under nan_debugging: no operator of it yields a NaN, even where every
    buffer it takes unwritten holds NaN (F8)."""
    rng = np.random.RandomState(0)
    t = np.arange(30_000)
    song = (8000 * np.sin(2 * np.pi * t / 40.0) + 500 * rng.randn(t.size)).astype(np.int16)
    want = analyze_pcm([song], [1], cfg=AnalysisConfig.for_gpu(), device="cpu")
    with _nan_in_unwritten_memory():
        assert torch.isnan(torch.empty(4)).all()
        with nan_debugging():
            got = analyze_pcm([song], [1], cfg=AnalysisConfig.for_gpu(), device="cpu")
    np.testing.assert_array_equal(got, want)


def test_trace_annotation_and_device_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        with trace_annotation("bliss/annotated"):
            torch.ones(64).cumsum(0)
    assert any(e.name == "bliss/annotated" for e in prof.events())
    (name,) = os.listdir(tmp_path / "trace")
    assert name.startswith(f"trace-{os.getpid()}-") and name.endswith(".json")
    with open(tmp_path / "trace" / name) as f:
        trace = json.load(f)
    assert any(e.get("name") == "bliss/annotated" for e in trace["traceEvents"])
    # outside a profiler the annotation is a plain context
    with trace_annotation("bliss/unprofiled"):
        pass
