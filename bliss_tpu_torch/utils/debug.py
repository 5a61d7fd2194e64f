"""Numerical debugging aids (counterpart of ``bliss_tpu/utils/debug.py``).

``nan_debugging`` raises at the first PyTorch operator whose floating
output holds a NaN, as ``jax_debug_nans`` raises at the first primitive;
``validate_features`` is a copy of ``bliss_tpu``'s feature-vector sanity
check.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# Operators whose output is uninitialized memory: a NaN bit pattern there
# is garbage that the caller overwrites, not a result.
_UNINITIALIZED = frozenset(
    ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize_")
)


class _NanCheck(TorchDispatchMode):
    """Checks the outputs of the operators that compute values. A view
    (``select``, ``slice``, ``view``, ``as_strided``, ``expand``, ``t``,
    ``unsqueeze``, ``alias``, ...: ``OpOverload.is_view``) computes nothing,
    as a JAX primitive that only reshapes computes nothing and so never
    trips ``jax_debug_nans``: a NaN it shows was made by an earlier, checked
    operator, or is memory not written yet, such as a row of an ``empty``
    buffer about to be filled (F8). In-place and ``out=`` operators
    (``copy_``, ``fill_``, ``index_put_``, ...) are checked: their output is
    what they wrote."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_debugging():
    """Raise FloatingPointError at the first PyTorch operator, on any
    device, whose floating output holds a NaN (each check reads the result
    back, so the device synchronizes after every operator).

    The port's CUDA kernels launch through ``ctypes``
    (``kernels/_build.launch``), below PyTorch's dispatcher, so the mode
    cannot see inside them: a NaN that a kernel writes raises at the first
    PyTorch operator whose output holds it."""
    with _NanCheck():
        yield


# Plausible envelope of force-vector components for real audio; values far
# outside indicate decode corruption or masking bugs rather than unusual
# music (the affine score calibrations put typical songs in [-4, 4], see
# reference: src/amplitude_sort.c:76-79).
_COMPONENT_RANGE = (-200.0, 200.0)


def validate_features(features, files=None) -> list[str]:
    """Return a list of human-readable problems found in [N, 4] features."""
    features = np.asarray(features)
    problems = []
    lo, hi = _COMPONENT_RANGE
    for i, row in enumerate(features):
        name = files[i] if files is not None else f"row {i}"
        if np.isnan(row).any():
            problems.append(f"{name}: NaN feature (decode failure or silence)")
        elif not ((row >= lo) & (row <= hi)).all():
            problems.append(f"{name}: feature out of plausible range: {row}")
    return problems
