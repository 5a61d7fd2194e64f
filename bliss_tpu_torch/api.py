"""User-facing API of the port (counterpart of ``bliss_tpu/api.py``).

``analyze_pcm`` analyzes decoded PCM and ``analyze_features`` a PCM batch,
under the main path's config or another that the port runs (the hybrid
``AnalysisConfig.for_gpu_hybrid()`` finishes on the host); ``distance`` and
``cosine_similarity`` compare force vectors. Decoding files, ``Song``
objects and the library pipeline are not ported yet (ROADMAP M4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features.analyze import analyze_batch, analyze_batch_hybrid
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.sim import distance as _sim


def default_config() -> AnalysisConfig:
    """The port's main path: ``AnalysisConfig.for_gpu()``."""
    return AnalysisConfig.for_gpu()


@dataclasses.dataclass
class ForceVector:
    """4-D perceptual feature vector (reference: include/bliss.h:26-31)."""

    tempo: float = 0.0
    amplitude: float = 0.0
    frequency: float = 0.0
    attack: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.array(
            [self.tempo, self.amplitude, self.frequency, self.attack],
            np.float32,
        )


def analyze_features(batch: PCMBatch, cfg: AnalysisConfig) -> np.ndarray:
    """[B, 4] float32 force vectors of a PCM batch under ``cfg``: a
    ``tempo_finish="host"`` config goes through ``analyze_batch_hybrid``,
    any other through ``analyze_batch``."""
    if cfg.tempo_finish == "host":
        return analyze_batch_hybrid(batch, cfg).numpy()
    return analyze_batch(batch, cfg).cpu().numpy()


def analyze_pcm(
    arrays: list[np.ndarray],
    durations: list[int],
    *,
    cfg: AnalysisConfig | None = None,
    device="cuda",
) -> np.ndarray:
    """[B, 4] float32 force vectors (tempo, amplitude, frequency, attack) of
    1-D int16 interleaved-stereo PCM arrays at 22.05 kHz, with each song's
    duration in whole seconds, analyzed on ``device``: the GPU unless the
    caller asks for the CPU (``device="cpu"``); raises RuntimeError when no
    GPU is present."""
    cfg = cfg or default_config()
    batch = PCMBatch.from_arrays(
        arrays, durations, pad_multiple=cfg.pad_multiple, device=device
    )
    return analyze_features(batch, cfg)


def _as_vector(v) -> torch.Tensor:
    if isinstance(v, ForceVector):
        v = v.as_array()
    return torch.as_tensor(np.asarray(v, np.float32))


def distance(v1, v2) -> float:
    """Euclidean distance of two force vectors (ForceVectors or 4-arrays;
    reference: python/bliss/distance.py:5-40)."""
    return float(_sim.distance(_as_vector(v1), _as_vector(v2)))


def cosine_similarity(v1, v2) -> float:
    """Cosine similarity of two force vectors."""
    return float(_sim.cosine_similarity(_as_vector(v1), _as_vector(v2)))
