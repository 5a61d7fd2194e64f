"""bliss_tpu_torch: the bliss-tpu analysis path in PyTorch, with its
kernels written in CUDA for NVIDIA Hopper (sm_90a).

A port of ``bliss_tpu`` (JAX on TPU), which stays in the repository as the
reference the port is tested against. This package imports torch, numpy and
scipy only: nothing of JAX and nothing of ``bliss_tpu``.
"""

from bliss_tpu_torch.constants import (
    BL_CALM,
    BL_LOUD,
    BL_OK,
    BL_UNEXPECTED,
    BL_UNKNOWN,
    VERSION,
)
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.api import (
    ForceVector,
    Song,
    analyze,
    analyze_features,
    analyze_pcm,
    cosine_similarity,
    cosine_similarity_file,
    default_config,
    distance,
    distance_file,
    version,
)

__version__ = VERSION

__all__ = [
    "AnalysisConfig",
    "ForceVector",
    "Song",
    "analyze",
    "analyze_features",
    "analyze_pcm",
    "cosine_similarity",
    "cosine_similarity_file",
    "default_config",
    "distance",
    "distance_file",
    "version",
    "BL_LOUD",
    "BL_CALM",
    "BL_UNKNOWN",
    "BL_UNEXPECTED",
    "BL_OK",
]
