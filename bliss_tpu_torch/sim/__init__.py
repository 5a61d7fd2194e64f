"""Similarity on force vectors."""

from bliss_tpu_torch.sim.distance import (
    cosine_similarity,
    cosine_similarity_matrix,
    distance,
    distance_matrix,
    nearest_neighbors,
    nearest_neighbors_all,
    playlist_order,
)
from bliss_tpu_torch.sim.kmeans import kmeans

__all__ = [
    "distance",
    "cosine_similarity",
    "distance_matrix",
    "cosine_similarity_matrix",
    "nearest_neighbors",
    "nearest_neighbors_all",
    "playlist_order",
    "kmeans",
]
