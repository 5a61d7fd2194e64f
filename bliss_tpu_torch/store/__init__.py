from bliss_tpu_torch.store.feature_store import FeatureStore, similarity_rows

__all__ = ["FeatureStore", "similarity_rows"]
