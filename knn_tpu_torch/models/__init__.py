from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor, sweep_k

__all__ = ["KNNClassifier", "KNNRegressor", "sweep_k"]
