from knn_tpu_torch.data.dataset import Attribute, Dataset
from knn_tpu_torch.data.arff import load_arff

__all__ = ["Attribute", "Dataset", "load_arff"]
