from knn_tpu_torch.utils.padding import pad_axis_to_multiple
from knn_tpu_torch.utils.evaluate import confusion_matrix, accuracy
from knn_tpu_torch.utils.timing import RegionTimer
from knn_tpu_torch.utils.cli_format import result_line

__all__ = [
    "pad_axis_to_multiple",
    "confusion_matrix",
    "accuracy",
    "RegionTimer",
    "result_line",
]
