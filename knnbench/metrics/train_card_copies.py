"""The device's bytes held for the train on the kernels' route over the
train's float32 bytes (``cuda_knn.train_residency()``: every tensor the
device cache holds for the train on that device, and all kept with them,
read from the tensors): 1.00 is one copy. None where the program keeps no
such record."""


def read(_r):
    try:
        from knn_tpu_torch.ops.cuda_knn import train_residency
    except ImportError:
        return None
    rec = train_residency()
    if not rec or rec.get("host_bytes", 0) <= 0:
        return None
    return rec["card_bytes"] / rec["host_bytes"]
