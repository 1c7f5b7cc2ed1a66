"""The train's host-to-device copies as a share of the host link's one-way
peak, in %: its float32 bytes over the summed time of the upload blocks'
copies on the device's clock (``cuda_knn.train_residency()["copy_s"]``:
CUDA events around each block's copy, so neither the host's staging nor
the transposes are in it) over 64 GB/s, half of the 128 GB/s both ways of
PCIe 5.0 x16 on the H100 SXM data sheet. None where the program keeps no
such record, or copied nothing over the link (a CPU device)."""

LINK_ONE_WAY_BYTES = 64e9


def read(_r):
    try:
        from knn_tpu_torch.ops.cuda_knn import train_residency
    except ImportError:
        return None
    rec = train_residency()
    if not rec or not rec.get("copy_s"):
        return None
    return 100.0 * rec["host_bytes"] / rec["copy_s"] / LINK_ONE_WAY_BYTES
