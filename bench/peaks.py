"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives.  NVIDIA's data sheet, SXM part,
dense rates without sparsity, at the full 700 W."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    return PEAKS.get(device_name)
