"""Published peaks of the card (NVIDIA H100 data sheet, SXM part, dense
rates without sparsity, at the full 700 W power limit): the yardstick of
every roofline share and of ``mfu``."""

MEM_BW = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12}
F32_OPS = 67e12            # float32 outside the tensor cores
BF16_TENSOR_OPS = 989e12   # dense bfloat16 on the tensor cores


def mem_bw(card: str) -> float:
    """Bytes/s of ``card`` (``torch.cuda.get_device_name()``), the SXM
    part's where the name says no other."""
    for key in sorted(MEM_BW, key=len, reverse=True):
        if key in card:
            return MEM_BW[key]
    return MEM_BW["H100"]
