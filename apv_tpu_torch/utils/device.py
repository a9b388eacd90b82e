"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. With no
card present it raises: the port never drifts to the CPU unless the caller
names the CPU explicitly, as the tests do. Under a process group
(``parallel/multihost.py``) the card is the one the rank pinned.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (``cuda:<the rank's card>`` under a process
    group); raise when a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apv_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type == "cuda" and dev.index is None and dist.is_available() \
            and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
