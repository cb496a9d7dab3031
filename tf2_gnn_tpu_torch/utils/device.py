"""Device choice for the port's entry points.

Entry points take ``device="cuda"`` by default. A request for the card on a
machine without one raises here instead of running on the CPU: a CPU run
must be asked for explicitly (``device="cpu"``).
"""
from typing import Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions on "
            "the CPU."
        )
    return dev


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or an array-like) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)
