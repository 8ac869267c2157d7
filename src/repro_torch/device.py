"""Where the port's entry points run: a CUDA card unless told otherwise."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as given, else ``cuda``. There is no silent fallback to
    the CPU: with no card and no explicit device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' (CLI: --device cpu) to run the kernels' plain "
            "versions on the CPU")
    return torch.device("cuda")
