"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card by default; the CPU only when the caller asks for it.

    Raises when the card is asked for (explicitly or by default) and none
    is present, so a missing GPU never turns silently into a CPU run.
    ``"meta"`` (shapes and dtypes only, no storage) is taken when asked
    for, as the dry run and the shard check build full-size trees."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "meta":
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
