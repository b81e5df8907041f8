"""The device of the port's entry points: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; a CUDA device on a host without CUDA raises
    (no silent fall-back to the CPU), naming ``device="cpu"``."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available on this host; pass "
                           "device=\"cpu\" to run the plain torch versions on the CPU")
    return d
