"""The device rule of the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU,
where the kernel wrappers run their plain PyTorch versions (the tests do
that). Without a card they raise; they never carry on on the CPU quietly.
"""
from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve_device(device=DEFAULT) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a CUDA card
    and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
