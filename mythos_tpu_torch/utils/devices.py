"""Device selection of the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``, where each kernel wrapper takes its plain version). A
missing CUDA device is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch

ERR_NO_CUDA = (
    "no CUDA device: the port's entry points run on an NVIDIA GPU by default; "
    "pass device='cpu' to run the plain PyTorch versions on the CPU"
)


def resolve(device: torch.device | str) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(ERR_NO_CUDA)
    return dev
