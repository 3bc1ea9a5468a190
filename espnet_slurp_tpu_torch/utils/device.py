"""Device choice for the port's entry points: CUDA unless the caller says so."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a torch.device; None means the card, and raises when
    there is none (pass ``device="cpu"`` to run on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def cli_device(name: str) -> torch.device:
    """A CLI's ``--device``: a CUDA device raises when there is no card (the
    CLIs default to "cuda" and never fall back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available; pass "
                           "--device cpu to run on the CPU")
    return device


# Host syncs of the decode loops whose trip count depends on the data (the
# transducer's greedy decode and beam searches): each ``host_bool`` call
# copies one value from the device and adds one here.
host_syncs = 0


def host_bool(x: torch.Tensor) -> bool:
    """bool(x), counted in ``host_syncs``."""
    global host_syncs
    host_syncs += 1
    return bool(x)
