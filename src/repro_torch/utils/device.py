"""Device selection and the marker for parts of the system not ported yet."""
from __future__ import annotations

import torch

# the ROADMAP.md item (Queue 1) that what is still missing on the LM side names
PLACEMENT = "Expert and TP placement of parameters over the model axis"


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when no card is present.

    Entry points default to "cuda"; the CPU runs only when asked for.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


def not_ported(what: str, roadmap_item: str) -> NotImplementedError:
    """The error raised where a caller asks for what this package lacks yet."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: see ROADMAP.md, Queue 1, "
        f"'{roadmap_item}'")
