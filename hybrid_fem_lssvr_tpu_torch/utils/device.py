"""Where the port's entry points run.

The package is written for an NVIDIA GPU: every entry point that takes a
``device`` argument resolves ``device=None`` through ``resolve`` — the card,
or a ``RuntimeError`` when there is none.  The CPU is used only when the
caller asks for it (``device="cpu"``), as the tests do; nothing falls back
to it silently.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises when no CUDA device is available."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hybrid_fem_lssvr_tpu_torch runs on an NVIDIA GPU by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run on "
            "the CPU"
        )
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``default_device()``."""
    return default_device() if device is None else torch.device(device)
