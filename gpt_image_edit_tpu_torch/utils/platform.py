"""Device selection for the port's entry points.

Entry points default to the card. Without a CUDA device they raise unless
the caller asked for the CPU by name: the port never moves to the CPU on
its own, so a run that was meant for the card cannot quietly measure the
CPU instead.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
