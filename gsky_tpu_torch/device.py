"""Device resolution for the port's entry points.

Counterpart of `gsky_tpu/device.py`.  The JAX package probes its
accelerator in a subprocess and falls back to the CPU; the port does
not fall back: an entry point runs on the card unless its caller asks
for the CPU, and asking for CUDA where there is none raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or torch.device, default "cuda") -> torch.device.
    Raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
