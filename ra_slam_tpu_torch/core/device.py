"""The port's one device rule: a CUDA device without a card raises, and
nothing moves to the CPU silently."""

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device when torch
    sees none (there is no silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False"
        )
    return device
