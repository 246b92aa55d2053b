"""Device helpers that also run on the CPU, where the benchmark's tests
drive a run at a small size."""

from __future__ import annotations

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def name(device) -> str:
    return torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else "cpu"
