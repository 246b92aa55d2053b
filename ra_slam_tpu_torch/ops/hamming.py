"""Dense Hamming-distance matrix over packed ORB descriptors: the CUDA
kernel `csrc/hamming.cu` and its plain PyTorch version (counterpart of
`ra_slam_tpu/ops/hamming.py`).

Descriptors are [K, 8] int32: the bit patterns of the JAX package's
uint32 words. Both versions return the exact distances as float32
[Ka, Kb] (integers <= 256), the type the matcher consumes.

`hamming_matrix` is the entry point. On CUDA tensors it launches the
kernel; on CPU tensors it runs `hamming_matrix_plain`; any other device
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ra_slam_tpu_torch.ops._build import load_library
from ra_slam_tpu_torch.utils.profiling import TRACE

WORDS = 8

LAUNCHES = 0  # kernel launches made by hamming_matrix (CUDA path only)
TRACE.expose("hamming.launches", lambda: LAUNCHES)


def _check(desc_a: torch.Tensor, desc_b: torch.Tensor) -> None:
    for name, t in (("desc_a", desc_a), ("desc_b", desc_b)):
        if t.dtype != torch.int32:
            raise TypeError(f"hamming_matrix: {name} is {t.dtype}, expected torch.int32")
        if t.ndim != 2 or t.shape[1] != WORDS:
            raise ValueError(f"hamming_matrix: {name} has shape {tuple(t.shape)}, expected [K, {WORDS}]")
        if not t.is_contiguous():
            raise ValueError(f"hamming_matrix: {name} is not contiguous")
    if desc_a.device != desc_b.device:
        raise ValueError(f"hamming_matrix: desc_a on {desc_a.device}, desc_b on {desc_b.device}")


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int32 bit patterns, by SWAR in int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix_plain(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device: XOR of the words and a
    SWAR popcount, summed over the 8 words one at a time (no [Ka, Kb, 8]
    intermediate). Returns float32 [Ka, Kb]."""
    _check(desc_a, desc_b)
    acc = torch.zeros(desc_a.shape[0], desc_b.shape[0], dtype=torch.int64, device=desc_a.device)
    for w in range(WORDS):
        acc += _popcount32(desc_a[:, w, None] ^ desc_b[None, :, w])
    return acc.to(torch.float32)


def _launcher():
    fn = load_library("hamming").hamming_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int64, ctypes.c_int64, p]
        fn.restype = ctypes.c_int
    return fn


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Exact Hamming distances [Ka, Kb] float32 between [Ka, 8] and
    [Kb, 8] int32 descriptors: the CUDA kernel on a CUDA device, the
    plain version on the CPU."""
    global LAUNCHES
    dev = desc_a.device
    if dev.type == "cpu":
        return hamming_matrix_plain(desc_a, desc_b)
    if dev.type != "cuda":
        raise RuntimeError(f"hamming_matrix: no kernel for device {dev}")
    _check(desc_a, desc_b)
    for name, t in (("desc_a", desc_a), ("desc_b", desc_b)):
        if t.data_ptr() % 8:  # the kernel reads words in 8-byte pairs
            raise ValueError(f"hamming_matrix: {name} does not start on an 8-byte boundary")
    ka, kb = desc_a.shape[0], desc_b.shape[0]
    out = torch.empty(ka, kb, dtype=torch.float32, device=dev)
    if ka == 0 or kb == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launcher()(desc_a.data_ptr(), desc_b.data_ptr(), out.data_ptr(), ka, kb, stream)
    if rc != 0:
        raise RuntimeError(f"hamming_matrix kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
