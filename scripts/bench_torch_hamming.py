"""The PyTorch port's Hamming kernel (`ra_slam_tpu_torch/csrc/hamming.cu`)
alone, on one NVIDIA GPU: the quick loop for work on that kernel.

    python3 scripts/bench_torch_hamming.py

Builds the kernel, prints nvcc's register and shared-memory report, and
checks the kernel exactly equal to `hamming_matrix_plain` at the edge
shapes of its 128 x 128 tiles. Then, at 1000 x 20000 and 600 x 20000
(random words), times the kernel, the library yardstick (one torch.mm
of the +-1 forms, checked equal after (256 - x) / 2) and a fill_ of the
same output bytes (what plain writes reach on this card) as
`chip_smoke.py` phase 4 does: each call after a 256 MiB write that
flushes the L2, CUDA events (median) and torch.profiler device time
(mean, by kernel name), with the share of the bound (output bytes over
3.35 TB/s). Every line ends with the card's nvidia-smi name and power
limit.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from ra_slam_tpu_torch.features.matching import unpack_pm1  # noqa: E402
from ra_slam_tpu_torch.ops import _build, hamming  # noqa: E402

EXACT_SHAPES = ((1000, 20000), (600, 20000), (1, 1), (128, 128), (130, 300), (1001, 129),
                (17, 20001), (130, 301), (257, 129), (129, 20000))
TIMED_SHAPES = ((1000, 20000), (600, 20000))


def _by_name(fn):
    """Device time of each kernel `fn` runs (one launch per call), over
    REPEATS calls each after an L2 flush (the flush's own kernels left
    out): name -> (mean ms over the records that arrived, their number;
    see `chip_smoke._device_ms`)."""
    flush = {e.name for e in cs._cuda_events(cs._flush_l2)}

    def calls():
        for _ in range(cs.REPEATS):
            cs._flush_l2()
            fn()

    names = {}
    for e in cs._cuda_events(calls):
        if e.name not in flush:
            names.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    return {n: (float(np.mean(t)), len(t)) for n, t in names.items()}


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_torch_hamming: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = cs._smi()
    t0 = time.perf_counter()
    _build.load_library("hamming")
    print(f"build {time.perf_counter() - t0:.2f} s; {card}")
    print((_build.library_dir("hamming") / "build.log").read_text().strip())

    rng = np.random.default_rng(0)
    words = lambda n: torch.as_tensor(
        rng.integers(-2**31, 2**31, (n, 8), dtype=np.int64).astype(np.int32), device=dev)
    for ka, kb in EXACT_SHAPES:
        a, b = words(ka), words(kb)
        k, p = hamming.hamming_matrix(a, b), hamming.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            bad = (k != p).nonzero()
            raise AssertionError(f"kernel != plain at {ka}x{kb}: {len(bad)} entries, first {bad[:4].tolist()}")
    print(f"kernel == plain exactly at {list(EXACT_SHAPES)}")

    for ka, kb in TIMED_SHAPES:
        a, b = words(ka), words(kb)
        k = hamming.hamming_matrix(a, b)
        lib, route = cs._pm1_product(unpack_pm1(a), unpack_pm1(b))
        if not torch.equal((256.0 - lib()) / 2, k):
            raise AssertionError(f"the +-1 product ({route}) differs from the kernel at {ka}x{kb}")
        kern = lambda: hamming.hamming_matrix(a, b)
        ms, lib_ms = cs._median_ms(kern), cs._median_ms(lib)
        filled = torch.empty_like(k)
        fill = lambda: filled.fill_(1.0)
        kdev, ldev, fdev = _by_name(kern), _by_name(lib), _by_name(fill)
        kernel_dev = sum(t for n, (t, _) in kdev.items() if "hamming" in n)
        lib_dev, fill_dev = sum(t for t, _ in ldev.values()), sum(t for t, _ in fdev.values())
        bound_ms, bound_by = cs._bound(k.numel() * 4 + (ka + kb) * 32, k.numel() * 512, cs.INT8_OPS_PER_S)
        fmt = lambda d: ", ".join(f"{n[:60]} {t:.4f} ({c} records)" for n, (t, c) in d.items())
        print(
            f"{ka}x{kb}, cold L2: CUDA events (median of {cs.REPEATS}) kernel {ms:.4f} ms, library "
            f"({route}) {lib_ms:.4f} ms; device ms (profiler, mean) kernel [{fmt(kdev)}], library "
            f"[{fmt(ldev)}], fill_ of the output [{fmt(fdev)}]; bound {bound_ms:.4f} ms ({bound_by}); share: "
            f"kernel {bound_ms / kernel_dev:.3f} (device), {bound_ms / ms:.3f} (events), library "
            f"{bound_ms / lib_dev:.3f} (device), fill_ {bound_ms / fill_dev:.3f} (device); {card}"
        )


if __name__ == "__main__":
    main()
