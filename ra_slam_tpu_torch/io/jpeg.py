"""JPEG decoding for `.sens` colour (the JAX package decodes it with
`cv2.imdecode`), through nvjpeg, bound with ctypes, into a CUDA tensor.

`probe()` reports the JPEG libraries this machine has: `ctypes.util.
find_library` for turbojpeg, jpeg and nvjpeg, and nvjpeg under
`$CUDA_HOME/lib64` (it ships with the CUDA toolkit). The decoder used is
nvjpeg, which needs a CUDA device; where there is none, or no nvjpeg,
`decode_jpeg` raises and says what was probed: nothing decodes a JPEG
another way. nvjpeg's IDCT and chroma upsampling are not libjpeg's, so
its pixels differ from cv2's by a few levels
(`tests/test_torch_sens.py`, `chip_smoke.py`).

Nothing is loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

_NVJPEG_OUTPUT_RGBI = 5  # nvjpegOutputFormat_t: interleaved RGB
_STATE: Dict[str, object] = {}
_LOCK = threading.Lock()


def _cuda_home_nvjpeg() -> Optional[str]:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            found = sorted(glob.glob(os.path.join(os.environ[var], "lib64", "libnvjpeg.so*")))
            if found:
                return found[0]
    found = sorted(glob.glob("/usr/local/cuda/lib64/libnvjpeg.so*"))
    return found[0] if found else None


def probe() -> Dict[str, Optional[str]]:
    """The JPEG libraries found: turbojpeg, jpeg and nvjpeg by
    `ctypes.util.find_library`, nvjpeg also under the CUDA toolkit."""
    out = {name: ctypes.util.find_library(name) for name in ("turbojpeg", "jpeg", "nvjpeg")}
    out["nvjpeg (CUDA toolkit)"] = _cuda_home_nvjpeg()
    return out


def probe_text() -> str:
    return ", ".join(f"{k}: {v or 'not found'}" for k, v in probe().items())


class _Image(ctypes.Structure):  # nvjpegImage_t
    _fields_ = [("channel", ctypes.c_void_p * 4), ("pitch", ctypes.c_size_t * 4)]


def _check(status: int, call: str) -> None:
    if status != 0:
        raise RuntimeError(f"nvjpeg: {call} returned status {status}")


def _nvjpeg():
    """(library, handle, state), created once per process."""
    with _LOCK:
        if "lib" in _STATE:
            return _STATE["lib"], _STATE["handle"], _STATE["state"]
        name = ctypes.util.find_library("nvjpeg") or _cuda_home_nvjpeg()
        if name is None or not torch.cuda.is_available():
            raise RuntimeError(
                "no JPEG decoder: nvjpeg with a CUDA device is the only one bound "
                f"(torch.cuda.is_available() = {torch.cuda.is_available()}; probed {probe_text()})"
            )
        lib = ctypes.CDLL(name)
        vp = ctypes.c_void_p
        lib.nvjpegCreateSimple.argtypes = [ctypes.POINTER(vp)]
        lib.nvjpegJpegStateCreate.argtypes = [vp, ctypes.POINTER(vp)]
        lib.nvjpegGetImageInfo.argtypes = [
            vp, ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int * 4, ctypes.c_int * 4,
        ]
        lib.nvjpegDecode.argtypes = [
            vp, vp, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(_Image), vp,
        ]
        for fn in ("nvjpegCreateSimple", "nvjpegJpegStateCreate", "nvjpegGetImageInfo", "nvjpegDecode"):
            getattr(lib, fn).restype = ctypes.c_int
        torch.cuda.init()
        handle, state = vp(), vp()
        _check(lib.nvjpegCreateSimple(ctypes.byref(handle)), "nvjpegCreateSimple")
        _check(lib.nvjpegJpegStateCreate(handle, ctypes.byref(state)), "nvjpegJpegStateCreate")
        _STATE.update(lib=lib, handle=handle, state=state, name=name)
        return lib, handle, state


def decoder_name() -> str:
    """The library `decode_jpeg` uses (loading it if needed)."""
    _nvjpeg()
    return str(_STATE["name"])


def decode_jpeg(data: bytes, device="cuda") -> torch.Tensor:
    """[H, W, 3] uint8 RGB of a JPEG, on `device` (a CUDA device)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nvjpeg decodes into CUDA memory, not {device}")
    lib, handle, state = _nvjpeg()
    data = bytes(data)
    ncomp, subsampling = ctypes.c_int(), ctypes.c_int()
    widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
    with _LOCK:
        _check(lib.nvjpegGetImageInfo(handle, data, len(data), ctypes.byref(ncomp),
                                      ctypes.byref(subsampling), widths, heights), "nvjpegGetImageInfo")
        h, w = heights[0], widths[0]
        with torch.cuda.device(device):
            out = torch.empty((h, w, 3), dtype=torch.uint8, device=device)
            img = _Image()
            img.channel[0] = out.data_ptr()
            img.pitch[0] = w * 3
            stream = torch.cuda.current_stream(device)
            _check(lib.nvjpegDecode(handle, state, data, len(data), _NVJPEG_OUTPUT_RGBI,
                                    ctypes.byref(img), ctypes.c_void_p(stream.cuda_stream)), "nvjpegDecode")
    return out


def decode_jpeg_numpy(data: bytes) -> np.ndarray:
    """`decode_jpeg` on the current CUDA device, copied to the host."""
    return decode_jpeg(data).cpu().numpy()
