"""JPEG decoding and encoding for `.sens` colour (the JAX package uses
`cv2.imdecode` / `cv2.imencode`), through nvjpeg, bound with ctypes, on
a CUDA device.

`probe()` reports the JPEG libraries this machine has: `ctypes.util.
find_library` for turbojpeg, jpeg and nvjpeg, and nvjpeg under
`$CUDA_HOME/lib64` (it ships with the CUDA toolkit). The decoder used is
nvjpeg, which needs a CUDA device; where there is none, or no nvjpeg,
`decode_jpeg` raises and says what was probed: nothing decodes a JPEG
another way. nvjpeg's IDCT and chroma upsampling are not libjpeg's, so
its pixels differ from cv2's by a few levels
(`tests/test_torch_sens.py`, `tests/test_torch_cuda.py`). `encode_jpeg`
writes baseline JPEG at the JAX writer's settings (quality 95, 4:2:0
chroma, cv2's defaults). It converts to YCbCr and halves the chroma as
libjpeg, cv2's encoder, does (`rgb_to_ycbcr420`, on the device), and
nvjpeg encodes the planes: from RGB, nvjpeg's own chroma subsampling
loses up to 6.8 dB of PSNR against cv2's on frames with sharp colour
edges (`tests/test_torch_cuda.py::test_nvjpeg_encoder_round_trip`). On
the CPU there is no encoder and it raises.

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

from ra_slam_tpu_torch.utils.profiling import TRACE

_NVJPEG_OUTPUT_RGBI = 5  # nvjpegOutputFormat_t: interleaved RGB
_NVJPEG_CSS_420 = 2  # nvjpegChromaSubsampling_t
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
        lib.nvjpegEncoderStateCreate.argtypes = [vp, ctypes.POINTER(vp), vp]
        lib.nvjpegEncoderParamsCreate.argtypes = [vp, ctypes.POINTER(vp), vp]
        lib.nvjpegEncoderParamsSetQuality.argtypes = [vp, ctypes.c_int, vp]
        lib.nvjpegEncoderParamsSetSamplingFactors.argtypes = [vp, ctypes.c_int, vp]
        lib.nvjpegEncodeYUV.argtypes = [
            vp, vp, vp, ctypes.POINTER(_Image), ctypes.c_int, ctypes.c_int, ctypes.c_int, vp,
        ]
        lib.nvjpegEncodeRetrieveBitstream.argtypes = [vp, vp, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t), vp]
        for fn in ("nvjpegCreateSimple", "nvjpegJpegStateCreate", "nvjpegGetImageInfo", "nvjpegDecode",
                   "nvjpegEncoderStateCreate", "nvjpegEncoderParamsCreate", "nvjpegEncoderParamsSetQuality",
                   "nvjpegEncoderParamsSetSamplingFactors", "nvjpegEncodeYUV", "nvjpegEncodeRetrieveBitstream"):
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
    with TRACE.span("jpeg.decode"):
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
    img = decode_jpeg(data)
    with TRACE.wait("jpeg.to_host"):
        return img.cpu().numpy()


def _encoder(lib, handle, quality: int):
    """(encoder state, params at `quality`), created once per quality."""
    key = ("encoder", quality)
    if key not in _STATE:
        vp = ctypes.c_void_p
        state, params = vp(), vp()
        _check(lib.nvjpegEncoderStateCreate(handle, ctypes.byref(state), None), "nvjpegEncoderStateCreate")
        _check(lib.nvjpegEncoderParamsCreate(handle, ctypes.byref(params), None), "nvjpegEncoderParamsCreate")
        _check(lib.nvjpegEncoderParamsSetQuality(params, quality, None), "nvjpegEncoderParamsSetQuality")
        _check(lib.nvjpegEncoderParamsSetSamplingFactors(params, _NVJPEG_CSS_420, None),
               "nvjpegEncoderParamsSetSamplingFactors")
        _STATE[key] = (state, params)
    return _STATE[key]


def encoder_device(device) -> torch.device:
    """`device` as a torch.device when it can encode JPEG (a CUDA
    device); raises for the CPU, which has no encoder."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(
            f"no JPEG encoder on the CPU: nvjpeg encodes on a CUDA device, not {device}; write PNG colour instead"
        )
    return device


def rgb_to_ycbcr420(img: torch.Tensor):
    """[H, W, 3] uint8 RGB -> uint8 planes Y [H, W], Cb and Cr [ceil(H/2),
    ceil(W/2)], as libjpeg computes them: JFIF YCbCr in 16-bit fixed
    point (jccolor.c), then each 2x2 block of chroma averaged with the
    alternating rounding bias 1, 2 (jcsample.c `h2v2_downsample`), odd
    edges replicated."""
    r, g, b = (img[..., c].to(torch.int64) for c in range(3))
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    off = (128 << 16) + 32767
    cb = (-11059 * r - 21709 * g + 32768 * b + off) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off) >> 16
    h, w = y.shape

    def halve(c):
        c = torch.nn.functional.pad(c[None, None].double(), (0, w % 2, 0, h % 2), mode="replicate")[0, 0].long()
        s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
        bias = 1 + (torch.arange(s.shape[1], device=s.device) & 1)
        return ((s + bias) >> 2).to(torch.uint8)

    return y.to(torch.uint8), halve(cb), halve(cr)


def encode_jpeg(rgb, quality: int = 95, device="cuda") -> bytes:
    """Baseline JPEG (4:2:0) of an [H, W, 3] uint8 RGB image (numpy or a
    tensor), encoded by nvjpeg on `device` (a CUDA device; the CPU has
    no encoder and raises)."""
    device = encoder_device(device)
    lib, handle, _ = _nvjpeg()
    img = torch.as_tensor(np.asarray(rgb) if not isinstance(rgb, torch.Tensor) else rgb)
    if img.dtype != torch.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes [H, W, 3] uint8 RGB, got {tuple(img.shape)} {img.dtype}")
    h, w = img.shape[:2]
    with _LOCK, torch.cuda.device(device):
        planes = [p.contiguous() for p in rgb_to_ycbcr420(img.to(device))]
        state, params = _encoder(lib, handle, quality)
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        image = _Image()
        for c, p in enumerate(planes):
            image.channel[c] = p.data_ptr()
            image.pitch[c] = p.shape[1]
        _check(lib.nvjpegEncodeYUV(handle, state, params, ctypes.byref(image), _NVJPEG_CSS_420, w, h, stream),
               "nvjpegEncodeYUV")
        length = ctypes.c_size_t(0)
        _check(lib.nvjpegEncodeRetrieveBitstream(handle, state, None, ctypes.byref(length), stream),
               "nvjpegEncodeRetrieveBitstream")
        out = ctypes.create_string_buffer(length.value)
        _check(lib.nvjpegEncodeRetrieveBitstream(handle, state, out, ctypes.byref(length), stream),
               "nvjpegEncodeRetrieveBitstream")
        torch.cuda.current_stream(device).synchronize()
    return out.raw[:length.value]
