"""ctypes bindings for the MJPEG/AVI video codec in csrc/mjpeg_avi.c at the
repository root (the port's own copy of lavie_tpu.native.mjpeg's loader).

At first use the C source is compiled with the system C compiler against
libjpeg into `build/libmjpeg_avi-<hash>.so` at the root of the checkout,
the directory the CUDA kernels build into (kernels/_build.py); the hash is
of the source, so an edited codec is rebuilt. `is_available()` is False
when no compiler or no libjpeg is found, and io.video then writes a GIF.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SRC = ROOT / "csrc" / "mjpeg_avi.c"
BUILD = ROOT / "build"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FAILED = False


def library_path() -> Path:
    return BUILD / f"libmjpeg_avi-{hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]}.so"


def _build() -> Optional[Path]:
    """Compile the codec; None when no compiler or libjpeg is found. The
    library is written under a temporary name and renamed into place, so
    processes that build at once never load a half-written file."""
    if not SRC.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    for cc in ("cc", "gcc"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        try:
            r = subprocess.run([cc, "-O2", "-shared", "-fPIC", str(SRC), "-ljpeg", "-o", tmp],
                               capture_output=True, timeout=120)
        except (FileNotFoundError, subprocess.TimeoutExpired):
            os.unlink(tmp)
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            return out
        os.unlink(tmp)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        path = _build()
        if path is None:
            _FAILED = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _FAILED = True
            return None
        u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
        lib.write_mjpeg_avi.argtypes = [ctypes.c_char_p, u8p] + [ctypes.c_int] * 5
        lib.write_mjpeg_avi.restype = ctypes.c_int
        lib.probe_mjpeg_avi.argtypes = [ctypes.c_char_p, ip, ip, ip, ip]
        lib.probe_mjpeg_avi.restype = ctypes.c_int
        lib.read_mjpeg_avi.argtypes = [ctypes.c_char_p, u8p] + [ctypes.c_int] * 3
        lib.read_mjpeg_avi.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def is_available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the MJPEG/AVI codec is unavailable: no C compiler or no libjpeg")
    return lib


def write_avi(path: str, frames: np.ndarray, fps: int = 8, quality: int = 90) -> None:
    """frames (F, H, W, 3) uint8 → an MJPEG AVI at `path`."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (F, H, W, 3) frames, got {frames.shape}")
    n, h, w, _ = frames.shape
    rc = _lib().write_mjpeg_avi(path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                n, h, w, int(fps), int(quality))
    if rc != 0:
        raise IOError(f"write_mjpeg_avi failed with code {rc}")


def probe_avi(path: str) -> Tuple[int, int, int, int]:
    """(frames, height, width, fps) of an MJPEG AVI."""
    n, h, w, fps = (ctypes.c_int() for _ in range(4))
    rc = _lib().probe_mjpeg_avi(path.encode(), ctypes.byref(n), ctypes.byref(h), ctypes.byref(w),
                                ctypes.byref(fps))
    if rc != 0:
        raise IOError(f"probe_mjpeg_avi failed with code {rc}")
    return n.value, h.value, w.value, fps.value


def read_avi(path: str) -> np.ndarray:
    """An MJPEG AVI → (F, H, W, 3) uint8."""
    n, h, w, _ = probe_avi(path)
    out = np.empty((n, h, w, 3), dtype=np.uint8)
    got = _lib().read_mjpeg_avi(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                n, h, w)
    if got <= 0:
        raise IOError(f"read_mjpeg_avi decoded {got} frames")
    return out[:got]
