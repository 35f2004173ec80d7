"""ctypes bindings for the native C++ frame decoder
(mebt_tpu_torch/csrc/frameloader.cpp): host JPEG/PNG decode, not a
device kernel.

The library is built with g++ (-ljpeg -lpng) at first use into the
git-ignored `mebt_tpu_torch/_build/libmebt_io-<hash>.so`, the hash
covering source and flags. Where it cannot be built or loaded,
`decode_clip` returns None and the datasets decode with PIL.

  python -m mebt_tpu_torch.data.native build   # explicit build
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "frameloader.cpp"
_BUILD = _PKG / "_build"
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
_LIBS = ("-ljpeg", "-lpng", "-lpthread")
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS + _LIBS).encode())
    return _BUILD / f"libmebt_io-{digest.hexdigest()[:16]}.so"


def build() -> bool:
    """Compile the library if it is missing; False when g++ or the
    image libraries are not there."""
    out = library_path()
    if out.exists():
        return True
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC), *_LIBS],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not build():
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError:
        return None
    lib.mebt_decode_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.mebt_decode_frame.restype = ctypes.c_int
    lib.mebt_decode_clip.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.mebt_decode_clip.restype = ctypes.c_int
    lib.mebt_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mebt_probe.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def decode_clip(paths: list[str], resolution: int, n_threads: int = 4
                ) -> np.ndarray | None:
    """Decode, center-crop, resize, normalize a clip of frames.

    Returns (T, res, res, 3) float32 in [-0.5, 0.5], or None if the
    native library is unavailable or any frame fails (the caller then
    decodes with PIL).
    """
    lib = get_lib()
    if lib is None:
        return None
    t = len(paths)
    out = np.empty((t, resolution, resolution, 3), np.float32)
    arr = (ctypes.c_char_p * t)(*[p.encode() for p in paths])
    failures = lib.mebt_decode_clip(
        arr, t, resolution, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if failures:
        return None
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "build":
        ok = build()
        print(f"built {library_path()}" if ok else "build FAILED")
        sys.exit(0 if ok else 1)
    print(f"native loader available: {available()}")
