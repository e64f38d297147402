"""The native GeoTIFF decoders (``codec.cpp``), built and loaded on
first use.

`codec()` compiles ``codec.cpp`` with the host C++ compiler (``$CXX``,
else ``g++``; ``-O3 -fPIC -shared -std=c++17``) into ``build/`` beside
the package, named by the hash of the source and the flags as
`ops.cuda_lib` names its libraries, loads it through ctypes and returns
the `Codec` over it.  A failed build raises, naming the compiler: the
reader never falls back to decoding in Python.  The plain Python
decoders stay in `io.geotiff` as the reference the tests hold this
library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "codec.cpp"
BUILD = SOURCE.parent.parent.parent / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def target() -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(
        [compiler()] + CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"libgskycodec-{tag}.so"


def build() -> Path:
    """The built library, compiling it when it is not built yet;
    raises RuntimeError naming the compiler when the build fails."""
    out = target()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(
            f"native codec: cannot run the C++ compiler {compiler()!r}: "
            f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native codec: {compiler()!r} failed to build {SOURCE} "
            f"(exit {proc.returncode}): {proc.stderr.strip()[-2000:]}")
    os.replace(tmp, out)
    return out


class Codec:
    """The decoders of one loaded library."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        for name in ("lzw_decode", "packbits_decode"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long,
                           ctypes.c_void_p, ctypes.c_long]
        for name in ("unpredict_h8", "unpredict_h16", "unpredict_h32"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                           ctypes.c_long]
        lib.unpredict_fp.restype = None
        lib.unpredict_fp.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_long, ctypes.c_long,
                                     ctypes.c_long, ctypes.c_long]
        self._lib = lib
        self.path = path

    def lzw_decode(self, data: bytes, expected: int) -> bytes:
        """TIFF LZW (MSB-first codes, early change): at most
        ``expected`` bytes; ValueError on a corrupt stream."""
        data = bytes(data)
        buf = ctypes.create_string_buffer(expected)
        n = self._lib.lzw_decode(data, len(data), buf, expected)
        if n < 0:
            raise ValueError("corrupt LZW stream")
        return buf.raw[:n]

    def packbits_decode(self, data: bytes, expected: int) -> bytes:
        data = bytes(data)
        buf = ctypes.create_string_buffer(expected)
        n = self._lib.packbits_decode(data, len(data), buf, expected)
        return buf.raw[:n]

    def unpredict_h(self, arr: np.ndarray) -> bool:
        """Undo predictor 2 in place on a C-contiguous (rows, cols,
        samples) array of 1, 2 or 4-byte integers; False (nothing done)
        for any other array."""
        fn = {1: self._lib.unpredict_h8, 2: self._lib.unpredict_h16,
              4: self._lib.unpredict_h32}.get(arr.dtype.itemsize)
        if fn is None or arr.ndim != 3 or arr.dtype.kind not in "iu" \
                or not arr.flags.c_contiguous or not arr.flags.writeable:
            return False
        rows, cols, samples = arr.shape
        fn(arr.ctypes.data, rows, cols, samples)
        return True

    def unpredict_fp(self, data: bytes, rows: int, cols: int,
                     samples: int, itemsize: int) -> bytes:
        """Undo predictor 3: ``data`` holds rows x (cols * samples *
        itemsize) delta-coded bytes in big-endian byte planes; returns
        the little-endian samples."""
        data = bytes(data)
        if len(data) < rows * cols * samples * itemsize:
            raise ValueError("predictor-3 block shorter than its shape")
        buf = ctypes.create_string_buffer(len(data))
        self._lib.unpredict_fp(data, buf, rows, cols, samples, itemsize)
        return buf.raw


_codec: Optional[Codec] = None
_lock = threading.Lock()


def codec() -> Codec:
    """The process's `Codec`, built and loaded on first use."""
    global _codec
    if _codec is not None:          # every block decode asks: no lock
        return _codec
    with _lock:
        if _codec is None:
            _codec = Codec(build())
        return _codec
