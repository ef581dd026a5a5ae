"""Build/load helper for the native IO tier (ctypes, no pybind11).

Compiles slr/native/plyio.cpp into libslrio.so on first use (cached by
mtime) and returns a ctypes handle; callers fall back to pure Python when
no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "plyio.cpp"
_LIB = _DIR / "libslrio.so"

_handle = None
_failed = False


def load_native():
    """Return the ctypes CDLL, building it if needed, or None."""
    global _handle, _failed
    if _handle is not None:
        return _handle
    if _failed:
        return None
    try:
        if (not _LIB.exists()) or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            # build to a per-process name, then rename: concurrent first
            # uses (parallel test workers) never load a half-written file
            tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(str(_LIB))
        lib.slr_write_ply.restype = ctypes.c_int
        lib.slr_write_ply.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.slr_ply_info.restype = ctypes.c_int64
        lib.slr_ply_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.slr_read_ply.restype = ctypes.c_int
        lib.slr_read_ply.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
        ]
        _handle = lib
        return _handle
    except Exception:
        _failed = True
        return None
