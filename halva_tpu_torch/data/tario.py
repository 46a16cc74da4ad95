"""ctypes bindings for the native tar shard reader (native/tario.cpp).

The .so is built on demand with g++ from the source where it is, into the
port's git-ignored build directory (build/tario/, never beside the source);
if no compiler is available the pure-Python mmap fallback below provides
the same interface (same index semantics, slower header walk).

Counterpart of halva_tpu/data/tario.py: the same reader over the same
source, built apart from it.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "tario.cpp")
_BUILD = os.path.join(_REPO_ROOT, "build", "tario")
_LOCK = threading.Lock()
_LIB = None


def _build_lib() -> Optional[ctypes.CDLL]:
    so_path = os.path.join(_BUILD, "libtario.so")
    with _LOCK:
        if not os.path.exists(so_path) or os.path.getmtime(
            so_path
        ) < os.path.getmtime(_SRC):
            # build under a per-process name, then rename: two processes
            # building at once never load a half-written library
            tmp = f"{so_path}.{os.getpid()}.tmp"
            try:
                os.makedirs(_BUILD, exist_ok=True)
                subprocess.run(
                    [
                        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        "-o", tmp, _SRC,
                    ],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so_path)
            except (subprocess.CalledProcessError, FileNotFoundError,
                    OSError):
                return None
        lib = ctypes.CDLL(so_path)
        lib.tario_open.restype = ctypes.c_void_p
        lib.tario_open.argtypes = [ctypes.c_char_p]
        lib.tario_count.restype = ctypes.c_int64
        lib.tario_count.argtypes = [ctypes.c_void_p]
        lib.tario_name.restype = ctypes.c_char_p
        lib.tario_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tario_size.restype = ctypes.c_uint64
        lib.tario_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tario_data.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.tario_data.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tario_find.restype = ctypes.c_int64
        lib.tario_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tario_close.argtypes = [ctypes.c_void_p]
        return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is None:
        _LIB = _build_lib() or False
    return _LIB or None


class IndexedTar:
    """mmap'd tar member access: names, sizes, zero-copy reads.

    Interface parity with the reference's MMIndexedTar
    (vila/wids/wids_mmtar.py): len, names, get_by_index, get_by_name.
    """

    def __init__(self, path: str):
        self.path = path
        self._lib = _get_lib()
        if self._lib is not None:
            self._h = self._lib.tario_open(path.encode())
            if not self._h:
                raise OSError(f"tario_open failed: {path}")
            self._native = True
        else:
            self._native = False
            self._open_fallback(path)

    # ---- native path --------------------------------------------------
    def __len__(self) -> int:
        if self._native:
            return int(self._lib.tario_count(self._h))
        return len(self._index)

    def name(self, i: int) -> str:
        if self._native:
            return self._lib.tario_name(self._h, i).decode()
        return self._index[i][0]

    def names(self) -> List[str]:
        return [self.name(i) for i in range(len(self))]

    def get_by_index(self, i: int) -> bytes:
        if self._native:
            size = self._lib.tario_size(self._h, i)
            ptr = self._lib.tario_data(self._h, i)
            return ctypes.string_at(ptr, size)
        name, off, size = self._index[i]
        return bytes(self._mm[off : off + size])

    def get_by_name(self, name: str) -> bytes:
        if self._native:
            idx = self._lib.tario_find(self._h, name.encode())
            if idx < 0:
                raise KeyError(name)
            return self.get_by_index(int(idx))
        return self.get_by_index(self._by_name[name])

    def close(self):
        if self._native and self._h:
            self._lib.tario_close(self._h)
            self._h = None
        elif not self._native:
            self._mm.close()
            self._f.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ---- pure-python fallback -----------------------------------------
    def _open_fallback(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._index: List[Tuple[str, int, int]] = []
        self._by_name: Dict[str, int] = {}
        off = 0
        longname = None
        n = len(self._mm)
        while off + 512 <= n:
            hdr = self._mm[off : off + 512]
            if hdr == b"\0" * 512:
                break
            size = int(hdr[124:136].split(b"\0")[0].strip() or b"0", 8)
            typeflag = hdr[156:157]
            data_off = off + 512
            padded = (size + 511) & ~511
            if typeflag == b"L":
                longname = (
                    self._mm[data_off : data_off + size]
                    .rstrip(b"\0")
                    .decode()
                )
            elif typeflag == b"x":  # PAX extended header
                pax = self._mm[data_off : data_off + size].decode(
                    "utf-8", "replace"
                )
                p = 0
                while p < len(pax):
                    sp = pax.find(" ", p)
                    if sp == -1:
                        break
                    try:
                        reclen = int(pax[p:sp])
                    except ValueError:
                        break
                    rec = pax[sp + 1 : p + reclen - 1]
                    if rec.startswith("path="):
                        longname = rec[5:]
                    p += reclen
            elif typeflag in (b"0", b"\0"):
                if longname:
                    name, longname = longname, None
                else:
                    name = hdr[:100].split(b"\0")[0].decode()
                    prefix = hdr[345:500].split(b"\0")[0].decode()
                    if prefix and hdr[257:262] == b"ustar":
                        name = prefix + "/" + name
                self._by_name[name] = len(self._index)
                self._index.append((name, data_off, size))
            else:
                longname = None
            off = data_off + padded
