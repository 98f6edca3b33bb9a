"""Native (C++) helpers for kart-tpu.

The offline index builder uses a C++ SA-IS suffix-array routine (sais.cpp),
compiled on demand with g++ into a shared object and loaded via ctypes.
A pure-NumPy prefix-doubling fallback keeps everything functional when no
C++ toolchain is available (slower, same results).

Every shared object is named by `build_key`: a hash of its source, the
compiler command and the host CPU.  A library is therefore reused only by
the machine that built it from the same source with the same flags, and a
checkout copied to another machine (or with an edited source) rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys

import numpy as np

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_NATIVE_DIR, "_build")
_LIB = None
_LIB_TRIED = False


def host_cpu_signature() -> str:
    """What -march=native compiles for: the CPU model and its feature
    flags (first processor of /proc/cpuinfo), else the platform's name."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # end of the first processor's block
                k, _, v = line.partition(":")
                fields[k.strip()] = v.strip()
    except OSError:
        pass
    keys = ("vendor_id", "model name", "flags", "Features", "CPU part")
    sig = "|".join(fields.get(k, "") for k in keys)
    return f"{platform.machine()}|{sig or platform.processor()}"


def build_key(src: str, cmd: list[str], cpu: str | None = None) -> str:
    """16-hex-digit key of (source bytes, compiler command, host CPU)."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update("\0".join(cmd).encode())
    h.update((host_cpu_signature() if cpu is None else cpu).encode())
    return h.hexdigest()[:16]


def build_shared(src: str, name: str, flags: list[str], libs: list[str] = ()) -> str | None:
    """Compile `src` into _build/lib<name>-<key>.so unless that exact build
    exists; returns its path, or None (after reporting the compiler's
    error on stderr) when the build fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = ["g++", *flags, "-shared", "-fPIC"]
    out = os.path.join(_BUILD_DIR, f"lib{name}-{build_key(src, cmd + list(libs))}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(cmd + [src, "-o", tmp, *libs], check=True, capture_output=True)
    except FileNotFoundError:
        print(f"kart-tpu: cannot build {name}: g++ not found", file=sys.stderr)
        return None
    except subprocess.CalledProcessError as e:
        err = e.stderr.decode(errors="replace").strip().splitlines()
        print(f"kart-tpu: building {name} failed:\n" + "\n".join(err[-20:]),
              file=sys.stderr)
        return None
    os.replace(tmp, out)
    return out


def _load_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = build_shared(os.path.join(_NATIVE_DIR, "sais.cpp"), "kartsais",
                        ["-O3", "-std=c++17"])
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.kart_sais_u8.restype = ctypes.c_int
    lib.kart_sais_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _LIB = lib
    return _LIB


def _suffix_array_numpy(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array, O(n log^2 n). Fallback path."""
    n = len(text)
    rank = text.astype(np.int64)
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    tmp = np.empty(n, dtype=np.int64)
    k = 1
    while k < n:
        # rank2[i] = rank[i+k] or -1
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        key = rank * (n + 1) + (rank2 + 1)
        sa = np.argsort(key, kind="stable").astype(np.int64)
        sorted_key = key[sa]
        tmp[0] = 0
        np.cumsum(sorted_key[1:] != sorted_key[:-1], out=tmp[1:])
        rank = np.empty(n, dtype=np.int64)
        rank[sa] = tmp
        if rank[sa[-1]] == n - 1:
            break
        k <<= 1
    return sa


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of `text` (uint8, values in [1, 255], caller has NOT
    appended a sentinel).  A unique smallest sentinel 0 is appended
    internally; the returned array has length len(text)+1 with sa[0] ==
    len(text) (the sentinel suffix)."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    if text.size and text.min() < 1:
        raise ValueError("text values must be >= 1 (0 is the sentinel)")
    n = text.size + 1
    s = np.empty(n, dtype=np.uint8)
    s[:-1] = text
    s[-1] = 0
    lib = _load_lib()
    if lib is not None:
        sa = np.empty(n, dtype=np.int64)
        k = int(s.max()) + 1
        rc = lib.kart_sais_u8(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n),
            ctypes.c_int64(k),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc == 0:
            return sa
    return _suffix_array_numpy(s)
