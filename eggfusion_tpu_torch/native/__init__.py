"""Host C++ components of the repository, loaded through ctypes (port of
`eggfusion_tpu/native/__init__.py`).

`load(name)` compiles `<name>.cpp` — the port's own, beside this file, or
else the repository's `native/<name>.cpp` — with g++ at first use into
`build/eggfusion_tpu_torch/native/` and loads it. The library is
built for the host CPU (`-march=native`), so its file name carries a hash of
the source, the flags and the CPU features g++ resolves for this host: a
library built on one machine is never loaded on another. An exclusive file
lock serializes builds across processes (parallel test workers). A failed
build raises `NativeCompileError`.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIRS = (Path(__file__).resolve().parent, Path(__file__).resolve().parents[2] / "native")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "eggfusion_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class NativeCompileError(RuntimeError):
    pass


def _host_target() -> bytes:
    """g++'s resolved target options for `-march=native` on this host."""
    try:
        return subprocess.run(["g++", "-march=native", "-Q", "--help=target"], check=True,
                              capture_output=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise NativeCompileError(f"g++ is needed to build the native libraries: {e}") from e


def source(name: str) -> Path:
    for d in SRC_DIRS:
        if (d / f"{name}.cpp").exists():
            return d / f"{name}.cpp"
    raise NativeCompileError(f"missing native source {name}.cpp in {[str(d) for d in SRC_DIRS]}")


def target(name: str) -> Path:
    src = source(name)
    key = src.read_bytes() + " ".join(CXX_FLAGS).encode() + _host_target()
    return BUILD_DIR / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load `native/<name>.cpp`."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = target(name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(source(name)), "-pthread"]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise NativeCompileError(f"g++ failed for {name}:\n{proc.stderr}")
                os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
