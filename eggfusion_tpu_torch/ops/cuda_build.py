"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/eggfusion_tpu_torch/<name>-<hash>.so` at the
repository root, keyed by a hash of the source, the shared headers
(`csrc/*.cuh`), the flags and any preprocessor defines, then loaded with
ctypes. Nothing is built or loaded at import time: the first wrapper call
on a CUDA tensor builds what it needs; `build()` starts several `nvcc`
processes at once and waits for all of them. A build with `NO_CULL`
defined drops the kernels' row cull; the checks compare it with the
wrappers' build, and nothing else launches it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "eggfusion_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NO_CULL = ("EGG_NO_CULL",)

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # counts, intr, entries, rgb, nrm, dep, opa, T, n_tiles, tx_tiles, cap, geom, stream
    "composite_fwd": ("egg_composite_fwd", [_P] * 8 + [_I] * 4 + [_P]),
    # counts, intr, entries, g_rgb, g_nrm, g_dep, g_opa, g_T, T_fin, d_entries,
    # n_tiles, tx_tiles, cap, stream
    "composite_bwd": ("egg_composite_bwd", [_P] * 10 + [_I] * 3 + [_P]),
}
# resident blocks per SM of each kernel, by cap (and geom for the forward)
BLOCKS_PER_SM = {
    "composite_fwd": ("egg_composite_fwd_blocks_per_sm", [_I, _I]),
    "composite_bwd": ("egg_composite_bwd_blocks_per_sm", [_I]),
}

_libs: dict[tuple, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's nvcc")


def _flags(defines) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def target(name: str, defines=()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=tuple(SIGNATURES), variants=((),)) -> dict:
    """Compile every library of `names`, once per tuple of defines in
    `variants`, that is not built yet, all `nvcc` processes at once.
    Returns {(name, defines): {"seconds": s, "log": ptxas report}}; raises
    with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        for defines in variants:
            out = target(name, defines)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs[(name, tuple(defines))] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` built with `defines`,
    building it if needed."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build((name,), (key[1],))
            lib = ctypes.CDLL(str(target(name, key[1])))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            occ_name, occ_args = BLOCKS_PER_SM[name]
            getattr(lib, occ_name).argtypes = occ_args
            getattr(lib, occ_name).restype = ctypes.c_int
            lib.egg_error_string.argtypes = [ctypes.c_int]
            lib.egg_error_string.restype = ctypes.c_char_p
            _libs[key] = lib
        return lib


def blocks_per_sm(name: str, *args: int) -> int:
    """Resident blocks per SM of kernel `name` (cudaOccupancy query; the
    forward takes (cap, geom), the backward (cap))."""
    return getattr(load(name), BLOCKS_PER_SM[name][0])(*args)


def error_string(err: int) -> str:
    lib = next(iter(_libs.values()))
    return f"{err} ({lib.egg_error_string(err).decode()})"
