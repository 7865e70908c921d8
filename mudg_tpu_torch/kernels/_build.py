"""Build and load the port's CUDA kernels (`mudg_tpu_torch/csrc/*.cu`).

The sources are compiled with `nvcc` for `sm_90a` into one shared library
with a plain C interface, loaded with `ctypes`. The build runs at first use,
into `mudg_tpu_torch/_build/` (listed in `.gitignore`), and is keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points and their argument types: pointers and the stream as
# c_void_p (a c_int would cut a 64-bit pointer), sizes as c_int, element
# strides as c_longlong, eps as c_float
_SIGNATURES = {
    "mudg_spatial_attn": [_P] * 9 + [_I] * 3 + [_P],
    "mudg_temporal_attn_stage": [_P] * 9 + [_I] * 2 + [_P],
    "mudg_geglu_ff": [_P] * 10 + [_I] * 3 + [_P],
    "mudg_gn_silu_tconv": [_P] * 8 + [_I] * 6 + [_P],
    "mudg_flash_attn": [_P] * 5 + [_I] * 3 + [_LL] * 9 + [_P],
    "mudg_flash_attn_f32": [_P] * 5 + [_I] * 3 + [_LL] * 9 + [_P],
    "mudg_flash_attn_bwd": [_P] * 11 + [_I] * 3 + [_LL] * 9 + [_P],
    "mudg_flash_attn_bwd_f32": [_P] * 9 + [_I] * 3 + [_LL] * 9 + [_P],
    "mudg_temporal_attn_stage_bwd": [_P] * 21 + [_LL] + [_I] * 2 + [_P],
    "mudg_geglu_ff_bwd": [_P] * 15 + [_LL] + [_I] * 3 + [_P],
    "mudg_tile_composite": [_P] * 4 + [_I] * 3 + [_P],
    "mudg_tile_composite_bwd": [_P] * 6 + [_I] * 3 + [_P],
    "mudg_group_norm": [_P] * 5 + [_I] * 7 + [_F] + [_P],
    "mudg_layer_norm": [_P] * 4 + [_I] * 3 + [_F] + [_P],
    "mudg_short_kv_attn": [_P] * 4 + [_I] * 5 + [_LL] * 9 + [_P],
    "mudg_short_kv_attn_f32": [_P] * 4 + [_I] * 5 + [_LL] * 9 + [_P],
    "mudg_short_kv_tma": [_P] * 4 + [_I] * 5 + [_LL] * 9 + [_P],
    "mudg_packed_attn": [_P] * 4 + [_I] * 4 + [_LL] * 9 + [_P],
}
# fp32 scratch for the backward kernels' split partials (elements); the split
# counts shrink to fit it, so it bounds memory, never correctness
WORK_ELEMS = 1 << 23

_lib = None
build_seconds = 0.0   # wall time of the last build in this process (0: cached)


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every csrc/*.cu (in parallel) and link them; returns the .so.
    The compiler's register/spill report goes to _build/build.log."""
    global build_seconds
    lib = BUILD_DIR / f"libmudg_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    t0 = time.perf_counter()
    # objects go to a directory of this process, so that processes building
    # at the same time do not write each other's files; the .so is renamed
    # into place whole
    work = BUILD_DIR / f"work{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [work / (s.stem + ".o") for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s),
                               "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(sources, objs)]
    log = []
    failed = []
    for s, p in zip(sources, procs):
        out, _ = p.communicate()
        log.append(f"== {s.name}\n{out}")
        if p.returncode:
            failed.append(s.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log)[-6000:])
    tmp = work / lib.name
    r = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"link failed:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.mudg_error_string.argtypes = [ctypes.c_int]
        lib.mudg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        msg = _lib.mudg_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def require(t: torch.Tensor, name: str, dtype=torch.bfloat16) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, contiguous, and
    16-byte aligned (the kernels load 16-byte chunks)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
