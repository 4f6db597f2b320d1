"""Build and load the port's hand-written CUDA kernels (no JAX counterpart:
``accl_tpu`` compiles its Pallas kernels through XLA at trace time).

The sources under ``accl_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface, loaded with
``ctypes``. The build runs at first use, never at import, into
``accl_tpu_torch/_cuda_build/`` (listed in ``.gitignore``); a library is
named by the hash of its source, so an edited source rebuilds and an
unchanged one loads the library already built. Every source builds in its
own ``nvcc`` process, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_cuda_build"
#: sources, by library name
SOURCES = {"ring": SRC_DIR / "ring.cu", "plugins": SRC_DIR / "plugins.cu",
           "a2a": SRC_DIR / "a2a.cu", "cmatmul": SRC_DIR / "cmatmul.cu",
           "flash": SRC_DIR / "flash.cu", "decode": SRC_DIR / "decode.cu",
           "pipeline": SRC_DIR / "pipeline.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's report (registers, spills) of the builds this process ran
build_log: Dict[str, str] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's usual
    place, else whatever ``nvcc`` is on the PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libaccl_{name}_{digest}.so"


def build(names=None) -> float:
    """Compile every named source that has no library yet, one ``nvcc``
    each, in parallel. Returns the seconds spent; raises with the
    compiler's output when a build fails."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str = "ring") -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _DECLARE[name](lib)
        lib.accl_error_string = getattr(lib, f"accl_{name}_error_string")
        lib.accl_error_string.argtypes = [ctypes.c_int]
        lib.accl_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _declare_ring(lib: ctypes.CDLL) -> None:
    c_int, c_ll, c_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.accl_ring_capacity.argtypes = [c_int, c_int, c_int, c_int,
                                       ctypes.POINTER(c_int)]
    lib.accl_ring_capacity.restype = c_int
    lib.accl_ring_threads.argtypes = []
    lib.accl_ring_threads.restype = c_int
    lib.accl_ring_rs_fold.argtypes = [c_int, c_int, u64p, u64p, c_int, c_ll,
                                      c_int, ctypes.c_float, c_p]
    lib.accl_ring_rs_fold.restype = c_int
    lib.accl_ring_rs.argtypes = [c_int, c_int, u64p, u64p, u64p, c_p, c_int,
                                 c_int, c_ll, c_int, c_int, c_int, c_int,
                                 ctypes.c_float, ctypes.c_double, c_p]
    lib.accl_ring_rs.restype = c_int
    lib.accl_ring_ag.argtypes = [c_int, c_int, u64p, u64p, c_p, c_int, c_int,
                                 c_ll, c_int, c_int, c_int, ctypes.c_double,
                                 c_p]
    lib.accl_ring_ag.restype = c_int
    lib.accl_ring_relay.argtypes = [c_int, u64p, u64p, c_p, c_int, c_int,
                                    c_ll, c_int, c_int, ctypes.c_double, c_p]
    lib.accl_ring_relay.restype = c_int
    lib.accl_ring_scatter.argtypes = [c_int, c_p, u64p, c_int, c_ll, c_int,
                                      c_p]
    lib.accl_ring_scatter.restype = c_int
    lib.accl_ring_gather.argtypes = [c_int, u64p, c_p, c_int, c_ll, c_int,
                                     c_p]
    lib.accl_ring_gather.restype = c_int
    lib.accl_ring_alltoall.argtypes = [c_int, u64p, u64p, c_int, c_ll, c_p]
    lib.accl_ring_alltoall.restype = c_int


def _declare_plugins(lib: ctypes.CDLL) -> None:
    c_int, c_ll, c_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.accl_plugins_combine.argtypes = [c_int, c_int, c_p, c_p, c_p, c_ll,
                                         c_p]
    lib.accl_plugins_combine.restype = c_int
    lib.accl_plugins_cast.argtypes = [c_int, c_int, c_p, c_p, c_ll, c_p]
    lib.accl_plugins_cast.restype = c_int
    lib.accl_plugins_sr.argtypes = [c_p, c_p, c_p, c_int, c_ll, c_ll, c_p]
    lib.accl_plugins_sr.restype = c_int


def _declare_a2a(lib: ctypes.CDLL) -> None:
    c_int, c_p = ctypes.c_int, ctypes.c_void_p
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.accl_a2a_mm.argtypes = [c_int, c_int, c_int, c_int, u64p, u64p, u64p,
                                c_int, c_int, c_int, c_int, c_int, c_p]
    lib.accl_a2a_mm.restype = c_int
    lib.accl_a2a_wgrad.argtypes = [c_int, c_int, c_int, u64p, u64p, u64p,
                                   c_int, c_int, c_int, c_int, c_int, c_int,
                                   c_p]
    lib.accl_a2a_wgrad.restype = c_int


def _declare_cmatmul(lib: ctypes.CDLL) -> None:
    c_int, c_p = ctypes.c_int, ctypes.c_void_p
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.accl_cmatmul_agmm.argtypes = [c_int, c_int, u64p, u64p, u64p, c_int,
                                      c_int, c_int, c_int, c_int, c_int,
                                      c_int, c_p]
    lib.accl_cmatmul_agmm.restype = c_int
    lib.accl_cmatmul_mmrs.argtypes = [c_int, c_int, c_int, u64p, u64p, u64p,
                                      c_int, c_int, c_int, c_int, c_int,
                                      c_int, c_int, c_p]
    lib.accl_cmatmul_mmrs.restype = c_int
    lib.accl_cmatmul_wgrad.argtypes = [c_int, c_int, c_int, u64p, u64p, u64p,
                                       c_int, c_int, c_int, c_int, c_int,
                                       c_int, c_int, c_p]
    lib.accl_cmatmul_wgrad.restype = c_int


def _declare_flash(lib: ctypes.CDLL) -> None:
    c_int, c_p, c_f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.accl_flash_fwd.argtypes = [c_int, c_int, c_p, c_p, c_p, c_p, c_p,
                                   c_int, c_int, c_int, c_int, c_int, c_f,
                                   c_p]
    lib.accl_flash_fwd.restype = c_int
    lib.accl_flash_bwd_fused.argtypes = [c_int, c_int, *[c_p] * 9, c_int,
                                         c_int, c_int, c_int, c_int, c_f,
                                         c_f, c_int, c_int, c_p]
    lib.accl_flash_bwd_fused.restype = c_int
    lib.accl_flash_bwd_kv.argtypes = [c_int, c_int, *[c_p] * 8, c_int,
                                      c_int, c_int, c_int, c_int, c_f, c_f,
                                      c_p]
    lib.accl_flash_bwd_kv.restype = c_int
    lib.accl_flash_bwd_q.argtypes = [c_int, c_int, *[c_p] * 7, c_int, c_int,
                                     c_int, c_int, c_int, c_f, c_f, c_p]
    lib.accl_flash_bwd_q.restype = c_int
    lib.accl_flash_dq_reduce.argtypes = [c_p, c_p, c_int, c_int, c_int,
                                         c_int, c_int, c_int, c_p]
    lib.accl_flash_dq_reduce.restype = c_int
    lib.accl_flash_fwd_packed.argtypes = [c_int, *[c_p] * 5, c_int, c_int,
                                          c_int, c_f, c_p]
    lib.accl_flash_fwd_packed.restype = c_int
    lib.accl_flash_bwd_fused_packed.argtypes = [c_int, *[c_p] * 9, c_int,
                                                c_int, c_int, c_f, c_f,
                                                c_int, c_int, c_p]
    lib.accl_flash_bwd_fused_packed.restype = c_int
    lib.accl_flash_bwd_kv_packed.argtypes = [c_int, *[c_p] * 8, c_int,
                                             c_int, c_int, c_f, c_f, c_p]
    lib.accl_flash_bwd_kv_packed.restype = c_int
    lib.accl_flash_bwd_q_packed.argtypes = [c_int, *[c_p] * 7, c_int, c_int,
                                            c_int, c_f, c_f, c_p]
    lib.accl_flash_bwd_q_packed.restype = c_int


def _declare_decode(lib: ctypes.CDLL) -> None:
    c_int, c_p, c_f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    for fn in (lib.accl_decode_paged, lib.accl_decode_span):
        fn.argtypes = [c_int, c_int, *[c_p] * 7, *[c_int] * 8, c_f, c_f,
                       c_p]
        fn.restype = c_int


def _declare_pipeline(lib: ctypes.CDLL) -> None:
    c_int, c_ll, c_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.accl_pipeline_relay.argtypes = [u64p, u64p, u64p, u64p, c_int, c_int,
                                        c_ll, c_ll, c_int, c_p]
    lib.accl_pipeline_relay.restype = c_int


_DECLARE = {"ring": _declare_ring, "plugins": _declare_plugins,
            "a2a": _declare_a2a, "cmatmul": _declare_cmatmul,
            "flash": _declare_flash, "decode": _declare_decode,
            "pipeline": _declare_pipeline}


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.accl_error_string(rc)
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({msg.decode() if msg else '?'})")


def pointer_table(rows) -> ctypes.Array:
    """Per-rank pointer table (``uint64_t[P]``) of a tensor's rows, from
    its base address and row stride (no per-row tensor views)."""
    base, step = rows.data_ptr(), rows.stride(0) * rows.element_size()
    return (ctypes.c_uint64 * rows.shape[0])(
        *(base + r * step for r in range(rows.shape[0])))


def stream_handle(device) -> Optional[int]:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
