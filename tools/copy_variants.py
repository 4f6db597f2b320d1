#!/usr/bin/env python3
"""Time variants of the one-hop scatter and gather copies on one H100.

Run from the repository root: ``python3 tools/copy_variants.py``. It builds
``accl_tpu_torch/csrc/ring.cu`` as committed and two variants of its copy
loop (``copy_block``), made by substituting text in the source:

* ``one_pass`` -- the committed kernels: one 16-byte access per thread, a
  grid that covers each block once;
* ``one_pass_hints`` -- the same with streaming cache hints (``__ldcs``,
  ``__stcs``: ld.global.cs and st.global.cs);
* ``persistent_u4`` -- a persistent grid (the resident CTAs of the card,
  shared among the launch's blocks) in a grid-stride loop that keeps four
  16-byte loads in flight per thread before it stores them.

Each variant is first held against the plain copies by bits (P 3 and 8,
roots 0 and P-1, int8 / bf16 / f32 / int64, S 777 and 1024), then the
scatter (x (8, 8, 128, 262144) f32, root 3) and the gather (x (8, 128,
262144) f32) are timed with the host's launch work hidden behind a queued
device sleep (``chip_smoke.time_queued_ms``), in turns (every variant,
then every variant again in reverse order), beside PyTorch's copies of the
same P-1 blocks (``copy_``, which runs cudaMemcpy) and of all P blocks
(``clone``). Prints one JSON object with the card, its power limit and the
median ms of each pass; exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOOP = "    for (long long i = tid; i < nv; i += stride) d[i] = s[i];\n"
HINTS = ("    for (long long i = tid; i < nv; i += stride) "
         "__stcs(d + i, __ldcs(s + i));\n")
UNROLLED = """    long long i = tid;
    for (; i + 3 * stride < nv; i += 4 * stride) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = s[i + u * stride];
#pragma unroll
      for (int u = 0; u < 4; ++u) d[i + u * stride] = v[u];
    }
    for (; i < nv; i += stride) d[i] = s[i];
"""
GRID = "  const long long bx = (vec + ACCL_THREADS - 1) / ACCL_THREADS;\n"
PERSISTENT = """  int cap = 0;
  if (capacity(fn, &cap) != cudaSuccess) return cudaErrorInvalidValue;
  const long long want = (vec + ACCL_THREADS - 1) / ACCL_THREADS;
  const long long fill = cap / (gy * gz) > 1 ? cap / (gy * gz) : 1;
  const long long bx = want < fill ? want : fill;
"""


def sources(src: str) -> dict:
    for piece in (LOOP, GRID):
        if piece not in src:
            sys.exit(f"copy_variants: ring.cu no longer holds {piece!r}")
    return {"one_pass": src,
            "one_pass_hints": src.replace(LOOP, HINTS),
            "persistent_u4": src.replace(LOOP, UNROLLED).replace(
                GRID, PERSISTENT)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("copy_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, time_queued_ms
    from accl_tpu_torch import cuda_build

    out_dir = os.path.join(ROOT, "accl_tpu_torch", "_cuda_build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(cuda_build.SOURCES["ring"]) as f:
        variants = sources(f.read())
    procs = {}
    for name, text in variants.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"copy_variants: {name} failed to build\n{log}",
                  file=sys.stderr)
            return 1
        lib = ctypes.CDLL(so)
        cuda_build._declare_ring(lib)
        libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream
    table = cuda_build.pointer_table

    def scatter(lib, x, out, root):
        rc = lib.accl_ring_scatter(x.element_size(), x[root].data_ptr(),
                                   table(out), x.shape[0], out[0].numel(),
                                   root, stream)
        if rc:
            raise RuntimeError(f"accl_ring_scatter: CUDA error {rc}")

    def gather(lib, x, out, root):
        rc = lib.accl_ring_gather(x.element_size(), table(x),
                                  out.data_ptr(), x.shape[0], x[0].numel(),
                                  root, stream)
        if rc:
            raise RuntimeError(f"accl_ring_gather: CUDA error {rc}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    for name, lib in libs.items():
        for P in (3, 8):
            for dt in (torch.int8, torch.bfloat16, torch.float32,
                       torch.int64):
                for S in (777, 1024):
                    xs = (torch.randn((P, P, 3, S), generator=gen,
                                      device="cuda") * 50).to(dt)
                    for root in (0, P - 1):
                        keep = [r for r in range(P) if r != root]
                        o = torch.zeros((P, 3, S), dtype=dt, device="cuda")
                        scatter(lib, xs, o, root)
                        g = torch.zeros_like(o)
                        gather(lib, xs[1], g, root)
                        if not (torch.equal(o[keep], xs[root][keep]) and
                                torch.equal(g[keep], xs[1][keep])):
                            print(f"copy_variants: {name} wrong at P {P} "
                                  f"{dt} S {S} root {root}", file=sys.stderr)
                            return 1

    P, root, S = 8, 3, (1 << 20) // 4
    blk = (1 << 30) // P // 4 // S
    xs = torch.randn((P, P, blk, S), generator=gen, device="cuda")
    xg = torch.randn((P, blk, S), generator=gen, device="cuda")
    out = torch.empty((P, blk, S), device="cuda")

    def copy_blocks(src):
        out[:root] = src[:root]
        out[root + 1:] = src[root + 1:]

    fns = {}
    for name, lib in libs.items():
        fns[f"{name} scatter"] = (lambda lib=lib: scatter(lib, xs, out, root))
        fns[f"{name} gather"] = (lambda lib=lib: gather(lib, xg, out, root))
    fns["copy_ of P-1 blocks (scatter)"] = lambda: copy_blocks(xs[root])
    fns["copy_ of P-1 blocks (gather)"] = lambda: copy_blocks(xg)
    fns["clone of P blocks"] = lambda: xg.clone()
    ms = {k: [] for k in fns}
    for order in (list(fns), list(reversed(fns))):
        for k in order:
            ms[k].append(time_queued_ms(fns[k], 20))
    bound = 2 * (P - 1) * blk * S * 4 / 3.35e12 * 1e3
    print(json.dumps({"card": card_line(), "shape_scatter": list(xs.shape),
                      "shape_gather": list(xg.shape), "bound_ms": bound,
                      "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
