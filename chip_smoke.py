#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``accl_tpu_torch``) on one H100.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order;
any failure exits non-zero and nothing is caught and skipped:

1. build the ring kernels from ``accl_tpu_torch/csrc`` with ``nvcc`` and
   print the build time, the card and its power limit;
2. hold every kernel against its plain PyTorch version on the card with
   ``torch.equal`` (P in {2, 8}, a ragged length, SUM and MAX, f32 / i32 /
   bf16, a bf16 and an int8 wire, both ring directions), then time each
   kernel, its plain version and a one-call PyTorch yardstick at the
   shapes of the main path;
3. the main path: ``ACCL(world=8)`` runs AUTO all-reduce, f32 SUM, from 4 B
   to 1 GiB per rank in powers of 4 with the payload generated and kept on
   the card; every size is checked against a float64 fold, and the launch
   counters must show the VMEM-range ring kernels for 1-4 MiB and the
   segmented ones above;
4. print the ``kernels`` line, the card line and, last, the device line.

Exits 2 without printing a result when no CUDA device is visible.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

GIB = 1 << 30
MIB = 1 << 20
#: H100 SXM device memory rate (bytes/s), NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Median device time of ``fn()`` in ms, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return statistics.median(samples)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def make(shape, dtype, gen):
    import torch
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check_kernels(gen) -> None:
    import torch
    from accl_tpu_torch.constants import reduceFunction as F
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr

    dts = (torch.float32, torch.int32, torch.bfloat16)
    wires = ((torch.bfloat16, None), (torch.int8, 10.0))
    L, C, S = 1000, 3, 1000          # ragged: no multiple of 128
    n = 0
    for P in (2, 8):
        for dt in dts:
            for func in (F.SUM, F.MAX):
                x = make((P, P, L), dt, gen)
                if not torch.equal(pr.ring_reduce_scatter(x, func),
                                   pr.plain_ring_reduce_scatter(x, func)):
                    fail(f"ring_rs_kernel != plain (P={P} {dt} {func.name})")
                for bidir in (False, True):
                    x = make((P, P, C, S), dt, gen)
                    got = pc.chunked_reduce_scatter(x, func, None, bidir)
                    want = pc.plain_chunked_reduce_scatter(x, func, None,
                                                           bidir)
                    if not torch.equal(got, want):
                        fail(f"chunked_rs_kernel != plain (P={P} {dt} "
                             f"{func.name} bidir={bidir})")
                n += 3
            b = make((P, L), dt, gen)
            if not torch.equal(pr.ring_allgather(b),
                               pr.plain_ring_allgather(b)):
                fail(f"ring_ag_kernel != plain (P={P} {dt})")
            for bidir in (False, True):
                b = make((P, C, S), dt, gen)
                if not torch.equal(pc.chunked_allgather(b, bidir),
                                   pc.plain_chunked_allgather(b, bidir)):
                    fail(f"chunked_ag_kernel != plain (P={P} {dt} "
                         f"bidir={bidir})")
            n += 3
        for wire in wires:
            x = make((P, P, L), torch.float32, gen) * 3
            if not torch.equal(pr.ring_reduce_scatter(x, F.SUM, wire),
                               pr.plain_ring_reduce_scatter(x, F.SUM, wire)):
                fail(f"ring_rs_kernel != plain (P={P} wire={wire})")
            x = make((P, P, C, S), torch.float32, gen) * 3
            if not torch.equal(
                    pc.chunked_reduce_scatter(x, F.SUM, wire, True),
                    pc.plain_chunked_reduce_scatter(x, F.SUM, wire, True)):
                fail(f"chunked_rs_kernel != plain (P={P} wire={wire})")
            n += 2
    torch.cuda.synchronize()
    log(f"phase 2: {n} kernel-vs-plain cases bit-equal (torch.equal)")


def measure_kernels(gen, big_ok: bool) -> dict:
    """Each kernel at its main-path shape (f32 SUM, P=8): the 4 MiB
    all-reduce for the VMEM-range pair, the 1 GiB one (or the largest that
    fits) for the segmented pair. Returns per-kernel measurements."""
    import torch
    from accl_tpu_torch.constants import reduceFunction as F
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr

    P = 8
    res = {}

    def ring_bytes(kind, x):
        """The ring schedule's own traffic (csrc/ring.cu) for f32 at P=8:
        per element of a chunk, the reduce-scatter moves (P+1) + (2P-2)
        words (seed, P-1 hops of upstream + local reads and a write), the
        all-gather 2P (seed and P-1 block copies)."""
        elems = x.numel() // P if kind == "rs" else x.numel()
        words = (P + 1) + (2 * P - 2) if kind == "rs" else 2 * P
        return elems * words * x.element_size()

    def record(name, got, want, x, out, fn_kernel, fn_plain, fn_lib, iters):
        err = (got.double() - want.double()).abs().max().item()
        if not torch.equal(got, want):
            fail(f"{name} != plain at the main-path shape {tuple(x.shape)}")
        nbytes = x.numel() * x.element_size() + out.numel() * \
            out.element_size()
        res[name] = {
            "shape": list(x.shape),
            "max_abs_err": err,
            "ms": time_ms(fn_kernel, iters),
            "plain_ms": time_ms(fn_plain, iters),
            "library_ms": time_ms(fn_lib, iters),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "ring_bound_ms": ring_bytes("rs" if "_rs_" in name else "ag",
                                        x) / HBM_BYTES_PER_S * 1e3,
        }
        log(f"  {name} {tuple(x.shape)}: kernel {res[name]['ms']!r} ms, "
            f"plain {res[name]['plain_ms']!r} ms, library "
            f"{res[name]['library_ms']!r} ms, bound "
            f"{res[name]['bound_ms']!r} ms, ring bound "
            f"{res[name]['ring_bound_ms']!r} ms, max_abs_err {err!r}")

    # VMEM-range pair at the 4 MiB all-reduce: chunk = 128 Ki elements
    L = (4 * MIB // 4) // P
    x = make((P, P, L), torch.float32, gen)
    got = pr.ring_reduce_scatter(x, F.SUM)
    record("ring_rs_kernel", got, pr.plain_ring_reduce_scatter(x, F.SUM), x,
           got, lambda: pr._launch_rs(0, x.view(P, P, 1, L), F.SUM, None,
                                      False),
           lambda: pr.plain_ring_reduce_scatter(x, F.SUM),
           lambda: x.view(P, P, -1).sum(0), 50)
    b = got
    got = pr.ring_allgather(b)
    record("ring_ag_kernel", got, pr.plain_ring_allgather(b), b, got,
           lambda: pr._launch_ag(0, b.view(P, 1, L), False),
           lambda: pr.plain_ring_allgather(b),
           lambda: b.repeat(P, 1, 1), 50)
    del x, b, got

    # segmented pair at the largest main-path all-reduce that fits
    per_rank = GIB if big_ok else 256 * MIB
    S = MIB // 4                          # 1 MiB segments of f32
    C = per_rank // 4 // P // S
    x = make((P, P, C, S), torch.float32, gen)
    got = pc.chunked_reduce_scatter(x, F.SUM, None, True)
    want = pc.plain_chunked_reduce_scatter(x, F.SUM, None, True)
    record("chunked_rs_kernel", got, want, x, got,
           lambda: pr._launch_rs(1, x, F.SUM, None, True),
           lambda: pc.plain_chunked_reduce_scatter(x, F.SUM, None, True),
           lambda: x.view(P, P, -1).sum(0), 3)
    del want, x
    torch.cuda.empty_cache()
    b = got
    got = pc.chunked_allgather(b, True)
    want = pc.plain_chunked_allgather(b, True)
    record("chunked_ag_kernel", got, want, b, got,
           lambda: pr._launch_ag(1, b, True),
           lambda: pc.plain_chunked_allgather(b, True),
           lambda: b.repeat(P, 1, 1, 1), 3)
    del b, got, want
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def counts():
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr
    return {"ring_rs_kernel": pr.ring_reduce_scatter.launches,
            "ring_ag_kernel": pr.ring_allgather.launches,
            "chunked_rs_kernel": pc.chunked_reduce_scatter.launches,
            "chunked_ag_kernel": pc.chunked_allgather.launches}


def reset_counts():
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr
    pr.ring_reduce_scatter.launches = 0
    pr.ring_allgather.launches = 0
    pc.chunked_reduce_scatter.launches = 0
    pc.chunked_allgather.launches = 0


def check_result(x, y, P: int) -> float:
    """Every rank's row equals rank 0's, and rank 0's is within the
    order-independent bound of the float64 fold:
    |y - sum| <= (P-1) * 2^-24 * sum|x| (each of the P-1 f32 adds rounds
    once, by at most half an ulp of a partial no larger than sum|x|).
    Returns the largest |y - sum| seen."""
    import torch
    for r in range(1, P):
        if not torch.equal(y[r], y[0]):
            fail(f"rank {r}'s result differs from rank 0's")
    worst = 0.0
    step = 1 << 24
    for lo in range(0, x.shape[1], step):
        xs = x[:, lo:lo + step].double()
        ref = xs.sum(0)
        bound = (P - 1) * 2.0 ** -24 * xs.abs().sum(0)
        err = (y[0, lo:lo + step].double() - ref).abs()
        if bool((err > bound).any()):
            fail(f"all-reduce result outside the f32 fold bound at columns "
                 f"{lo}..{lo + xs.shape[1]}")
        worst = max(worst, err.max().item())
    return worst


def main_path(gen) -> dict:
    import torch
    from accl_tpu_torch import ACCL, dataType, operation, reduceFunction
    from accl_tpu_torch.parallel import algorithms

    P = 8
    acc = ACCL(world=P)
    sizes = [4 * 4 ** i for i in range(15)]            # 4 B .. 1 GiB
    reset_counts()
    before = counts()
    for nbytes in sizes:
        count = nbytes // 4
        free, _ = torch.cuda.mem_get_info()
        # send + recv + the ring's padded grid, gathered and realigned
        # copies: about 5 world-sized f32 tensors live at once
        need = 5 * P * nbytes + 2 * GIB
        if need > free:
            log(f"main path: stopping before {nbytes} B per rank: needs "
                f"~{need / GIB:.1f} GiB, {free / GIB:.1f} GiB free")
            break
        send = acc.create_buffer(count, dataType.float32)
        recv = acc.create_buffer(count, dataType.float32)
        send.device_store(torch.randn((P, count), generator=gen,
                                      device="cuda"))
        c0 = counts()
        iters = 20 if nbytes <= 16 * MIB else (8 if nbytes <= 64 * MIB
                                               else 4)
        times = []
        for i in range(iters + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc.allreduce(send, recv, count, reduceFunction.SUM,
                          from_device=True, to_device=True)
            if i:
                times.append(time.perf_counter() - t0)
        c1 = counts()
        fired = {k: c1[k] - c0[k] for k in c1}
        algo = algorithms.select(operation.allreduce, nbytes, acc.comms[0],
                                 acc.config, count=count).value
        err = check_result(send.data, recv.data, P)
        ring = fired["ring_rs_kernel"] + fired["ring_ag_kernel"]
        seg = fired["chunked_rs_kernel"] + fired["chunked_ag_kernel"]
        if MIB <= nbytes <= 4 * MIB:
            ok = fired["ring_rs_kernel"] > 0 and fired["ring_ag_kernel"] > 0 \
                and seg == 0
        elif nbytes > 4 * MIB:
            ok = fired["chunked_rs_kernel"] > 0 and \
                fired["chunked_ag_kernel"] > 0 and ring == 0
        else:
            ok = ring == 0 and seg == 0
        if not ok:
            fail(f"{nbytes} B: unexpected kernel launches {fired} "
                 f"(algorithm {algo})")
        p50 = statistics.median(times)
        lib = "n/a"
        if count % P == 0:
            xv = send.data
            lib = f"{time_ms(lambda: xv.view(P, P, -1).sum(0), 10)!r} ms"
        log(f"allreduce {nbytes:>10} B/rank: algbw "
            f"{nbytes / p50 / 1e9!r} GB/s, p50 {p50 * 1e6!r} us, "
            f"algorithm {algo}, launches {json.dumps(fired)}, "
            f"max|err| {err!r}")
        log(f"  library yardstick x.view(P, P, -1).sum(0): {lib}")
        del send, recv
        torch.cuda.empty_cache()
    after = counts()
    return {k: after[k] - before[k] for k in after}


# ---------------------------------------------------------------------------

REPLACES = {
    "ring_rs_kernel": "accl_tpu/parallel/pallas_ring.py:330",
    "ring_ag_kernel": "accl_tpu/parallel/pallas_ring.py:194",
    "chunked_rs_kernel": "accl_tpu/parallel/pallas_chunked.py:82",
    "chunked_ag_kernel": "accl_tpu/parallel/pallas_chunked.py:275",
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from accl_tpu_torch import cuda_build

    # phase 1: build
    secs = cuda_build.build()
    cuda_build.load()
    log(f"phase 1: built {sorted(cuda_build.SOURCES)} in {secs:.1f} s")
    for name, out in cuda_build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  nvcc[{name}]: {line.strip()}")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {name}; nvidia-smi: {card}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    check_kernels(gen)
    total = torch.cuda.get_device_properties(0).total_memory
    meas = measure_kernels(gen, big_ok=total >= 60 * GIB)

    launches = main_path(gen)
    for k, v in launches.items():
        if v <= 0:
            fail(f"{k} was not launched on the main path")
    kernels = []
    for k in ("ring_rs_kernel", "ring_ag_kernel", "chunked_rs_kernel",
              "chunked_ag_kernel"):
        m = meas[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "accl_tpu_torch/csrc/ring.cu",
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": m["shape"], "ring_bound_ms": m["ring_bound_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
