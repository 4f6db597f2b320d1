#!/usr/bin/env python3
"""Time the all-reduce's VMEM-range reduce-scatter kernel and the all-to-all
kernel of one tree of the port on one H100 (rows 4 and 10 of ``PERF.md``'s
kernel table), and the host calls that run them.

Run from the repository root: ``python3 tools/ring_turns.py [--tree DIR]
[--label NAME]``. ``DIR`` (default: this repository) is the root of the
checkout whose ``accl_tpu_torch`` is measured, for instance an older commit
unpacked with ``git archive``, so that two trees are compared in one call on
one card (run parent, change, change, parent). Only the wrappers' stable API
is called: ``ring_reduce_scatter``, ``ring_allgather``,
``chunked_alltoall``, ``ACCL.allreduce`` and ``ACCL.alltoall``, each kernel
wrapper with an ``errors`` list so that no wrapper reads its error word
(which would wait for the launch).

Figures, all f32 at world 8:

* ``ring_reduce_scatter`` at (8, 8, 131072), the chunk grid of the 4 MiB
  all-reduce, and at (8, 8, 1024), next to no work, which sizes a launch's
  fixed cost; ``ring_allgather`` at (8, 131072); each in turns with its
  plain version and its library call (a sum over the rank axis; a repeat)
  by ``chip_smoke.time_in_turns``, the host's launch work hidden;
* ``chunked_alltoall`` at (8, 8, 128, 262144), 1 GiB per rank, in turns
  with its plain version and a transposing copy;
* the host p50 (``chip_smoke.p50_call``) of AUTO all-reduce at 1 MiB and 4
  MiB per rank, and of all-to-all at 64 MiB per rank (AUTO, which resolves
  PALLAS there, and XLA) and 1 GiB per rank (AUTO), with the peak memory the
  1 GiB call allocates beyond its send and receive buffers.

Each kernel's result is held against its plain version by bits before it
is timed. Prints one JSON object (label, tree, card line, figures) as its
last line; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB, GIB = 1 << 20, 1 << 30


def smoke():
    """This repository's ``chip_smoke`` module, whichever tree is measured."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ring_turns: no CUDA device visible", file=sys.stderr)
        return 2
    cs = smoke()
    sys.path.insert(0, os.path.abspath(args.tree))
    import accl_tpu_torch
    from accl_tpu_torch import ACCL, Algorithm, dataType, reduceFunction
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr
    pkg = os.path.dirname(os.path.abspath(accl_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(args.tree):
        cs.fail(f"imported accl_tpu_torch from {pkg}, not from {args.tree}")
    card = cs.card_line()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    P, SUM = 8, reduceFunction.SUM
    res = {"label": args.label, "tree": os.path.abspath(args.tree),
           "card": card}

    def turns(name, fns, iters, got=None, want=None):
        if got is not None and not cs.same_bits(got, want):
            cs.fail(f"{args.label}: {name} != plain")
        ms = cs.time_in_turns(fns, iters)
        res[name] = {"ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2]}
        cs.log(f"{args.label}: {name}: kernel {ms[0]!r} ms, plain {ms[1]!r} "
               f"ms, library {ms[2]!r} ms")

    for L in (131072, 1024):
        x = torch.randn((P, P, L), generator=gen, device="cuda")
        turns(f"ring_reduce_scatter (8, 8, {L})",
              [lambda: pr.ring_reduce_scatter(x, SUM, None, []),
               lambda: pr.plain_ring_reduce_scatter(x, SUM),
               lambda: x.sum(0)], 50,
              pr.ring_reduce_scatter(x, SUM, None, []),
              pr.plain_ring_reduce_scatter(x, SUM))
    b = torch.randn((P, 131072), generator=gen, device="cuda")
    turns("ring_allgather (8, 131072)",
          [lambda: pr.ring_allgather(b, []),
           lambda: pr.plain_ring_allgather(b),
           lambda: b.repeat(P, 1, 1)], 50,
          pr.ring_allgather(b, []), pr.plain_ring_allgather(b))
    del x, b

    S = MIB // 4
    x = torch.randn((P, P, 128, S), generator=gen, device="cuda")
    off = ~torch.eye(P, dtype=torch.bool, device="cuda")
    got, want = pc.chunked_alltoall(x, []), pc.plain_chunked_alltoall(x)
    for r in range(P):                    # row by row: 1 GiB rows
        if not cs.same_bits(got[r][off[r]], want[r][off[r]]):
            cs.fail(f"{args.label}: chunked_alltoall != plain (row {r})")
    del got, want
    torch.cuda.empty_cache()
    turns("chunked_alltoall (8, 8, 128, 262144)",
          [lambda: pc.chunked_alltoall(x, []),
           lambda: pc.plain_chunked_alltoall(x),
           lambda: x.view(P, P, -1).transpose(0, 1).contiguous()], 5)
    del x
    torch.cuda.empty_cache()

    acc = ACCL(world=P)
    f32 = dataType.float32
    for nbytes in (MIB, 4 * MIB):
        count = nbytes // 4
        s, r = acc.create_buffer(count, f32), acc.create_buffer(count, f32)
        s.device_store(torch.randn((P, count), generator=gen, device="cuda"))
        p50 = cs.p50_call(lambda: acc.allreduce(
            s, r, count, SUM, from_device=True, to_device=True), 20)
        cs.check_result(s.data, r.data, P)
        res[f"allreduce {nbytes} B/rank p50 us"] = p50 * 1e6
        cs.log(f"{args.label}: allreduce {nbytes} B/rank: p50 {p50 * 1e6!r} us")
        del s, r
    for nbytes, algo, iters in ((64 * MIB, None, 10),
                                (64 * MIB, Algorithm.XLA, 10),
                                (GIB, None, 3)):
        count = nbytes // 4 // P
        s = acc.create_buffer(count * P, f32)
        s.device_store(torch.randn((P, count * P), generator=gen,
                                   device="cuda"))
        r = acc.create_buffer(count * P, f32)
        kw = {"from_device": True, "to_device": True}
        if algo is not None:
            kw["algorithm"] = algo
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        p50 = cs.p50_call(lambda: acc.alltoall(s, r, count, **kw), iters)
        extra = torch.cuda.max_memory_allocated() - held
        if not torch.equal(r.data.view(P, P, count),
                           s.data.view(P, P, count).transpose(0, 1)):
            cs.fail(f"{args.label}: alltoall {nbytes} B/rank wrong")
        name = f"alltoall {nbytes} B/rank {algo.value if algo else 'auto'}"
        res[name] = {"p50_us": p50 * 1e6, "peak_extra_bytes": extra}
        cs.log(f"{args.label}: {name}: p50 {p50 * 1e6!r} us, peak allocation "
               f"beyond the buffers {extra} B")
        del s, r
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
