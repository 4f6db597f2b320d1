#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``accl_tpu_torch``) on one H100.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order;
any failure exits non-zero and nothing is caught and skipped:

1. build the kernels from ``accl_tpu_torch/csrc`` (``ring.cu``,
   ``plugins.cu``, ``a2a.cu``, ``cmatmul.cu``, ``flash.cu``, ``decode.cu``
   and ``pipeline.cu``, one ``nvcc`` each, in parallel) and print the build
   time, the card and its power limit;
2. hold every kernel against its plain PyTorch version on the card, bit
   for bit (``torch.equal``, or the raw bits where NaN can occur): the
   reduce-scatter fold (P in {2, 3, 8}, lengths 1000, 1024 and 777, SUM and
   MAX, f32 / i32 / bf16, the bf16, f16 and int8 wires, MAX on +-0 / NaN)
   and the three ring kernels (P in {2, 8}, a ragged length, SUM and MAX,
   f32 / i32 / bf16, a bf16 and an int8 wire, both ring directions, MAX on
   +-0 / NaN),
   the three plugin kernels (combine in f32 / bf16 / f16 / i32, SUM and
   MAX, with and without donate; the four casts; stochastic rounding with
   three seeds and per-row seeds; NaN, +-0, inf, subnormal and overflow
   cases), the bcast relay (P in {2, 8}, roots 0, P-1 and a middle rank,
   one and three segments of a ragged length, 1-, 2- and 4-byte elements
   with NaN and +-0), the one-hop scatter and gather (the same cases at
   lengths 1000, 1024 and 777, so that blocks take the 16-byte path, its
   element tail and the element path, and 8-byte elements), the
   all-to-all (P in {2, 3, 8}, one and three segments of lengths 1000,
   1024 and 777, 1-, 2-, 4- and 8-byte elements with NaN and +-0, by bits) and the fused MoE dispatch and combine (worlds 2, 3 and 8,
   bidirectional on and off, an aligned and an uneven shape, f32 and bf16
   wires: integer-valued operands bit-equal, random ones within the f32
   summation bound, with TF32 off for the plain versions) with their
   a2a-wgrad (both orientations, one and two channels), and the
   collective matmuls' all-gather x matmul and matmul x reduce-scatter
   (worlds 2, 3 and 8, bidirectional on and off, aligned, ragged,
   tile-straddling, unaligned and small-k shapes, resident, k-blocked and
   accumulator-blocked plans, f32, bf16, f16 and mixed operands, f32 and a
   bf16 wire: integer operands bit-equal, random ones within the f32
   summation bound) with their gathered wgrad (the same worlds, channels,
   shapes and operand types, resident and streaming plans, both
   orientations, f32 and a bf16 wire), and the four flash attention
   kernels (f32 and bf16, causal and not, d 64 / 96 / 128, H = H_kv and
   H = 4 H_kv, S 128, 1024 and 8192: f32 within 1e-5 and bf16 within 1e-2
   of each tensor's largest magnitude, every backward bit-equal over two
   runs and between the fused and the two-pass arm; the entry points under
   both backward modes, with and without an lse cotangent, at S 1024 and
   at S 16384, where the JAX backward policy sends the fused mode to the
   two-pass pair), the four kernels of its head-packed d 64 arm (f32 and
   bf16, causal and not, H 2, 4 and 96, S 128, 1024 and 2048: the same
   limits, and bit-equal to the general kernels on the unpacked heads;
   ``flash_attention_packed`` under both backward modes at S 1024 and at
   S 16384 causal, where the policy sends the fused mode to the packed
   two-pass pair), and the two paged decode kernels at K-EXAONE-236B's
   global-attention width (f32, bf16 and int8 pools, int8 with per-page
   scales, lengths 0, one page and full capacity, prefill chunks from 0,
   mid-chain and to full capacity: within 1e-5 of the largest magnitude),
   and the pipeline relay by bits (P in {2, 3, 8}, one and two lanes, one
   element, one segment, a ragged three-segment length and (512, 3072);
   f32, bf16, int32 and int8 with NaN and +-0), then time each kernel,
   its plain version and a one-call PyTorch yardstick at the shapes of the
   main path (for attention
   ``scaled_dot_product_attention``, timed only; for the relay two
   ``torch.roll``s, timed with the host dispatch hidden behind a queued
   device sleep);
3. the main path, each part with every launch counter set to 0 just
   before it and read just after:
   a. ``ACCL(world=8)`` runs AUTO all-reduce, f32 SUM, from 4 B to 1 GiB
      per rank in powers of 4 with the payload generated and kept on the
      card; every size is checked against a float64 fold, and the launch
      counters must show the VMEM-range pair (the reduce-scatter fold and
      the all-gather ring) for 1-4 MiB and the segmented rings above;
   b. the families and primitives of slice 2 at world 8: ``combine`` SUM
      and MAX and ``copy`` at 256 MiB per rank, AUTO reduce-scatter at 4
      and 6 MiB (the RING window), explicit RING / TREE / HIERARCHICAL
      all-reduce at 64 MiB per rank, and explicit TWOTIER all-reduce,
      reduce-scatter and all-gather at 4, 64 and 256 MiB per rank with the
      DCN wire "off", "bf16" and "bf16_sr"; every result is checked
      against a float64 fold, and the counters must show the combine,
      cast and stochastic-round kernels;
   c. the rooted collectives at world 8: AUTO ``bcast``, ``scatter``,
      ``gather`` and ``reduce`` (f32 SUM) over a size ladder (4 B, 64 KiB,
      4 MiB, 16 MiB and the full size: 1 GiB per rank for bcast and
      reduce, the root's 1 GiB for scatter, 128 MiB per rank for gather),
      where the counters must show the rooted kernels (and the segmented
      reduce-scatter for reduce) from 8 MiB up and none below, and every
      gather prints the peak memory it allocated beyond its buffers; explicit
      XLA / FLAT / TREE / RING at 64 MiB per rank wherever the op has the
      family; a bf16 wire through PALLAS bcast and reduce at 64 MiB.
      Bcast, scatter and gather are checked exactly, reduce against the
      f32 fold bound (plus the bf16 wire's roundings), and every non-root
      receive row must keep its pre-filled pattern; ``barrier`` closes it;
   d. ``ACCL.alltoall`` at world 8: AUTO over per-rank send buffers of 4 B
      to 1 GiB in powers of 4 (at least one f32 element per destination),
      where the counters must show ``alltoall_copy_kernel`` exactly where
      AUTO resolves PALLAS (from 8 MiB per destination); explicit XLA, FLAT
      and PALLAS at 64 MiB per rank, and PALLAS with a bf16 wire; every
      result exact (the bf16 wire: the nearest bf16, a rank's own chunk
      exact); every call prints the peak memory it allocated beyond its
      buffers;
   e. the MoE forward at the full width of Switch-Base-8 (d_model 768,
      d_ff 3072, 8 experts, top-1, ReLU), world 8, 2048 tokens per rank,
      capacity 320: the fused path (both MoE kernels must launch) and the
      unfused baseline, checked against each other and a float64
      reference; then the fused dispatch against the unfused pair at the
      repository's lane shape (e_local 2, C 128, d 256, h 512);
   f. the tensor-parallel MLP forward at Megatron-LM 8.3B's block width
      (hidden 3072, FFN 12288, GELU, biases), world 8 as (dp 1, tp 8),
      2048 tokens, f32: the fused path (the stream plans: agmm_kernel once
      and mmrs_kernel twice per forward) and the psum baseline (no
      kernel), checked against each other (rtol 1e-5, atol 1e-5) and a
      float64 forward (rtol 1e-5, atol 1e-4), p50 and tokens/s of each;
      then the fused collective
      matmuls against the unfused pair at the lane shape (m 256, k 512,
      n 512; the resident plans);
   g. the Megatron MLP train step at the same width, (dp 1, tp 8), 2048
      tokens, f32, SGD: the fused step (per step agmm_kernel 2, mmrs_kernel
      2 and wgrad_kernel 8 launches, as the ported plans give) and the psum
      baseline (none); loss, gradients and new parameters fused against
      baseline and both against a float64 step; p50 and tokens/s of each;
   h. the Switch-Base-8 MoE layer forward and backward at the width of
      phase e, tokens requiring grad: the fused path (a2a_mm_kernel,
      mm_a2a_kernel and a2a_wgrad_kernel twice each) and the baseline
      (none); output and the gradients of router, w_in, w_out and tokens
      fused against baseline and both against float64; p50 of each;
   i. context-parallel attention at Megatron-LM 8.3B's attention width (32
      heads of 96, causal), world 8, a global sequence of 8192 tokens:
      Ulysses with ``use_flash`` True against False in f32 and bf16 (the
      flash arm's forward launches flash_fwd_kernel once, its backward
      flash_bwd_fused_kernel, the plain arm nothing; flash against plain,
      and in f32 against float64 on two heads; p50 and tokens/s), the
      two-pass arm through ``ACCLConfig.flash_bwd`` and at 16384 tokens
      (flash_bwd_kv_kernel and flash_bwd_q_kernel), and ring and zigzag
      ring attention at (8, 1024, 96), both arms, forward and backward;
   j. a serving session at K-EXAONE-236B's global-attention width (hidden
      6144, 64 query heads over 8 KV heads of 128), tp 8, f32, 32 slots of
      8192 tokens in pages of 64: prompts of 512-4096 tokens prefilled in
      the plan's 448-token chunks, 32 decode steps, two slots retired and
      one admitted mid-run, paged and unpaged arms (flash_decode_kernel once
      a decode step, flash_decode_span_kernel once a chunk, the unpaged arm
      neither), the arms within 1e-5 of scale and two slots against a
      float64 attention block over their whole sequences; p50 and tokens/s;
   k. pipeline-parallel training at Megatron-LM 8.3B's block width (hidden
      3072, FFN 12288, 32 heads of 96, no biases, no norm), one block per
      stage, f32, SGD: at (pp 8, dp 1, tp 1) with 8 microbatches of 512
      rows, the fused 1F1B step (one pp_relay_kernel launch per tick: 30),
      its ``overlap=False`` baseline (none) and GPipe (none), fused against
      baseline bit-equal or within 1e-6 of scale, 1F1B against GPipe within
      1e-4, the loss against a float64 forward within 1e-4; at (pp 4, dp 2,
      tp 1) the step demotes to GPipe on the flat datapath (the plans answer
      ``vmem_miss``), counted; at (pp 2, dp 4, tp 1) the fused step launches
      agmm_kernel, mmrs_kernel and wgrad_kernel as the plans give, against
      the flat step within 1e-4; then ``build_pipeline_relay`` PALLAS
      against XLA from 4 KiB to 64 MiB per rank, exact; p50, tokens/s,
      bubble, stash slots, launches and the relay's share of each arm;
   l. the head-packed flash arm at Switch-Base-8's attention width (12
      heads of 64; world 8 at 2048 tokens per rank, ranks x heads on the
      leading axis: q, k and v (96, 2048, 64)), f32 and bf16, non-causal
      (the encoder) and causal (the decoder): ``flash_attention_packed``
      forward, and forward and backward in both backward modes (packed
      kernels only: flash_fwd_packed_kernel once a forward,
      flash_bwd_fused_packed_kernel or the packed two-pass pair once a
      backward), against ``flash_attention`` at d 64 (general kernels
      only) and, in f32, float64 on two heads; fused and two-pass
      gradients bit-equal; p50 and tokens/s of both arms and of
      ``scaled_dot_product_attention`` (timed only); an odd head count
      through the packed entry launches general kernels only; the pack
      and unpack copies timed on their own;
4. print the ``kernels`` line, the card line and, last, the device line.

Exits 2 without printing a result when no CUDA device is visible.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

GIB = 1 << 30
MIB = 1 << 20
#: H100 SXM device memory rate (bytes/s), NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM 32-bit integer rate (ops/s): 64 INT32 lanes per SM, half of
#: the 67 TFLOP/s float32 rate of NVIDIA's data sheet
INT32_OPS_PER_S = 33.5e12
#: H100 SXM dense TF32 tensor-core rate (FLOP/s), NVIDIA's data sheet: the
#: target of a later tensor-core redesign of the MoE kernels
TF32_TC_FLOPS = 495e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ptxas_report(out: str) -> list:
    """(kernel, registers, spill-store bytes) of each entry function in a
    ``-Xptxas=-v`` build log, names demangled by ``c++filt`` where the
    toolkit's host has it."""
    import re
    rows, fn, spill = [], None, 0
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows.append([fn, int(m.group(1)), spill])
            fn = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60)
        if names.returncode == 0:
            for r, n in zip(rows, names.stdout.splitlines()):
                r[0] = n.split("(")[0]
    except OSError:
        pass
    return [tuple(r) for r in rows]


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
    """The four reduce-scatter and all-gather kernels against their plain
    versions, by bits. rs_fold_kernel at P 2, 3 and 8 and L 1000, 1024 and
    777 (f32 chunks of 1000 and 1024 elements take the 16-byte path, 1000
    with an element tail in bf16; 777 puts chunks at odd offsets, on the
    element path): f32, int32 and bf16 with SUM and MAX, f32 under the
    bf16, f16 and int8 wires, and MAX on +-0 / NaN; the ring kernels at P
    2 and 8 on a ragged length."""
    import torch
    from accl_tpu_torch.constants import reduceFunction as F
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr

    dts = (torch.float32, torch.int32, torch.bfloat16)
    wires = ((torch.bfloat16, None), (torch.float16, None),
             (torch.int8, 10.0))
    C, S = 3, 1000                   # ragged: no multiple of 128
    n = 0
    for P in (2, 3, 8):
        for L in (1000, 1024, 777):
            for dt in dts:
                for func in (F.SUM, F.MAX):
                    x = make((P, P, L), dt, gen)
                    if not torch.equal(pr.ring_reduce_scatter(x, func),
                                       pr.plain_ring_reduce_scatter(x, func)):
                        fail(f"rs_fold_kernel != plain (P={P} L={L} {dt} "
                             f"{func.name})")
                    n += 1
            for wire in wires:
                x = make((P, P, L), torch.float32, gen) * 3
                if not torch.equal(pr.ring_reduce_scatter(x, F.SUM, wire),
                                   pr.plain_ring_reduce_scatter(x, F.SUM,
                                                                wire)):
                    fail(f"rs_fold_kernel != plain (P={P} L={L} "
                         f"wire={wire})")
                n += 1
            # MAX on +-0 / NaN: IEEE maximum (+0 > -0, NaN propagates; of
            # two NaNs the first if its sign is set), by bits
            for dt in (torch.float32, torch.bfloat16):
                x = torch.where(torch.rand((P, P, L), generator=gen,
                                           device="cuda") < 0.5, 0.0, -0.0)
                x[0, :, ::97] = float("nan")
                x[P - 1, :, 5::89] = -float("nan")
                x = x.to(dt)
                if not same_bits(pr.ring_reduce_scatter(x, F.MAX),
                                 pr.plain_ring_reduce_scatter(x, F.MAX)):
                    fail(f"rs_fold_kernel != plain on +-0/NaN MAX (P={P} "
                         f"L={L} {dt})")
                n += 1
    for P in (2, 8):
        for dt in dts:
            for func in (F.SUM, F.MAX):
                for bidir in (False, True):
                    x = make((P, P, C, S), dt, gen)
                    got = pc.chunked_reduce_scatter(x, func, None, bidir)
                    want = pc.plain_chunked_reduce_scatter(x, func, None,
                                                           bidir)
                    if not torch.equal(got, want):
                        fail(f"chunked_rs_kernel != plain (P={P} {dt} "
                             f"{func.name} bidir={bidir})")
                n += 2
            b = make((P, S), dt, gen)
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
        for wire in wires[0::2]:
            x = make((P, P, C, S), torch.float32, gen) * 3
            if not torch.equal(
                    pc.chunked_reduce_scatter(x, F.SUM, wire, True),
                    pc.plain_chunked_reduce_scatter(x, F.SUM, wire, True)):
                fail(f"chunked_rs_kernel != plain (P={P} wire={wire})")
            n += 1
    for dt in (torch.float32, torch.bfloat16):
        x = torch.where(torch.rand((8, 8, 2, S), generator=gen,
                                   device="cuda") < 0.5, 0.0, -0.0)
        x[0, 3, :, ::97] = float("nan")
        x = x.to(dt)
        for bidir in (False, True):
            if not same_bits(pc.chunked_reduce_scatter(x, F.MAX, None,
                                                       bidir),
                             pc.plain_chunked_reduce_scatter(x, F.MAX, None,
                                                             bidir)):
                fail(f"chunked_rs_kernel != plain on +-0/NaN MAX ({dt} "
                     f"bidir={bidir})")
            n += 1
    torch.cuda.synchronize()
    log(f"phase 2: {n} ring kernel-vs-plain cases bit-equal")


def bits(t):
    import torch
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def same_bits(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(bits(a), bits(b))


def specials(n: int, gen):
    """Random f32 with NaN, -NaN, +-0, +-inf, subnormals and values past
    the bf16 and f16 ranges."""
    import torch
    x = torch.randn(n, generator=gen, device="cuda")
    sp = torch.tensor([float("nan"), -float("nan"), 0.0, -0.0,
                       float("inf"), -float("inf"), 1e-40, -1e-40, 3.4e38,
                       -3.4e38, 65520.0, 65519.0, 6e-8, 1e-45],
                      device="cuda")
    x[::7][:sp.numel()] = sp
    return x


def check_plugin_kernels(gen) -> None:
    """combine / cast / stochastic round against their plain versions, by
    bits, at ragged (1000, 4099) and aligned (4096) lengths and on a
    16-byte-misaligned view."""
    import torch
    from accl_tpu_torch.constants import reduceFunction as F
    from accl_tpu_torch.ops import compression as cp
    from accl_tpu_torch.ops import reduce_ops as ro

    n_cases = 0
    for n in (1000, 4096, 4099):
        for dt in (torch.float32, torch.bfloat16, torch.float16,
                   torch.int32):
            if dt == torch.int32:
                a, b = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, n),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)
            else:
                a = specials(n, gen).to(dt)
                b = torch.roll(specials(n, gen), 1).to(dt)
                b[::5] = -a[::5]
            for func in (F.SUM, F.MAX):
                want = ro.plain_combine(a, b, func)
                if not same_bits(ro.pallas_combine(a, b, func), want):
                    fail(f"combine_kernel != plain (n={n} {dt} "
                         f"{func.name})")
                acc = a.clone()
                out = ro.pallas_combine(acc, b, func, donate=True)
                if out is not acc or not same_bits(out, want):
                    fail(f"combine_kernel donate != plain (n={n} {dt} "
                         f"{func.name})")
                if not same_bits(ro.pallas_combine(a[1:], b[1:], func),
                                 ro.plain_combine(a[1:], b[1:], func)):
                    fail(f"combine_kernel misaligned != plain (n={n} {dt} "
                         f"{func.name})")
                n_cases += 3
        x = specials(n, gen)
        for dst in (torch.bfloat16, torch.float16):
            y = cp.pallas_cast(x, dst)
            if not same_bits(y, cp.plain_cast(x, dst)):
                fail(f"cast_kernel float32 -> {dst} != plain (n={n})")
            if not same_bits(cp.pallas_cast(y, torch.float32),
                             cp.plain_cast(y, torch.float32)):
                fail(f"cast_kernel {dst} -> float32 != plain (n={n})")
            n_cases += 2
        nan_bits = bits(cp.pallas_cast(x, torch.bfloat16))[:8:7].tolist()
        if nan_bits != [0x7FC0, -64]:
            fail(f"cast_kernel NaN bits {nan_bits}, want 0x7FC0, 0xFFC0")
        for seed in (0, 7, -123456789):
            if not same_bits(cp.pallas_compress_stochastic(x, seed=seed),
                             cp.plain_compress_stochastic(x, seed)):
                fail(f"sr_kernel != plain (n={n} seed={seed})")
            n_cases += 1
        rows = specials(8 * n, gen).view(8, n)
        seeds = torch.arange(-3, 5, dtype=torch.int32, device="cuda") * 977
        if not same_bits(cp.pallas_compress_stochastic(rows, seed=seeds),
                         cp.plain_compress_stochastic(rows, seeds)):
            fail(f"sr_kernel per-row seeds != plain (n={n})")
        n_cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: {n_cases} plugin kernel-vs-plain cases bit-equal")


def check_relay_kernels(gen) -> None:
    """The bcast relay and the one-hop scatter and gather against their
    plain versions, by bits: P in {2, 8}, roots 0, P-1 and a middle rank,
    one and three segments, int8 / bf16 / f32 (random data with NaN, -NaN,
    +-0, inf and subnormals); the bcast at a ragged length, the scatter and
    gather at S 1000, 1024 and 777 (blocks on the 16-byte path, with and
    without an element tail, and blocks at odd offsets on the element
    path) and in int64 too. The rows a kernel leaves unwritten, the
    root's, are not compared."""
    import torch
    from accl_tpu_torch.parallel import pallas_chunked as pc

    def data(shape, dt):
        x = specials(math.prod(shape), gen).view(*shape)
        return x.to(dt) if dt.is_floating_point else (x * 50).to(dt)

    n_cases = 0
    for P in (2, 8):
        for root in sorted({0, P // 2, P - 1}):
            keep = [r for r in range(P) if r != root]
            for dt in (torch.int8, torch.bfloat16, torch.float32,
                       torch.int64):
                for C in (1, 3):
                    cases = []
                    if dt != torch.int64:
                        x = data((P, C, 1000), dt)
                        cases.append(("bcast_relay_kernel", 1000,
                                      pc.chunked_bcast(x, root),
                                      pc.plain_chunked_bcast(x, root)))
                    for S in (1000, 1024, 777):
                        x, xs = data((P, C, S), dt), data((P, P, C, S), dt)
                        cases += [("scatter_copy_kernel", S,
                                   pc.chunked_scatter(xs, root),
                                   pc.plain_chunked_scatter(xs, root)),
                                  ("gather_copy_kernel", S,
                                   pc.chunked_gather(x, root),
                                   pc.plain_chunked_gather(x, root))]
                    for name, S, got, want in cases:
                        if not same_bits(got[keep], want[keep]):
                            fail(f"{name} != plain (P={P} root={root} {dt} "
                                 f"C={C} S={S})")
                        n_cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: {n_cases} rooted kernel-vs-plain cases bit-equal")


def check_alltoall_kernels(gen) -> None:
    """alltoall_copy_kernel against its plain version, by bits: P in {2, 3,
    8}, one and three segments of S 1000, 1024 and 777 (chunks on the
    16-byte path, with and without an element tail, and at odd offsets on
    the element path), 1-, 2-, 4- and 8-byte elements (random data with
    NaN, -NaN, +-0, inf and subnormals). Each rank's own slot, which the
    kernel leaves unwritten, is not compared."""
    import torch
    from accl_tpu_torch.parallel import pallas_chunked as pc

    n_cases = 0
    for P in (2, 3, 8):
        off = ~torch.eye(P, dtype=torch.bool, device="cuda")
        for dt in (torch.int8, torch.bfloat16, torch.float32, torch.float64):
            for C in (1, 3):
                for S in (1000, 1024, 777):
                    x = specials(P * P * C * S, gen).view(P, P, C, S)
                    x = (x.nan_to_num(0.0) * 50).to(dt) if dt == torch.int8 \
                        else x.to(dt)
                    if not same_bits(pc.chunked_alltoall(x)[off],
                                     pc.plain_chunked_alltoall(x)[off]):
                        fail(f"alltoall_copy_kernel != plain (P={P} {dt} "
                             f"C={C} S={S})")
                    n_cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: {n_cases} alltoall kernel-vs-plain cases bit-equal")


def f32_sum_bound(k: int, mag):
    """The f32 bound on two sums of the same k products taken in different
    orders: each is within k 2^-24 sum|a b| of the exact value."""
    return 2 * k * 2.0 ** -24 * mag


#: The card test's tolerance on the TP MLP against the CPU: rtol, and atol
#: as a share of max|want|. A product whose f32 sum the tensor cores carry
#: over a long k (rounding toward zero) misses it, where :func:`f32_sum_bound`,
#: linear in k, lets it pass.
LONG_K_TOL = (1e-5, 1e-6)


def long_k_close(what: str, got, want) -> float:
    """Fail unless |got - want| <= rtol |want| + atol max|want| element by
    element (:data:`LONG_K_TOL`); returns the largest share of that
    tolerance taken."""
    rtol, atol = LONG_K_TOL
    share = ((got - want).abs() / (rtol * want.abs() + atol * want.abs()
                                   .max())).max().item()
    if not share <= 1.0:
        fail(f"{what} outside rtol {rtol} / atol {atol} max|want| of the "
             f"plain version at a long k ({share!r} of it)")
    return share


def check_moe_kernels(gen) -> None:
    """a2a_mm_kernel, mm_a2a_kernel and a2a_wgrad_kernel against their plain
    versions at worlds 2, 3 and 8, bidirectional on and off (the wgrad's
    one or two channels), the aligned shape (e_local, C, d, h) = (2, 8, 128,
    128) and the uneven (2, 5, 72, 40), f32 and bf16 wires (the dispatch's
    token payload, the combine's rounded output, the wgrad's traveller),
    the wgrad in both orientations: integer-valued operands bit-equal,
    random ones within :func:`f32_sum_bound`. The plain versions run with
    TF32 off."""
    import torch
    from accl_tpu_torch.ops import collective_alltoall as ca

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for float32 matmuls: the plain versions would be "
             "the inexact side")

    def ints(shape, lo=-4, hi=5):
        return torch.randint(lo, hi, shape, generator=gen,
                             device="cuda").float()

    n_cases, worst = 0, 0.0
    for P in (2, 3, 8):
        for el, C, d, h in ((2, 8, 128, 128), (2, 5, 72, 40)):
            for bidir in (False, True):
                for wire in (torch.float32, torch.bfloat16):
                    case = f"P={P} shape={(el, C, d, h)} bidir={bidir} " \
                        f"wire={wire}"
                    x = ints((P, P * el, C, d)).to(wire)
                    w = ints((P, el, d, h))
                    if not torch.equal(ca.a2a_mm(x, w, bidir),
                                       ca.plain_a2a_mm(x, w)):
                        fail(f"a2a_mm_kernel != plain ({case})")
                    hx = ints((P, el, P * C, h), -9, 10)
                    wo = ints((P, el, h, d))
                    if not torch.equal(ca.mm_a2a(hx, wo, wire, bidir),
                                       ca.plain_mm_a2a(hx, wo, wire)):
                        fail(f"mm_a2a_kernel != plain ({case})")
                    n_cases += 2
                    # the dw legs: x travels against dy (dispatch), dy
                    # against h (the combine's mirror); the channels order
                    # the sum over sources
                    nchan = 2 if bidir and P >= 4 else 1
                    for lhs in (True, False):
                        if not torch.equal(
                                ca.a2a_wgrad(x, hx, nchan, lhs),
                                ca.plain_a2a_wgrad(x, hx, nchan, lhs)):
                            fail(f"a2a_wgrad_kernel != plain ({case} "
                                 f"travel_lhs={lhs})")
                        n_cases += 1
            x = torch.randn((P, P * el, C, d), generator=gen, device="cuda")
            w = torch.randn((P, el, d, h), generator=gen, device="cuda")
            hx = torch.randn((P, el, P * C, h), generator=gen, device="cuda")
            wo = torch.randn((P, el, h, d), generator=gen, device="cuda")
            for name, got, want, mag, k in (
                    ("a2a_mm_kernel", ca.a2a_mm(x, w), ca.plain_a2a_mm(x, w),
                     ca.plain_a2a_mm(x.abs(), w.abs()), d),
                    ("mm_a2a_kernel", ca.mm_a2a(hx, wo),
                     ca.plain_mm_a2a(hx, wo),
                     ca.plain_mm_a2a(hx.abs(), wo.abs()), h),
                    ("a2a_wgrad_kernel", ca.a2a_wgrad(x, hx, 2),
                     ca.plain_a2a_wgrad(x, hx, 2),
                     ca.plain_a2a_wgrad(x.abs(), hx.abs(), 2), P * C)):
                err = (got - want).abs()
                if bool((err > f32_sum_bound(k, mag)).any()):
                    fail(f"{name} random f32 outside the f32 sum bound "
                         f"(P={P} shape={(el, C, d, h)})")
                worst = max(worst, err.max().item())
                n_cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: {n_cases} MoE kernel-vs-plain cases (integer operands "
        f"bit-equal; random within the f32 sum bound, max|err| {worst!r})")


def plan_budgets(op: str, m: int, k: int, n: int, P: int, bidir: bool,
                 wire) -> dict:
    """{mode: budget} of the port's plan for a per-rank shape: the first
    budget of a descending ladder giving "resident", "stream" (k-blocked)
    and "nblock" (the accumulator-blocking arm)."""
    import torch
    from accl_tpu_torch.ops import collective_matmul as cm
    plan = cm.agmm_plan if op == "agmm" else cm.mmrs_plan
    wdt = cm._resolve_wire(wire, torch.float32)
    saved, modes = cm._VMEM_BUDGET, {}
    try:
        for b in (12 << 20, 512 << 10, 256 << 10, 200 << 10, 150 << 10,
                  128 << 10, 112 << 10, 100 << 10, 96 << 10, 64 << 10,
                  48 << 10, 32 << 10):
            cm._VMEM_BUDGET = b
            p = plan(m, k, n, P, torch.float32, bidir, wire_dtype=wdt)
            if p is not None:
                modes.setdefault("nblock" if ("mb" in p or "nb" in p)
                                 else p["mode"], b)
    finally:
        cm._VMEM_BUDGET = saved
    return modes


class plain_kernels:
    """Within this block the collective-matmul bodies call the kernels'
    plain versions (with the arguments their plans give) instead of the
    kernels, on the same CUDA tensors."""

    def __enter__(self):
        from accl_tpu_torch.ops import collective_matmul as cm
        self.saved = (cm.agmm, cm.mmrs, cm.wgrad)
        cm.agmm, cm.mmrs, cm.wgrad = (cm.plain_agmm, cm.plain_mmrs,
                                      cm.plain_wgrad)

    def __exit__(self, *exc):
        from accl_tpu_torch.ops import collective_matmul as cm
        cm.agmm, cm.mmrs, cm.wgrad = self.saved


def wgrad_budgets(ms: int, ct: int, cl: int, P: int, bidir: bool,
                  wire) -> dict:
    """{mode: budget} of the port's wgrad plan for a shape: the first budget
    of a descending ladder giving "resident" and "stream" (the traveller's
    columns in ``nctb`` > 1 blocks)."""
    import torch
    from accl_tpu_torch.ops import collective_matmul as cm
    wdt = cm._resolve_wire(wire, torch.float32)
    saved, modes = cm._VMEM_BUDGET, {}
    try:
        for b in (12 << 20, 1 << 20, 512 << 10, 320 << 10, 256 << 10,
                  200 << 10, 150 << 10, 128 << 10, 96 << 10):
            cm._VMEM_BUDGET = b
            p = cm.wgrad_plan(ms, ct, cl, P, wdt or torch.float32,
                              torch.float32, bidir)
            if p is not None:
                modes.setdefault("stream" if p.get("nctb", 1) > 1
                                 else "resident", b)
    finally:
        cm._VMEM_BUDGET = saved
    return modes


#: the operand dtype pairs of the collective-matmul checks: f32, 16-bit
#: pairs (no split) and mixed ones (one operand split)
CMATMUL_DTYPES = (("float32", "float32"), ("bfloat16", "bfloat16"),
                  ("float16", "float16"), ("bfloat16", "float32"),
                  ("float32", "float16"))


def check_wgrad_kernel(gen) -> None:
    """wgrad_kernel against its plain version, driven by
    ``gathered_wgrad_body`` (which picks the column blocks and the channel
    split from its plan): worlds 2, 3 and 8, bidirectional on and off (P >=
    4), an aligned shard (ms, ct, cl) = (64, 256, 256), a ragged one (12,
    256, 40: channel 1 from row 8), one straddling the 128 x 128 block tile
    (136, 264, 200: segments of 72 and 64 rows), one whose rows do not
    start on 16 bytes (20, 37, 45) and the smallest contraction (8, 72, 40:
    8 rows a rank), the resident and the streaming plan (nctb > 1), both
    orientations, the operand dtype pairs of CMATMUL_DTYPES, f32 and a bf16
    wire: integer operands bit-equal (the traveller past bf16's 8 bits on
    the wire), random ones within :func:`f32_sum_bound` over the P ms
    products. Then a long contraction, (64, 256, 256) at world 8 (512 rows),
    random f32 within :func:`long_k_close`. The plain versions run with TF32
    off."""
    import torch
    from accl_tpu_torch.ops import collective_matmul as cm

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen,
                             device="cuda").float()

    n_cases, worst, seen = 0, 0.0, set()
    saved = cm._VMEM_BUDGET
    try:
        for P in (2, 3, 8):
            for ms, ct, cl in ((64, 256, 256), (12, 256, 40),
                               (136, 264, 200), (20, 37, 45), (8, 72, 40)):
                for bidir in ((False, True) if P >= 4 else (False,)):
                    for wire in ("off", "bf16"):
                        for tdt, ldt in CMATMUL_DTYPES:
                            tdt, ldt = getattr(torch, tdt), getattr(torch,
                                                                    ldt)
                            for mode, budget in wgrad_budgets(
                                    ms, ct, cl, P, bidir, wire).items():
                                cm._VMEM_BUDGET = budget
                                for lhs in (True, False):
                                    case = f"P={P} {(ms, ct, cl)} " \
                                        f"bidir={bidir} wire={wire} " \
                                        f"{tdt}/{ldt} {mode} travel_lhs={lhs}"
                                    lo = -600 if wire == "bf16" else -9
                                    trav = ints((P, ms, ct), lo, -lo).to(tdt)
                                    loc = ints((P, P * ms, cl), -9, 10) \
                                        .to(ldt)

                                    def run(a, b):
                                        return cm.gathered_wgrad_body(
                                            a, b, overlap=True,
                                            bidirectional=bidir,
                                            wire_dtype=wire, travel_lhs=lhs)

                                    got = run(trav, loc)
                                    with plain_kernels():
                                        want = run(trav, loc)
                                    if not torch.equal(got, want):
                                        fail(f"wgrad_kernel != plain "
                                             f"({case})")
                                    seen.add(mode)
                                    n_cases += 1
                                    if wire == "bf16":
                                        continue
                                    trav = torch.randn(
                                        (P, ms, ct), generator=gen,
                                        device="cuda").to(tdt)
                                    loc = torch.randn(
                                        (P, P * ms, cl), generator=gen,
                                        device="cuda").to(ldt)
                                    got = run(trav, loc)
                                    with plain_kernels():
                                        want = run(trav, loc)
                                        mag = run(trav.abs(), loc.abs())
                                    err = (got - want).abs()
                                    if bool((err > f32_sum_bound(
                                            P * ms, mag)).any()):
                                        fail(f"wgrad_kernel random operands "
                                             f"outside the f32 sum bound "
                                             f"({case})")
                                    worst = max(worst, err.max().item())
                                    n_cases += 1
    finally:
        cm._VMEM_BUDGET = saved
    for mode in ("resident", "stream"):
        if mode not in seen:
            fail(f"phase 2 never ran wgrad_kernel in its {mode} plan")
    long_k = 0.0
    for bidir in (False, True):
        for lhs in (True, False):
            trav = torch.randn((8, 64, 256), generator=gen, device="cuda")
            loc = torch.randn((8, 512, 256), generator=gen, device="cuda")

            def run(a, b):
                return cm.gathered_wgrad_body(a, b, overlap=True,
                                              bidirectional=bidir,
                                              wire_dtype="off",
                                              travel_lhs=lhs)

            got = run(trav, loc)
            with plain_kernels():
                want = run(trav, loc)
            long_k = max(long_k, long_k_close(
                f"wgrad_kernel (bidir={bidir} travel_lhs={lhs})", got, want))
            n_cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: {n_cases} wgrad kernel-vs-plain cases over {sorted(seen)} "
        f"(integer operands bit-equal; random within the f32 sum bound, "
        f"max|err| {worst!r}; at 512 rows within {LONG_K_TOL}, at most "
        f"{long_k!r} of it)")


def check_cmatmul_kernels(gen) -> None:
    """agmm_kernel and mmrs_kernel against their plain versions, each
    driven by the all-gather x matmul and matmul x reduce-scatter bodies
    (which pick the launches' row blocks, column blocks and channel split
    from their plans): worlds 2, 3 and 8, bidirectional on and off (P >=
    4), an aligned per-rank shape (m, k, n) = (64, 256, 256), a ragged one
    (12, 72, 40), one straddling the 128 x 128 block tile (136, 264, 200),
    one whose rows do not start on 16 bytes (20, 37, 45) and the smallest
    contraction (8, 8, 40: k 8 a hop), every plan mode the budget ladder
    reaches (resident, k-blocked stream, accumulator blocks), the operand
    dtype pairs of CMATMUL_DTYPES, f32 and a bf16 wire: integer operands
    bit-equal (with the bf16 wire past 256, so the travelling sum rounds),
    random ones within :func:`f32_sum_bound` (full-precision wire). Then
    mmrs over a long contraction, (128, 512, 256) at world 8 (k 512 a hop),
    random f32 within :func:`long_k_close`. The plain versions run with TF32
    off."""
    import torch
    from accl_tpu_torch.ops import collective_matmul as cm

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for float32 matmuls: the plain versions would be "
             "the inexact side")

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen,
                             device="cuda").float()

    bodies = {"agmm": cm.all_gather_matmul_body,
              "mmrs": cm.matmul_reduce_scatter_body}
    n_cases, worst, seen = 0, 0.0, set()
    saved = cm._VMEM_BUDGET
    try:
        for P in (2, 3, 8):
            for m, k, n in ((64, 256, 256), (12, 72, 40), (136, 264, 200),
                            (20, 37, 45), (8, 8, 40)):
                for bidir in ((False, True) if P >= 4 else (False,)):
                    for op, rows in (("agmm", m), ("mmrs", P * m)):
                        for wire in ("off", "bf16"):
                            modes = plan_budgets(op, rows, k, n, P, bidir,
                                                 wire)
                            for (xdt, wdt), (mode, budget) in (
                                    (d, mb) for d in CMATMUL_DTYPES
                                    for mb in modes.items()):
                                xdt, wdt = getattr(torch, xdt), \
                                    getattr(torch, wdt)
                                cm._VMEM_BUDGET = budget
                                case = f"{op} P={P} {(m, k, n)} " \
                                    f"bidir={bidir} wire={wire} " \
                                    f"{xdt}/{wdt} {mode}"
                                lo, hi = ((-600, 600) if op == "agmm" and
                                          wire == "bf16" else (-9, 10))
                                x = ints((P, rows, k), lo, hi).to(xdt)
                                w = ints((P, k, n), -9, 10).to(wdt)

                                def run(a, b):
                                    return bodies[op](a, b, overlap=True,
                                                      bidirectional=bidir,
                                                      wire_dtype=wire)

                                got = run(x, w)
                                with plain_kernels():
                                    want = run(x, w)
                                if not torch.equal(got, want):
                                    fail(f"{op} kernel != plain ({case})")
                                seen.add((op, mode))
                                n_cases += 1
                                if wire == "bf16":
                                    continue
                                x = torch.randn((P, rows, k), generator=gen,
                                                device="cuda").to(xdt)
                                w = torch.randn((P, k, n), generator=gen,
                                                device="cuda").to(wdt)
                                got = run(x, w)
                                with plain_kernels():
                                    want = run(x, w)
                                    mag = run(x.abs(), w.abs())
                                err = (got - want).abs()
                                K = k if op == "agmm" else P * k
                                if bool((err > f32_sum_bound(K, mag)).any()):
                                    fail(f"{op} kernel random operands "
                                         f"outside the f32 sum bound "
                                         f"({case})")
                                worst = max(worst, err.max().item())
                                n_cases += 1
    finally:
        cm._VMEM_BUDGET = saved
    for op in ("agmm", "mmrs"):
        for mode in ("resident", "stream", "nblock"):
            if (op, mode) not in seen:
                fail(f"phase 2 never ran {op} in its {mode} plan")
    long_k = 0.0
    for bidir in (False, True):
        x = torch.randn((8, 8 * 128, 512), generator=gen, device="cuda")
        w = torch.randn((8, 512, 256), generator=gen, device="cuda")

        def run(a, b):
            return cm.matmul_reduce_scatter_body(a, b, overlap=True,
                                                 bidirectional=bidir,
                                                 wire_dtype="off")

        got = run(x, w)
        with plain_kernels():
            want = run(x, w)
        long_k = max(long_k, long_k_close(f"mmrs kernel (bidir={bidir})",
                                          got, want))
        n_cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: {n_cases} collective-matmul kernel-vs-plain cases over "
        f"{sorted(seen)} (integer operands bit-equal; random within the f32 "
        f"sum bound, max|err| {worst!r}; mmrs at k 512 within {LONG_K_TOL}, "
        f"at most {long_k!r} of it)")


def measure_kernels(gen, big_ok: bool) -> dict:
    """Each kernel at its main-path shape (f32 SUM, P=8): the 4 MiB
    all-reduce for the VMEM-range pair, the 1 GiB one (or the largest that
    fits) for the segmented pair. Each wrapper runs with an ``errors``
    list, so it does not wait for its launch to read an error word, and is
    timed in turns with its plain version and library call, the host's
    launch work hidden (``time_in_turns``). Returns per-kernel
    measurements."""
    import torch
    from accl_tpu_torch.constants import reduceFunction as F
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr

    P = 8
    res = {}

    def ring_bytes(kind, x):
        """The schedule's own traffic (csrc/ring.cu) for f32 at P=8: per
        element of a chunk, a reduce-scatter ring moves (P+1) + (2P-2)
        words (seed, P-1 hops of upstream + local reads and a write), an
        all-gather ring 2P (seed and P-1 block copies); the one-pass fold
        moves the function's own P + 1 (P reads and a write)."""
        elems = x.numel() // P if kind != "ag" else x.numel()
        words = {"rs": (P + 1) + (2 * P - 2), "ag": 2 * P, "fold": P + 1}
        return elems * words[kind] * x.element_size()

    def record(name, got, want, x, out, fn_kernel, fn_plain, fn_lib, iters,
               kind):
        err = (got.double() - want.double()).abs().max().item()
        if not torch.equal(got, want):
            fail(f"{name} != plain at the main-path shape {tuple(x.shape)}")
        nbytes = x.numel() * x.element_size() + out.numel() * \
            out.element_size()
        ms = time_in_turns([fn_kernel, fn_plain, fn_lib], iters)
        res[name] = {
            "shape": list(x.shape),
            "max_abs_err": err,
            "ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2],
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "ring_bound_ms": ring_bytes(kind, x) / HBM_BYTES_PER_S * 1e3,
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
    record("rs_fold_kernel", got, pr.plain_ring_reduce_scatter(x, F.SUM), x,
           got, lambda: pr.ring_reduce_scatter(x, F.SUM, None, []),
           lambda: pr.plain_ring_reduce_scatter(x, F.SUM),
           lambda: x.view(P, P, -1).sum(0), 50, "fold")
    b = got
    got = pr.ring_allgather(b)
    record("ring_ag_kernel", got, pr.plain_ring_allgather(b), b, got,
           lambda: pr.ring_allgather(b, []),
           lambda: pr.plain_ring_allgather(b),
           lambda: b.repeat(P, 1, 1), 50, "ag")
    del x, b, got

    # segmented pair at the largest main-path all-reduce that fits
    per_rank = GIB if big_ok else 256 * MIB
    S = MIB // 4                          # 1 MiB segments of f32
    C = per_rank // 4 // P // S
    x = make((P, P, C, S), torch.float32, gen)
    got = pc.chunked_reduce_scatter(x, F.SUM, None, True)
    want = pc.plain_chunked_reduce_scatter(x, F.SUM, None, True)
    record("chunked_rs_kernel", got, want, x, got,
           lambda: pc.chunked_reduce_scatter(x, F.SUM, None, True, []),
           lambda: pc.plain_chunked_reduce_scatter(x, F.SUM, None, True),
           lambda: x.view(P, P, -1).sum(0), 3, "rs")
    del want, x
    torch.cuda.empty_cache()
    b = got
    got = pc.chunked_allgather(b, True)
    want = pc.plain_chunked_allgather(b, True)
    record("chunked_ag_kernel", got, want, b, got,
           lambda: pc.chunked_allgather(b, True, []),
           lambda: pc.plain_chunked_allgather(b, True),
           lambda: b.repeat(P, 1, 1, 1), 3, "ag")
    del b, got, want
    torch.cuda.empty_cache()
    return res


def measure_plugin_kernels(gen) -> dict:
    """The plugin kernels at their main-path shape, the (8, 64 Mi) f32
    payload of a 256 MiB-per-rank call at world 8: ``ACCL.combine``'s
    operands, the two-tier all-gather's DCN leg (cast and stochastic
    round, one seed per rank). Bounds: bytes over 3.35 TB/s (combine
    3 n t, cast n (t_src + t_dst), SR 6 n); SR's hash also counts its
    integer operations (``SR_INT_OPS`` per element) over the int32 rate."""
    import torch
    from accl_tpu_torch.constants import reduceFunction as F
    from accl_tpu_torch.ops import compression as cp
    from accl_tpu_torch.ops import reduce_ops as ro

    P, n = 8, 256 * MIB // 4
    res = {}

    def record(name, got, want, x, fn_kernel, fn_plain, fn_lib, nbytes,
               ops, iters):
        if not same_bits(got, want):
            fail(f"{name} != plain at the main-path shape {tuple(x.shape)}")
        err = (got.double() - want.double()).abs().nan_to_num(0.0) \
            .max().item()
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / INT32_OPS_PER_S * 1e3
        res[name] = {
            "shape": list(x.shape), "max_abs_err": err,
            "ms": time_ms(fn_kernel, iters),
            "plain_ms": time_ms(fn_plain, max(1, iters // 3)),
            "library_ms": (time_ms(fn_lib, iters) if fn_lib is not None
                           else None),
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        }
        r = res[name]
        log(f"  {name} {tuple(x.shape)}: kernel {r['ms']!r} ms, plain "
            f"{r['plain_ms']!r} ms, library {r['library_ms']!r} ms, bound "
            f"{r['bound_ms']!r} ms ({r['bound_by']}), max_abs_err {err!r}")

    a = torch.randn((P, n), generator=gen, device="cuda")
    b = torch.randn((P, n), generator=gen, device="cuda")
    got = ro.pallas_combine(a, b, F.SUM)
    record("combine_kernel", got, ro.plain_combine(a, b, F.SUM), a,
           lambda: ro.pallas_combine(a, b, F.SUM),
           lambda: ro.plain_combine(a, b, F.SUM),
           lambda: torch.add(a, b), 3 * a.numel() * 4, a.numel(), 10)
    mx = ro.pallas_combine(a, b, F.MAX)
    if not same_bits(mx, ro.plain_combine(a, b, F.MAX)):
        fail("combine_kernel MAX != plain at the main-path shape")
    k_ms = time_ms(lambda: ro.pallas_combine(a, b, F.MAX), 10)
    lib_ms = time_ms(lambda: torch.maximum(a, b), 10)
    log(f"    MAX: kernel {k_ms!r} ms, torch.maximum {lib_ms!r} ms")
    del b, got, mx
    torch.cuda.empty_cache()

    x = a
    got = cp.pallas_cast(x, torch.bfloat16)
    record("cast_kernel", got, cp.plain_cast(x, torch.bfloat16), x,
           lambda: cp.pallas_cast(x, torch.bfloat16),
           lambda: cp.plain_cast(x, torch.bfloat16),
           lambda: x.to(torch.bfloat16), x.numel() * 6, 0, 10)
    del got
    torch.cuda.empty_cache()

    seeds = torch.arange(P, dtype=torch.int32, device="cuda") * 7919 - 5
    got = cp.pallas_compress_stochastic(x, seed=seeds)
    want = cp.plain_compress_stochastic(x, seeds)
    record("sr_kernel", got, want, x,
           lambda: cp.pallas_compress_stochastic(x, seed=seeds),
           lambda: cp.plain_compress_stochastic(x, seeds), None,
           x.numel() * 6, x.numel() * SR_INT_OPS, 10)
    del got, want, x, a
    torch.cuda.empty_cache()
    return res


def measure_relay_kernels(gen, big_ok: bool) -> dict:
    """The rooted kernels at the main path's shapes, f32, P=8, root 3, 1 MiB
    segments: the bcast of 1 GiB per rank, the scatter of the root's 1 GiB
    and the gather of 128 MiB per rank (a quarter of each when the card
    has less than 60 GiB). Bounds, n the elements of a bcast row or of one
    block: the function moves P n words for a bcast (the root's row read
    once, P-1 rows written) and 2 (P-1) n for a scatter or gather. The
    bcast relay's own traffic (its ring bound) is 2 (P-1) n; the one-hop
    scatter and gather move the function's own words, so their ring bound
    is their bound. The bcast is timed with CUDA events around the call;
    the scatter and gather, some ten times shorter, with the host's launch
    work hidden and in turns with their plain versions and yardsticks
    (``time_in_turns``), and their events around the bare call are logged
    beside."""
    import torch
    from accl_tpu_torch.parallel import pallas_chunked as pc

    P, root = 8, 3
    keep = [r for r in range(P) if r != root]
    S = MIB // 4
    per_rank = GIB if big_ok else 256 * MIB
    res = {}

    def record(name, got, want, x, fn_kernel, fn_plain, fn_lib, words,
               ring_words, iters, queued=False):
        err = 0.0
        for r in keep:                    # row by row: 1 GiB rows
            if not torch.equal(got[r], want[r]):
                fail(f"{name} != plain at the main-path shape "
                     f"{tuple(x.shape)} (row {r})")
            err = max(err, (got[r] - want[r]).abs().max().item())
        del got, want
        if queued:
            ms = time_in_turns([fn_kernel, fn_plain, fn_lib], iters)
        else:
            ms = [time_ms(fn, iters) for fn in (fn_kernel, fn_plain, fn_lib)]
        res[name] = {
            "shape": list(x.shape), "max_abs_err": err,
            "ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2],
            "bound_ms": words * 4 / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "ring_bound_ms": ring_words * 4 / HBM_BYTES_PER_S * 1e3,
        }
        r = res[name]
        host = f", events around the call {time_ms(fn_kernel, iters)!r} ms" \
            if queued else ""
        log(f"  {name} {tuple(x.shape)}: kernel {r['ms']!r} ms, plain "
            f"{r['plain_ms']!r} ms, library {r['library_ms']!r} ms, bound "
            f"{r['bound_ms']!r} ms, ring bound {r['ring_bound_ms']!r} ms, "
            f"max_abs_err {err!r}{host}")

    # bcast: every rank's (C, S) row, the root's read
    x = torch.randn((P, per_rank // 4 // S, S), generator=gen, device="cuda")
    n = x[0].numel()
    record("bcast_relay_kernel", pc.chunked_bcast(x, root),
           pc.plain_chunked_bcast(x, root), x,
           lambda: pc._launch_relay(x, root),
           lambda: pc.plain_chunked_bcast(x, root),
           lambda: x[root].view(-1).expand(P, n).clone(),
           P * n, 2 * (P - 1) * n, 3)
    del x
    torch.cuda.empty_cache()

    # scatter: the root's P blocks of per_rank / P bytes
    blk = per_rank // P // 4 // S
    x = torch.randn((P, P, blk, S), generator=gen, device="cuda")
    n = blk * S
    record("scatter_copy_kernel", pc.chunked_scatter(x, root),
           pc.plain_chunked_scatter(x, root), x,
           lambda: pc.chunked_scatter(x, root),
           lambda: pc.plain_chunked_scatter(x, root),
           lambda: x[root].view(P, n).clone(),
           2 * (P - 1) * n, 2 * (P - 1) * n, 20, queued=True)
    del x
    torch.cuda.empty_cache()

    # gather: every rank's block of per_rank / P bytes, into one (P, C, S)
    x = torch.randn((P, blk, S), generator=gen, device="cuda")
    into = torch.empty_like(x)
    record("gather_copy_kernel", pc.chunked_gather(x, root),
           pc.plain_chunked_gather(x, root), x,
           lambda: pc.chunked_gather(x, root, out=into),
           lambda: pc.plain_chunked_gather(x, root, into),
           lambda: x.reshape(-1).clone(),
           2 * (P - 1) * n, 2 * (P - 1) * n, 20, queued=True)
    del x, into
    torch.cuda.empty_cache()
    return res


def measure_alltoall_kernel(gen, big_ok: bool) -> dict:
    """alltoall_copy_kernel at the main path's largest call, the 1 GiB per
    rank all-to-all (f32, P=8, 1 MiB segments: (8, 8, 128, 262144)), a
    quarter of it when the card has less than 60 GiB. Bound, n one chunk's
    elements: the function reads and writes the P (P-1) n words that leave
    their rank, 2 P (P-1) n words in all; the one-hop kernel moves just
    those, so its ring bound is its bound. Timed in turns with the plain
    version and the library call (``time_in_turns``)."""
    import torch
    from accl_tpu_torch.parallel import pallas_chunked as pc

    P = 8
    S = MIB // 4
    per_rank = GIB if big_ok else 256 * MIB
    C = per_rank // 4 // P // S
    x = torch.randn((P, P, C, S), generator=gen, device="cuda")
    n = C * S
    off = ~torch.eye(P, dtype=torch.bool, device="cuda")
    got = pc.chunked_alltoall(x)
    want = pc.plain_chunked_alltoall(x)
    err = 0.0
    for r in range(P):                    # row by row: 1 GiB rows
        keep = off[r]
        if not same_bits(got[r][keep], want[r][keep]):
            fail(f"alltoall_copy_kernel != plain at the main-path shape "
                 f"{tuple(x.shape)} (row {r})")
        err = max(err, (got[r][keep] - want[r][keep]).abs().max().item())
    del got, want
    torch.cuda.empty_cache()
    words = 2 * P * (P - 1) * n
    ms = time_in_turns([lambda: pc.chunked_alltoall(x, []),
                        lambda: pc.plain_chunked_alltoall(x),
                        lambda: x.view(P, P, n).transpose(0, 1).contiguous()],
                       5)
    res = {"alltoall_copy_kernel": {
        "shape": list(x.shape), "max_abs_err": err,
        "ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2],
        "bound_ms": words * 4 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "ring_bound_ms": words * 4 / HBM_BYTES_PER_S * 1e3}}
    r = res["alltoall_copy_kernel"]
    log(f"  alltoall_copy_kernel {tuple(x.shape)}: kernel {r['ms']!r} ms, "
        f"plain {r['plain_ms']!r} ms, library {r['library_ms']!r} ms, bound "
        f"{r['bound_ms']!r} ms, max_abs_err {err!r}")
    del x
    torch.cuda.empty_cache()
    return res


def f32_peak_flops() -> float:
    """The card's f32 rate on the CUDA cores: 128 FP32 lanes per SM (sm_90),
    two operations per fused multiply-add, at the SM count and the highest
    SM clock that ``nvidia-smi`` reports."""
    import torch
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi clocks.max.sm failed: {r.stderr.strip()}")
    mhz = float(r.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * 2 * mhz * 1e6


#: Switch-Base-8 (Fedus et al., 2021; ``google/switch-base-8``): d_model,
#: d_ff, experts; world 8 (one expert per rank), 2048 tokens per rank, top-1,
#: capacity factor 1.25: C = 1.25 * 2048 / 8 = 320
SWITCH = {"d": 768, "h": 3072, "E": 8, "P": 8, "n": 2048, "C": 320}


def measure_moe_kernels(gen) -> dict:
    """a2a_mm_kernel, mm_a2a_kernel and a2a_wgrad_kernel at the
    Switch-Base-8 shapes of phases 3e and 3h (f32): dispatch x (8, 8, 320,
    768) with w_in (8, 1, 768, 3072), combine h (8, 1, 2560, 3072) with
    w_out (8, 1, 3072, 768), the dispatch's dw x (8, 8, 320, 768) against
    dy (8, 1, 2560, 3072) into (8, 1, 768, 3072) (its mirror, the combine's
    dw, logged). Bounds: the larger of the bytes (inputs read once, the
    output written once) over 3.35 TB/s and the 2 P (P C) K N f32
    operations over the CUDA cores' f32 rate (:func:`f32_peak_flops`); the
    tensor cores' TF32 rate is the later target. Yardstick: the unfused
    pair (permute, then ``torch.einsum``)."""
    import torch
    from accl_tpu_torch.ops import collective_alltoall as ca

    P, E, C, d, h = (SWITCH[k] for k in ("P", "E", "C", "d", "h"))
    el = E // P
    peak = f32_peak_flops()
    log(f"  f32 CUDA-core peak {peak / 1e12!r} TFLOP/s (SMs x 128 x 2 x max "
        f"SM clock); TF32 tensor-core peak {TF32_TC_FLOPS / 1e12!r}")
    res = {}

    def record(name, got, want, mag, k, a, b, fn_kernel, fn_plain, fn_lib):
        err = (got - want).abs()
        if bool((err > f32_sum_bound(k, mag)).any()):
            fail(f"{name} outside the f32 sum bound at the main-path shape")
        flops = 2 * P * el * (P * C) * a.shape[-1] * b.shape[-1]
        nbytes = (a.numel() + b.numel() + got.numel()) * 4
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / peak * 1e3
        res[name] = {
            "shape": [list(a.shape), list(b.shape)],
            "max_abs_err": err.max().item(),
            "ms": time_ms(fn_kernel, 10), "plain_ms": time_ms(fn_plain, 10),
            "library_ms": time_ms(fn_lib, 10),
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "tensor_core_bound_ms": max(by_bytes,
                                        flops / TF32_TC_FLOPS * 1e3)}
        r = res[name]
        log(f"  {name} {tuple(a.shape)} x {tuple(b.shape)}: kernel "
            f"{r['ms']!r} ms, plain {r['plain_ms']!r} ms, library "
            f"{r['library_ms']!r} ms, bound {r['bound_ms']!r} ms "
            f"({r['bound_by']}; TF32 tensor cores "
            f"{r['tensor_core_bound_ms']!r} ms), max_abs_err "
            f"{r['max_abs_err']!r}")

    x = torch.randn((P, E, C, d), generator=gen, device="cuda")
    w = torch.randn((P, el, d, h), generator=gen, device="cuda") * d ** -0.5
    record("a2a_mm_kernel", ca.a2a_mm(x, w), ca.plain_a2a_mm(x, w),
           ca.plain_a2a_mm(x.abs(), w.abs()), d, x, w,
           lambda: ca.a2a_mm(x, w), lambda: ca.plain_a2a_mm(x, w),
           lambda: ca.xla_alltoall_matmul(x, w))
    hx = torch.relu(ca.plain_a2a_mm(x, w))
    wo = torch.randn((P, el, h, d), generator=gen, device="cuda") * h ** -0.5
    record("mm_a2a_kernel", ca.mm_a2a(hx, wo), ca.plain_mm_a2a(hx, wo),
           ca.plain_mm_a2a(hx.abs(), wo.abs()), h, hx, wo,
           lambda: ca.mm_a2a(hx, wo), lambda: ca.plain_mm_a2a(hx, wo),
           lambda: ca.xla_matmul_alltoall(hx, wo))
    # the dispatch's dw: x travels, dy (the shape of the dispatch's output)
    # stays; two channels, as the bidirectional plan at world 8 orders them
    dy = torch.randn((P, el, P * C, h), generator=gen, device="cuda")
    record("a2a_wgrad_kernel", ca.a2a_wgrad(x, dy, 2),
           ca.plain_a2a_wgrad(x, dy, 2),
           ca.plain_a2a_wgrad(x.abs(), dy.abs(), 2), P * C, x, dy,
           lambda: ca.a2a_wgrad(x, dy, 2),
           lambda: ca.plain_a2a_wgrad(x, dy, 2),
           lambda: torch.einsum("rept,repl->retl",
                                ca._all_to_all_in(x, el), dy))
    log(f"  a2a_wgrad_kernel mirror (the combine's dw, (8, 1, 3072, 768)): "
        f"{time_ms(lambda: ca.a2a_wgrad(x, dy, 2, False), 10)!r} ms")
    del x, w, hx, wo, dy
    torch.cuda.empty_cache()
    return res


#: Megatron-LM 8.3B (Shoeybi et al., 2019, Table 1): hidden 3072, FFN 4 x
#: 3072, 8-way tensor parallel, sequence 1024; two sequences (2048 tokens),
#: one block, dp 1
MEGATRON = {"d": 3072, "h": 12288, "tp": 8, "tokens": 2048}
#: the collective-matmul lane shape (per-rank m, k, n; bench_cmatmul's
#: default)
CMATMUL_LANE = (256, 512, 512)


def cmatmul_operands(gen, P: int, m: int, k: int, n: int):
    """Random f32 operands of one agmm and one mmrs call at a per-rank
    shape: x (P, m, k), the mmrs rows (P, P m, k), w (P, k, n) scaled by
    k^-1/2."""
    import torch
    x = torch.randn((P, m, k), generator=gen, device="cuda")
    xr = torch.randn((P, P * m, k), generator=gen, device="cuda")
    w = torch.randn((P, k, n), generator=gen, device="cuda") * k ** -0.5
    return x, xr, w


def plan_note(plan: dict) -> str:
    """A collective-matmul plan in a few words: its arm and launches."""
    if "ctb" in plan or "msp" in plan:
        return (f"{'stream' if 'ctb' in plan else 'resident'}, ctb "
                f"{plan.get('ctb', plan['ctp'])}, launches "
                f"{plan.get('nctb', 1)}")
    return (f"{plan['mode']}, kb {plan['kb']}, launches "
            f"{plan.get('nmb', plan.get('nnb', 1))}")


#: the kernels that run split-TF32 products on the tensor cores (three TF32
#: products per f32 pair); agmm_kernel runs f32 on the CUDA cores
SPLIT_TF32 = ("mmrs_kernel", "wgrad_kernel")


def cmatmul_calls(gen, P: int, m: int, k: int, n: int) -> dict:
    """agmm_kernel, mmrs_kernel and wgrad_kernel as phases 3f and 3g call
    them at a per-rank agmm shape (m, k, n), f32, bidirectional, each with
    its plan's launches: agmm x (P, m, k) by w (P, k, n); mmrs the
    activations (P, P m, n) by (P, n, k), one launch per column block;
    wgrad x (P, m, k) travelling against dy (P, P m, n), one launch per
    column block of the traveller. Per name: (kernel, plain, library,
    |a| |b| through the plain version, flops, bytes, K, shapes, plan)."""
    import torch
    from accl_tpu_torch.ops import collective_matmul as cm
    x, xr, w = cmatmul_operands(gen, P, m, k, n)
    wr = torch.randn((P, n, k), generator=gen, device="cuda") * n ** -0.5
    hr = xr[..., :n].contiguous()
    ag_plan = cm.agmm_plan(m, k, n, P, torch.float32, True)
    rs_plan = cm.mmrs_plan(P * m, n, k, P, torch.float32, True)
    ag_half = min(ag_plan.get("mb", ag_plan["mp"]) // 2, m)
    nb = rs_plan.get("nb", rs_plan["np"])
    blocks = [(j * nb, min((j + 1) * nb, k))
              for j in range(rs_plan.get("nnb", 1))]
    split = min(rs_plan["cp"] // 2, m)
    ag_k, ag_p = (torch.empty((P, P * m, n), device="cuda")
                  for _ in range(2))
    rs_k, rs_p = (torch.empty((P, m, k), device="cuda") for _ in range(2))
    # dw of the all-gather x matmul: x travels against dy (P, P m, n)
    dy = torch.randn((P, P * m, n), generator=gen, device="cuda")
    dw_plan = cm.wgrad_plan(m, k, n, P, torch.float32, torch.float32, True)
    ctb = dw_plan.get("ctb", dw_plan["ctp"])
    dw_blocks = [(j * ctb, min((j + 1) * ctb, k))
                 for j in range(dw_plan.get("nctb", 1))]
    dw_split = min(dw_plan["msp"] // 2, m)
    dw_k, dw_p = (torch.empty((P, k, n), device="cuda") for _ in range(2))

    def rs(fn, out, a=hr, b=wr):
        for cols in blocks:
            fn(a, b, out, cols, split)
        return out

    def dw(fn, out, a=x, b=dy):
        for cols in dw_blocks:
            fn(a, b, out, cols, dw_split)
        return out

    return {
        "agmm_kernel": (
            lambda: cm.agmm(x, w, ag_k, (0, m), ag_half),
            lambda: cm.plain_agmm(x, w, ag_p, (0, m)),
            lambda: torch.matmul(x.reshape(P * m, k), w),
            lambda: cm.plain_agmm(x.abs(), w.abs()),
            2 * P * (P * m) * k * n,
            (x.numel() + w.numel() + ag_k.numel()) * 4, k,
            [list(x.shape), list(w.shape)], ag_plan),
        "mmrs_kernel": (
            lambda: rs(cm.mmrs, rs_k), lambda: rs(cm.plain_mmrs, rs_p),
            lambda: torch.matmul(hr, wr).view(P, P, m, k).sum(0),
            lambda: rs(cm.plain_mmrs, torch.empty_like(rs_p), hr.abs(),
                       wr.abs()),
            2 * P * (P * m) * n * k,
            (hr.numel() + wr.numel() + rs_k.numel()) * 4, P * n,
            [list(hr.shape), list(wr.shape)], rs_plan),
        "wgrad_kernel": (
            lambda: dw(cm.wgrad, dw_k), lambda: dw(cm.plain_wgrad, dw_p),
            lambda: torch.bmm(x.reshape(P * m, k).t().expand(P, k, P * m),
                              dy),
            lambda: dw(cm.plain_wgrad, torch.empty_like(dw_p), x.abs(),
                       dy.abs()),
            2 * P * (P * m) * k * n,
            (x.numel() + dy.numel() + dw_k.numel()) * 4, P * m,
            [list(x.shape), list(dy.shape)], dw_plan)}


def cmatmul_bounds(name: str, flops: int, nbytes: int, peak: float) -> dict:
    """A collective-matmul kernel's bounds in ms: the bytes (inputs read
    once, the output written once) over 3.35 TB/s, against its operations
    over the rate of the units it runs on: split TF32 (SPLIT_TF32: three
    TF32 products per f32 multiply-add pair, over the tensor cores' 495
    TFLOP/s) or f32 on the CUDA cores (``peak``). Beside them the f32
    CUDA-core bound and the plain TF32 one."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    f32 = flops / peak * 1e3
    ops = 3 * flops / TF32_TC_FLOPS * 1e3 if name in SPLIT_TF32 else f32
    return {"bound_ms": max(by_bytes, ops),
            "bound_by": "bytes" if by_bytes >= ops else "operations",
            "f32_core_bound_ms": max(by_bytes, f32),
            "tensor_core_bound_ms": max(by_bytes,
                                        flops / TF32_TC_FLOPS * 1e3)}


def cmatmul_turns(gen, shape, iters: int) -> dict:
    """Each kernel of :func:`cmatmul_calls` at a per-rank shape (P 8): its
    result held within :func:`f32_sum_bound` of the plain version's, then
    timed in turns with the plain version and the library call
    (:func:`time_in_turns`, the host's launch work hidden). Per name:
    shapes, plan, max_abs_err, ms, plain_ms, library_ms, flops, bytes."""
    import torch
    res = {}
    calls = cmatmul_calls(gen, MEGATRON["tp"], *shape)
    for name, (kern, plain, lib, absf, flops, nbytes, K, shapes,
               plan) in calls.items():
        got, want, mag = kern(), plain(), absf()
        err = (got - want).abs()
        if bool((err > f32_sum_bound(K, mag)).any()):
            fail(f"{name} outside the f32 sum bound at {shapes}")
        del got, want, mag
        ms = time_in_turns([kern, plain, lib], iters)
        res[name] = {"shape": shapes, "plan": plan_note(plan),
                     "max_abs_err": err.max().item(), "ms": ms[0],
                     "plain_ms": ms[1], "library_ms": ms[2], "flops": flops,
                     "bytes": nbytes}
    del calls
    torch.cuda.empty_cache()
    return res


def measure_cmatmul_kernels(gen) -> dict:
    """agmm_kernel, mmrs_kernel and wgrad_kernel at the shapes phases 3f and
    3g give them at Megatron-LM 8.3B's width (:func:`cmatmul_calls`, P 8):
    agmm x (8, 256, 3072) with w1's column blocks (8, 3072, 1536) in one
    launch (the stream plan's nmb 1); mmrs the activations (8, 2048, 1536)
    with w2's row blocks (8, 1536, 3072) in two launches, one per
    1536-column block (nnb 2); wgrad x (8, 256, 3072) travelling against dy
    (8, 2048, 1536) into dw (8, 3072, 1536) in four launches, one per
    768-column block of the traveller (nctb 4); each call's launches timed
    together, in turns with the plain version and the library call
    (:func:`cmatmul_turns`). Bounds: :func:`cmatmul_bounds`. Library:
    ``torch.matmul(x.reshape(P*m, k), w)`` for agmm, ``torch.matmul(x,
    w).view(P, P, mc, n).sum(0)`` for mmrs and one ``torch.bmm`` of the
    transposed gather against dy for wgrad. Then the three at the lane
    shape (the resident plans), logged likewise."""
    peak = f32_peak_flops()
    P = MEGATRON["tp"]
    res = {}
    main = (MEGATRON["tokens"] // P, MEGATRON["d"], MEGATRON["h"] // P)
    for lane, shape, iters in ((False, main, 5), (True, CMATMUL_LANE, 20)):
        for name, r in cmatmul_turns(gen, shape, iters).items():
            r.update(cmatmul_bounds(name, r.pop("flops"), r.pop("bytes"),
                                    peak))
            plan = r.pop("plan")
            if not lane:
                res[name] = r
            log(f"  {name} {'lane shape ' if lane else ''}{r['shape']} "
                f"({plan}), in turns: kernel {r['ms']!r} ms, plain "
                f"{r['plain_ms']!r} ms, library {r['library_ms']!r} ms, bound "
                f"{r['bound_ms']!r} ms ({r['bound_by']}; f32 CUDA cores "
                f"{r['f32_core_bound_ms']!r}, TF32 "
                f"{r['tensor_core_bound_ms']!r}), max_abs_err "
                f"{r['max_abs_err']!r}")
    return res


#: 32-bit integer operations of ``sr_kernel`` per element: the index
#: multiply, xor, the hash's three xor-shifts and two multiplies, the
#: NaN test (and, compare), the add, mask and shift of the rounding
SR_INT_OPS = 16


# ---------------------------------------------------------------------------
# phase 2: the flash attention kernels (rows 21-24)
# ---------------------------------------------------------------------------

#: H100 SXM dense bf16 tensor-core rate (FLOP/s), NVIDIA's data sheet: the
#: bound of bf16 attention on the tensor cores, a later wgmma redesign's
#: target
BF16_TC_FLOPS = 989e12
#: Megatron-LM 8.3B's attention (Shoeybi et al., 2019, Table 1): hidden
#: 3072 as 32 heads of 96, multi-head; context-parallel at world 8 over a
#: global sequence of 8192 tokens (n 1024 per rank), causal
ATTN = {"H": 32, "d": 96, "P": 8, "n": 1024}


def flash_flops(H: int, S: int, d: int, causal: bool) -> int:
    """Useful flops of one attention forward: two S x S x d products per
    head, 4 H S^2 d, half of that causal. A backward does 2.5 times that
    (five products); its dK/dV pass alone 2 times (s, dP, dV, dK), its dQ
    pass 1.5 times (s, dP, dQ)."""
    f = 4 * H * S * S * d
    return f // 2 if causal else f


def near(what: str, got, want, rel: float) -> float:
    """Fail unless max|got - want| <= rel max|want|; returns the ratio
    max|got - want| / max|want|."""
    top = want.double().abs().max().item()
    err = (got.double() - want.double()).abs().max().item()
    if not err <= rel * top:
        fail(f"{what}: max|err| {err!r} > {rel} x max|want| {top!r}")
    return err / top


def attn_operands(gen, H: int, hkv: int, S: int, d: int, dtype):
    """Random q (H, S, d), k and v (H_kv, S, d) and an output cotangent, in
    dtype."""
    import torch

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return r(H, S, d), r(hkv, S, d), r(hkv, S, d), r(H, S, d)


def check_flash_kernels(gen) -> None:
    """Rows 21-24 against their plain versions on the card, f32 within 1e-5
    and bf16 within 1e-2 of each tensor's largest magnitude: f32 and bf16,
    causal and not, d 64 / 96 / 128, H = H_kv and H = 4 H_kv, S 128, 1024
    and 8192. Every backward twice: the two runs, and the fused and the
    two-pass arms, bit-equal. Then the entry points ``flash_attention`` and
    ``flash_attention_lse`` (with and without an lse cotangent) under
    ``bwd_mode`` fused and two_pass at S 1024 and at S 16384, where the JAX
    backward policy answers None and sends even the fused mode to the
    two-pass pair: the launch counters must show the arm the policy picks,
    and the gradients match the plain versions."""
    import torch
    from accl_tpu_torch.ops import flash as fl

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(2, 2, 128, 64, False, f32), (8, 2, 128, 96, True, bf16),
             (4, 1, 1024, 128, True, f32), (4, 4, 1024, 64, False, bf16),
             (8, 2, 1024, 96, False, f32), (2, 2, 1024, 128, True, bf16),
             (4, 4, 8192, 96, True, f32), (4, 1, 8192, 64, True, bf16),
             (2, 2, 8192, 128, False, f32)]
    worst = {}
    for H, hkv, S, d, causal, dt in cases:
        case = f"H {H} H_kv {hkv} S {S} d {d} causal {causal} {dt}"
        rel = 1e-5 if dt == f32 else 1e-2
        q, k, v, do = attn_operands(gen, H, hkv, S, d, dt)
        sc = d ** -0.5
        out, lse = fl.flash_fwd(q, k, v, causal, sc)
        pout, plse = fl.plain_flash_fwd(q, k, v, causal, sc)
        errs = [near(f"flash_fwd_kernel out {case}", out, pout, rel),
                near(f"flash_fwd_kernel lse {case}", lse, plse, rel)]
        dd = (do.float() * out.float()).sum(-1) - torch.randn(
            (H, S), generator=gen, device="cuda")
        args = (q, k, v, do, lse, dd, causal, sc)
        fused = [fl.flash_bwd_fused(*args) for _ in range(2)]
        two = [(fl.flash_bwd_q(*args), *fl.flash_bwd_kv(*args))
               for _ in range(2)]
        plain = fl.plain_flash_bwd_fused(*args)
        pkv, pq = fl.plain_flash_bwd_kv(*args), fl.plain_flash_bwd_q(*args)
        for i, name in enumerate(("dq", "dk", "dv")):
            errs.append(near(f"flash_bwd_fused_kernel {name} {case}",
                             fused[0][i], plain[i], rel))
            errs.append(near(
                f"flash_bwd_{'q' if i == 0 else 'kv'}_kernel {name} {case}",
                two[0][i], pq if i == 0 else pkv[i - 1], rel))
            for other, what in ((fused[1][i], "a second fused run"),
                                (two[0][i], "the two-pass pair"),
                                (two[1][i], "a second two-pass run")):
                if not torch.equal(fused[0][i], other):
                    fail(f"flash backward {name} {case}: the fused kernel's "
                         f"bits differ from {what}")
        worst[case] = max(errs)
        del q, k, v, do, out, lse, pout, plse, dd, args, fused, two, plain
    torch.cuda.empty_cache()
    log(f"  flash kernels: {len(cases)} cases, each backward bit-equal over "
        f"two runs and across the arms; worst error / max per case "
        f"{json.dumps(worst)}")
    check_flash_entry_points(gen)


def check_flash_entry_points(gen) -> None:
    import torch
    from accl_tpu_torch.ops import flash as fl

    for H, hkv, S, d in ((4, 2, 1024, 96), (2, 2, 16384, 128)):
        q, k, v, do = attn_operands(gen, H, hkv, S, d, torch.float32)
        dlse = torch.randn((H, S), generator=gen, device="cuda")
        sc = d ** -0.5
        pout, plse = fl.plain_flash_fwd(q, k, v, True, sc)
        arm = fl._bwd_default_blocks(S, 128, True, 4)
        for with_lse in (True, False):
            dd = (do * pout).sum(-1) - (dlse if with_lse else 0.0)
            want = fl.plain_flash_bwd_fused(q, k, v, do, plse, dd, True, sc)
            for mode in ("fused", "two_pass"):
                case = (f"H {H} S {S} d {d} bwd_mode {mode} lse cotangent "
                        f"{with_lse}")
                ts = [t.detach().requires_grad_() for t in (q, k, v)]
                reset_counts()
                if with_lse:
                    o, l = fl.flash_attention_lse(*ts, causal=True,
                                                  bwd_mode=mode)
                    ((o * do).sum() + (l * dlse).sum()).backward()
                else:
                    o = fl.flash_attention(*ts, causal=True, bwd_mode=mode)
                    (o * do).sum().backward()
                c = counts()
                fused = mode == "fused" and arm is not None
                if c["flash_fwd_kernel"] != 1 or \
                        (c["flash_bwd_fused_kernel"] > 0) != fused or \
                        c["flash_bwd_kv_kernel"] != (0 if fused else 1) or \
                        c["flash_bwd_q_kernel"] != (0 if fused else 1):
                    fail(f"flash entry point {case} (policy {arm}) launched "
                         f"{json.dumps({k: v for k, v in c.items() if v})}")
                near(f"flash entry point out {case}", o.detach(), pout, 1e-5)
                for t, w, name in zip(ts, want, ("dq", "dk", "dv")):
                    near(f"flash entry point {name} {case}", t.grad, w, 1e-5)
        log(f"  flash entry points at H {H} S {S} d {d}: the JAX backward "
            f"policy gives {arm}, so bwd_mode fused runs "
            f"{'the fused kernel' if arm else 'the two-pass pair'}; outputs "
            f"and gradients match the plain versions")
        del q, k, v, do, dlse, pout, plse, want
    torch.cuda.empty_cache()


def measure_flash_kernels(gen) -> dict:
    """Rows 21-24 at the shape phase 3i gives them (:data:`ATTN`: Ulysses at
    world 8 puts every rank's heads into one call, q, k and v (32, 8192,
    96), causal), f32: kernel, plain version and ``scaled_dot_product_
    attention`` on (1, 32, 8192, 96) (the forward alone; the backward as
    forward plus backward less forward, the yardstick of row 22 and of the
    two-pass pair together; rows 23 and 24 have no call of their own).
    Bounds: the useful flops (:func:`flash_flops`) over the CUDA cores' f32
    rate, or the bytes (inputs read once, outputs written once) over 3.35
    TB/s where larger; beside them the TF32 tensor cores' bound. Then the
    forward and the fused backward in bf16 beside SDPA in bf16 and the bf16
    tensor cores' bound, logged."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import flash as fl

    H, d, S = ATTN["H"], ATTN["d"], ATTN["P"] * ATTN["n"]
    peak = f32_peak_flops()
    fwd = flash_flops(H, S, d, True)
    sc = d ** -0.5
    res, bf16_note = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        isz = torch.empty((), dtype=dt).element_size()
        q, k, v, do = attn_operands(gen, H, H, S, d, dt)
        out, lse = fl.flash_fwd(q, k, v, True, sc)
        dd = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, dd, True, sc)
        q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
        do4 = do[None]

        def sdpa():
            with torch.no_grad():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True,
                                                      scale=sc)

        def sdpa_fb():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                           scale=sc).backward(do4)

        lib_fwd = time_ms(sdpa, 5)
        lib_bwd = time_ms(sdpa_fb, 5) - lib_fwd
        hsd = H * S * d
        io = {"flash_fwd_kernel": 4 * hsd * isz + H * S * 4,
              "flash_bwd_fused_kernel": 4 * hsd * isz + 2 * H * S * 4
              + 3 * hsd * 4,
              "flash_bwd_kv_kernel": 4 * hsd * isz + 2 * H * S * 4
              + 2 * hsd * 4,
              "flash_bwd_q_kernel": 4 * hsd * isz + 2 * H * S * 4 + hsd * 4}
        flops = {"flash_fwd_kernel": fwd,
                 "flash_bwd_fused_kernel": 5 * fwd // 2,
                 "flash_bwd_kv_kernel": 2 * fwd,
                 "flash_bwd_q_kernel": 3 * fwd // 2}
        calls = {"flash_fwd_kernel": (lambda: fl.flash_fwd(q, k, v, True, sc),
                                      lambda: fl.plain_flash_fwd(q, k, v,
                                                                 True, sc)),
                 "flash_bwd_fused_kernel": (
                     lambda: fl.flash_bwd_fused(*args),
                     lambda: fl.plain_flash_bwd_fused(*args)),
                 "flash_bwd_kv_kernel": (lambda: fl.flash_bwd_kv(*args),
                                         lambda: fl.plain_flash_bwd_kv(*args)),
                 "flash_bwd_q_kernel": (lambda: fl.flash_bwd_q(*args),
                                        lambda: fl.plain_flash_bwd_q(*args))}
        if dt == torch.bfloat16:
            for name in ("flash_fwd_kernel", "flash_bwd_fused_kernel"):
                ms = time_ms(calls[name][0], 3)
                by_bytes = io[name] / HBM_BYTES_PER_S * 1e3
                bf16_note[name] = {
                    "ms": ms, "tensor_core_bound_ms": max(
                        by_bytes, flops[name] / BF16_TC_FLOPS * 1e3),
                    "f32_cuda_core_bound_ms": max(
                        by_bytes, flops[name] / peak * 1e3),
                    "library_ms": lib_fwd if name == "flash_fwd_kernel"
                    else lib_bwd}
            log(f"  flash bf16 at q (32, 8192, 96) causal: "
                f"{json.dumps(bf16_note)}")
        else:
            for name, (kern, plain) in calls.items():
                got, want = kern(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                err = max((a.double() - b.double()).abs().max().item()
                          for a, b in zip(got, want))
                del got, want
                by_bytes = io[name] / HBM_BYTES_PER_S * 1e3
                by_ops = flops[name] / peak * 1e3
                res[name] = {
                    "shape": [[H, S, d], [H, S, d]], "max_abs_err": err,
                    "ms": time_ms(kern, 5),
                    "plain_ms": time_ms(plain, 1),
                    "library_ms": {"flash_fwd_kernel": lib_fwd,
                                   "flash_bwd_fused_kernel": lib_bwd}.get(
                                       name),
                    "bound_ms": max(by_bytes, by_ops),
                    "bound_by": "bytes" if by_bytes >= by_ops
                    else "operations",
                    "tensor_core_bound_ms": max(
                        by_bytes, flops[name] / TF32_TC_FLOPS * 1e3)}
                r = res[name]
                log(f"  {name} q (32, 8192, 96) causal f32: kernel "
                    f"{r['ms']!r} ms, plain {r['plain_ms']!r} ms, library "
                    f"{r['library_ms']!r} ms, bound {r['bound_ms']!r} ms "
                    f"({r['bound_by']}; TF32 tensor cores "
                    f"{r['tensor_core_bound_ms']!r} ms), max_abs_err "
                    f"{r['max_abs_err']!r}")
            log(f"  SDPA f32 backward (dq, dk, dv; the two-pass pair's "
                f"yardstick together): {lib_bwd!r} ms")
        del q, k, v, do, out, lse, dd, args, q4, k4, v4, do4, calls
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 2: the head-packed flash kernels (rows 25-28)
# ---------------------------------------------------------------------------

#: Switch-Base-8's attention (``google/switch-base-8``: d_model 768 as 12
#: heads of d_kv 64) at phases 3e and 3h's world 8 and 2048 tokens per
#: rank; ranks x heads form the leading axis, so q, k and v are (96, 2048,
#: 64), packed (48, 2048, 128)
PACKED = {"H": SWITCH["P"] * 12, "S": SWITCH["n"], "d": 64}


def pack_operands(gen, H: int, S: int, dtype):
    """Random q, k, v and an output cotangent (H, S, 64) in dtype, then the
    same four packed, (H/2, S, 128)."""
    from accl_tpu_torch.ops import flash as fl
    heads = attn_operands(gen, H, H, S, PACKED["d"], dtype)
    return heads, [fl._pack_heads(t) for t in heads]


def check_flash_packed_kernels(gen) -> None:
    """Rows 25-28 against their plain versions on the card, f32 within 1e-5
    and bf16 within 1e-2 of each tensor's largest magnitude, and against
    the general kernels (rows 21-24) on the unpacked heads, bit for bit:
    f32 and bf16, causal and not, H 2, 4 and 96, S 128, 1024 and 2048.
    Every backward twice: the two runs, and the fused and the two-pass
    arms, bit-equal. Then ``flash_attention_packed`` under ``bwd_mode``
    fused and two_pass at S 1024 and at S 16384 causal, where the JAX
    backward policy answers None and sends the fused mode to the packed
    two-pass pair: the counters must show the arm the policy picks and no
    general kernel, the gradients match the plain versions."""
    import torch
    from accl_tpu_torch.ops import flash as fl

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(2, 128, False, f32), (4, 128, True, bf16),
             (2, 1024, True, bf16), (4, 1024, False, f32),
             (96, 2048, False, f32), (96, 2048, True, f32),
             (96, 2048, True, bf16), (4, 2048, False, bf16)]
    worst = {}
    for H, S, causal, dt in cases:
        case = f"H {H} S {S} causal {causal} {dt}"
        rel = 1e-5 if dt == f32 else 1e-2
        (q, k, v, do), packed = pack_operands(gen, H, S, dt)
        qp, kp, vp, dop = packed
        sc = PACKED["d"] ** -0.5
        out, lse = fl.flash_fwd_packed(qp, kp, vp, causal, sc)
        pout, plse = fl.plain_flash_fwd_packed(qp, kp, vp, causal, sc)
        errs = [near(f"flash_fwd_packed_kernel out {case}", out, pout, rel),
                near(f"flash_fwd_packed_kernel lse {case}", lse, plse, rel)]
        gout, glse = fl.flash_fwd(q, k, v, causal, sc)
        if not (torch.equal(fl._unpack_heads(out), gout)
                and torch.equal(lse.reshape(H, S), glse)):
            fail(f"flash_fwd_packed_kernel {case}: bits differ from "
                 f"flash_fwd_kernel's on the unpacked heads")
        dd = (dop.float() * out.float()).reshape(H // 2, S, 2, 64).sum(-1) \
            .transpose(1, 2).contiguous() - torch.randn(
                (H // 2, 2, S), generator=gen, device="cuda")
        args = (qp, kp, vp, dop, lse, dd, causal, sc)
        fused = [fl.flash_bwd_fused_packed(*args) for _ in range(2)]
        two = [(fl.flash_bwd_q_packed(*args), *fl.flash_bwd_kv_packed(*args))
               for _ in range(2)]
        plain = fl.plain_flash_bwd_fused_packed(*args)
        pkv = fl.plain_flash_bwd_kv_packed(*args)
        pq = fl.plain_flash_bwd_q_packed(*args)
        general = fl.flash_bwd_fused(q, k, v, do, glse, dd.reshape(H, S),
                                     causal, sc)
        for i, name in enumerate(("dq", "dk", "dv")):
            errs.append(near(f"flash_bwd_fused_packed_kernel {name} {case}",
                             fused[0][i], plain[i], rel))
            errs.append(near(
                f"flash_bwd_{'q' if i == 0 else 'kv'}_packed_kernel {name} "
                f"{case}", two[0][i], pq if i == 0 else pkv[i - 1], rel))
            for other, what in ((fused[1][i], "a second fused run"),
                                (two[0][i], "the two-pass pair"),
                                (two[1][i], "a second two-pass run")):
                if not torch.equal(fused[0][i], other):
                    fail(f"packed flash backward {name} {case}: the fused "
                         f"kernel's bits differ from {what}")
            if not torch.equal(fl._unpack_heads(fused[0][i]), general[i]):
                fail(f"packed flash backward {name} {case}: bits differ "
                     f"from flash_bwd_fused_kernel's on the unpacked heads")
        worst[case] = max(errs)
        del q, k, v, do, packed, qp, kp, vp, dop, out, lse, pout, plse, gout
        del glse, dd, args, fused, two, plain, pkv, pq, general
    torch.cuda.empty_cache()
    log(f"  packed flash kernels: {len(cases)} cases, each bit-equal to the "
        f"general kernels at d 64, each backward bit-equal over two runs and "
        f"across the arms; worst error / max per case {json.dumps(worst)}")
    check_flash_packed_entry(gen)


def check_flash_packed_entry(gen) -> None:
    import torch
    from accl_tpu_torch.ops import flash as fl

    for H, S in ((4, 1024), (2, 16384)):
        (q, k, v, do), _ = pack_operands(gen, H, S, torch.float32)
        sc = PACKED["d"] ** -0.5
        pout, plse = fl.plain_flash_fwd(q, k, v, True, sc)
        dd = (do * pout).sum(-1)
        want = fl.plain_flash_bwd_fused(q, k, v, do, plse, dd, True, sc)
        arm = fl._bwd_default_blocks(S, 2 * PACKED["d"], True, 4)
        for mode in ("fused", "two_pass"):
            case = f"H {H} S {S} bwd_mode {mode}"
            (o, grads), c = launched(lambda: step(
                lambda *t: fl.flash_attention_packed(*t, causal=True,
                                                     bwd_mode=mode),
                (q, k, v), do))
            fused = mode == "fused" and arm is not None
            want_l = {"flash_fwd_packed_kernel": 1}
            if fused:
                want_l["flash_bwd_fused_packed_kernel"] = 1
            else:
                want_l.update(flash_bwd_kv_packed_kernel=1,
                              flash_bwd_q_packed_kernel=1)
            if c != want_l:
                fail(f"packed flash entry point {case} (policy {arm}) "
                     f"launched {json.dumps(c)}")
            near(f"packed flash entry point out {case}", o, pout, 1e-5)
            for t, w, name in zip(grads, want, ("dq", "dk", "dv")):
                near(f"packed flash entry point {name} {case}", t, w, 1e-5)
        log(f"  packed flash entry point at H {H} S {S}: the JAX backward "
            f"policy gives {arm}, so bwd_mode fused runs "
            f"{'the fused kernel' if arm else 'the two-pass pair'}; outputs "
            f"and gradients match the plain versions")
        del q, k, v, do, pout, plse, dd, want
    torch.cuda.empty_cache()


def measure_flash_packed_kernels(gen) -> dict:
    """Rows 25-28 at the shape phase 3l gives them (:data:`PACKED`: q, k
    and v (96, 2048, 64), packed (48, 2048, 128)), f32, non-causal (the
    encoder's attention) and causal (the decoder's): kernel, plain version,
    the general kernel (rows 21-24) on the unpacked heads, and
    ``scaled_dot_product_attention`` on (1, 96, 2048, 64) (the forward;
    the backward as forward plus backward less forward, row 26's yardstick
    and the two-pass pair's together). Bounds as rows 21-24's: the useful
    flops over the CUDA cores' f32 rate, or the bytes over 3.35 TB/s where
    larger, the TF32 tensor cores' bound beside. The entry carries the
    non-causal figures, the causal ones beside them."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import flash as fl

    H, S, d = PACKED["H"], PACKED["S"], PACKED["d"]
    peak = f32_peak_flops()
    sc = d ** -0.5
    hsd = H * S * d
    io = {"flash_fwd_packed_kernel": 4 * hsd * 4 + H * S * 4,
          "flash_bwd_fused_packed_kernel": 4 * hsd * 4 + 2 * H * S * 4
          + 3 * hsd * 4,
          "flash_bwd_kv_packed_kernel": 4 * hsd * 4 + 2 * H * S * 4
          + 2 * hsd * 4,
          "flash_bwd_q_packed_kernel": 4 * hsd * 4 + 2 * H * S * 4
          + hsd * 4}
    res = {}
    for causal in (False, True):
        fwd = flash_flops(H, S, d, causal)
        flops = {"flash_fwd_packed_kernel": fwd,
                 "flash_bwd_fused_packed_kernel": 5 * fwd // 2,
                 "flash_bwd_kv_packed_kernel": 2 * fwd,
                 "flash_bwd_q_packed_kernel": 3 * fwd // 2}
        (q, k, v, do), (qp, kp, vp, dop) = pack_operands(gen, H, S,
                                                         torch.float32)
        out, lse = fl.flash_fwd_packed(qp, kp, vp, causal, sc)
        dd = (dop * out).reshape(H // 2, S, 2, d).sum(-1).transpose(
            1, 2).contiguous()
        args = (qp, kp, vp, dop, lse, dd, causal, sc)
        gargs = (q, k, v, do, lse.reshape(H, S), dd.reshape(H, S), causal,
                 sc)
        q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
        do4 = do[None]

        def sdpa():
            with torch.no_grad():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=causal,
                                                      scale=sc)

        def sdpa_fb():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                           scale=sc).backward(do4)

        lib_fwd = time_ms(sdpa, 5)
        lib_bwd = time_ms(sdpa_fb, 5) - lib_fwd
        calls = {
            "flash_fwd_packed_kernel": (
                lambda: fl.flash_fwd_packed(qp, kp, vp, causal, sc),
                lambda: fl.plain_flash_fwd_packed(qp, kp, vp, causal, sc),
                lambda: fl.flash_fwd(q, k, v, causal, sc)),
            "flash_bwd_fused_packed_kernel": (
                lambda: fl.flash_bwd_fused_packed(*args),
                lambda: fl.plain_flash_bwd_fused_packed(*args),
                lambda: fl.flash_bwd_fused(*gargs)),
            "flash_bwd_kv_packed_kernel": (
                lambda: fl.flash_bwd_kv_packed(*args),
                lambda: fl.plain_flash_bwd_kv_packed(*args),
                lambda: fl.flash_bwd_kv(*gargs)),
            "flash_bwd_q_packed_kernel": (
                lambda: fl.flash_bwd_q_packed(*args),
                lambda: fl.plain_flash_bwd_q_packed(*args),
                lambda: fl.flash_bwd_q(*gargs))}
        for name, (kern, plain, general) in calls.items():
            by_bytes = io[name] / HBM_BYTES_PER_S * 1e3
            by_ops = flops[name] / peak * 1e3
            r = {"ms": time_ms(kern, 5), "general_ms": time_ms(general, 5),
                 "library_ms": {"flash_fwd_packed_kernel": lib_fwd,
                                "flash_bwd_fused_packed_kernel": lib_bwd
                                }.get(name),
                 "bound_ms": max(by_bytes, by_ops),
                 "bound_by": "bytes" if by_bytes >= by_ops
                 else "operations",
                 "tensor_core_bound_ms": max(
                     by_bytes, flops[name] / TF32_TC_FLOPS * 1e3)}
            if not causal:
                got, want = kern(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                r["max_abs_err"] = max(
                    (a.double() - b.double()).abs().max().item()
                    for a, b in zip(got, want))
                del got, want
                r["plain_ms"] = time_ms(plain, 1)
                r["shape"] = [[H // 2, S, 2 * d], [H // 2, S, 2 * d]]
                res[name] = r
            else:
                res[name].update(causal_ms=r["ms"],
                                 causal_general_ms=r["general_ms"],
                                 causal_library_ms=r["library_ms"],
                                 causal_bound_ms=r["bound_ms"])
            mask = "causal" if causal else "non-causal"
            log(f"  {name} q (48, 2048, 128) {mask} f32: kernel "
                f"{r['ms']!r} ms, general kernel on the "
                f"unpacked heads {r['general_ms']!r} ms, plain "
                f"{res[name]['plain_ms']!r} ms (non-causal), library "
                f"{r['library_ms']!r} ms, "
                f"bound {r['bound_ms']!r} ms ({r['bound_by']}; TF32 tensor "
                f"cores {r['tensor_core_bound_ms']!r} ms)")
        log(f"  SDPA f32 {'causal ' if causal else ''}backward (dq, dk, dv; "
            f"the two-pass pair's yardstick together): {lib_bwd!r} ms")
        del q, k, v, do, qp, kp, vp, dop, out, lse, dd, args, gargs, calls
        del q4, k4, v4, do4
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 2: the paged decode kernels (rows 29-30)
# ---------------------------------------------------------------------------

#: K-EXAONE-236B-A23B's global-attention layers (LG AI Research,
#: ``LGAI-EXAONE/K-EXAONE-236B-A23B`` config.json): hidden 6144, 64 query
#: heads over 8 KV heads of 128; tp 8 (one KV head, eight query heads a
#: rank); a serving batch of 32 slots of 8192 tokens in pages of 64
EXAONE = {"d_model": 6144, "H": 64, "hkv": 8, "hd": 128, "tp": 8,
          "slots": 32, "page": 64, "pmax": 128}
#: the tolerance of the decode kernels against their plain version, and of
#: phase 3j's arms against each other and float64: f32 sums in another
#: order, relative to the output's largest magnitude
DECODE_REL = 1e-5
#: the same with a bf16 pool, where P is rounded to bf16 inside the sweep:
#: a score one f32 ulp apart (the kernel's and cuBLAS's sums) can move p
#: across a bf16 rounding boundary, 2^-9 of p (1.4e-5 of scale seen at
#: this width)
DECODE_BF16_REL = 1e-3


def decode_pools(gen, slots: int, pool: str):
    """Random f32 K and V pools at EXAONE's width for ``slots`` slots, in
    the at-rest dtype ``pool`` ("f32", "bf16", "int8" or "int8pp", int8
    with per-(head, page) scales: K's grid for both), a shuffled disjoint
    block table, and the scales."""
    import torch
    from accl_tpu_torch.ops import flash as fl
    E = EXAONE
    shape = (E["hkv"], slots * E["pmax"], E["page"], E["hd"])
    kf, vf = (torch.randn(shape, generator=gen, device="cuda")
              for _ in range(2))
    scales = None
    if pool == "int8pp":
        kp, scales = fl.quantize_kv_paged(kf, "int8")
        vp = torch.clamp(torch.round(vf * scales[:, :, None, None]), -127,
                         127).to(torch.int8)
    else:
        dt = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}[pool]
        kp, vp = (fl.quantize_kv(t, dt, "off") for t in (kf, vf))
    bt = torch.randperm(slots * E["pmax"], generator=gen,
                        device="cuda").to(torch.int32).reshape(
                            slots, E["pmax"])
    return kp, vp, bt, scales


def check_decode_kernels(gen) -> None:
    """Rows 29-30 against their plain version at EXAONE's width (64 query
    heads over 8 KV heads, d 128, page 64, 128 pages a slot) over the CPU
    test's grid: f32, bf16 and int8 pools, int8 with per-page scales; the
    decode kernel over 4 slots of lengths 0, one page, full capacity and a
    ragged 61% of it, the span kernel over one prefill chunk of 448 rows
    from 0, from half the capacity and ending at full capacity; within
    :data:`DECODE_REL` of the largest magnitude (bf16 pools
    :data:`DECODE_BF16_REL`), a slot of length 0 exact zeros."""
    import torch
    from accl_tpu_torch.ops import flash as fl
    E = EXAONE
    g, cap, C = E["H"] // E["hkv"], E["pmax"] * E["page"], 448
    worst = {}
    for pool in ("f32", "bf16", "int8", "int8pp"):
        kp, vp, bt, scales = decode_pools(gen, 4, pool)
        q4 = torch.randn((4, E["hkv"], g, E["hd"]), generator=gen,
                         device="cuda")
        lens = torch.tensor([0, E["page"], cap, cap * 61 // 100],
                            dtype=torch.int32, device="cuda")
        got = fl.paged_decode(q4, kp, vp, bt, lens, E["hd"] ** -0.5, scales)
        if not bool((got[0] == 0).all()):
            fail(f"flash_decode_kernel {pool}: a slot of length 0 is not 0")
        want = fl.plain_paged_decode(q4, kp, vp, bt, lens, E["hd"] ** -0.5,
                                     1, scales)
        rel = DECODE_BF16_REL if pool == "bf16" else DECODE_REL
        worst[f"decode {pool}"] = near(f"flash_decode_kernel {pool}", got,
                                       want, rel)
        q4 = torch.randn((1, E["hkv"], g * C, E["hd"]), generator=gen,
                         device="cuda")
        for end in (C, cap // 2 + C, cap):
            lens = torch.tensor([end], dtype=torch.int32, device="cuda")
            args = (q4, kp, vp, bt[:1].contiguous(), lens, E["hd"] ** -0.5,
                    C, scales)
            worst[f"span {pool} to {end}"] = near(
                f"flash_decode_span_kernel {pool} to {end}",
                fl.paged_decode_span(*args), fl.plain_paged_decode(*args),
                rel)
        del kp, vp, q4, got, want
    torch.cuda.empty_cache()
    log(f"  decode kernels at K-EXAONE-236B's width: worst error / max per "
        f"case {json.dumps(worst)}")


def decode_library_ms(q, kp, vp, bt, lens, span: int) -> float:
    """One ``scaled_dot_product_attention`` call (``enable_gqa``) over the
    chains gathered before the timer starts, with the length (span 1) or
    causal-horizon mask: the yardstick, excluding the gather; timed only."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import flash as fl
    B, H = q.shape[0], q.shape[1]
    n = int(lens.max())
    k = fl._gather_pages(kp, bt)[:, :, :n].contiguous()
    v = fl._gather_pages(vp, bt)[:, :, :n].contiguous()
    cols = torch.arange(n, device="cuda")
    rows = torch.arange(q.shape[2], device="cuda")
    horizon = lens.long()[:, None] - span + 1 + rows[None, :]   # (B, rows)
    mask = (cols[None, None, :] < horizon[:, :, None])[:, None]
    with torch.no_grad():
        return time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=q.shape[-1] ** -0.5,
            enable_gqa=True), 5)


def measure_decode_kernels(gen) -> dict:
    """Rows 29-30 at phase 3j's shapes, f32: the decode kernel over 32
    slots at lengths staggered around 3/4 of the 8192-token capacity
    (``bench_flash_decode``'s ``3 cap / 4 - i page / 2``), the span kernel
    over one 448-row prefill chunk (the plan's own pick) starting half the
    capacity, 4096 tokens, into a slot. Kernel, plain version and SDPA (see
    :func:`decode_library_ms`). Bounds: row 29 the live pages of every
    chain (whole pages) plus q and out over 3.35 TB/s; row 30 the larger of
    those bytes and its useful flops, 4 d per (query row, attended
    position) and KV head, over the CUDA cores' f32 rate (TF32 tensor cores
    beside)."""
    import torch
    from accl_tpu_torch.ops import flash as fl
    E = EXAONE
    B, hkv, d, page = E["slots"], E["hkv"], E["hd"], E["page"]
    g, cap = E["H"] // hkv, E["pmax"] * page
    plan, _ = fl.prefill_plan(g, 1, d, page, E["pmax"], 4)
    C = plan["chunk"]
    kp, vp, bt, _ = decode_pools(gen, B, "f32")
    sc = d ** -0.5
    peak = f32_peak_flops()
    res = {}
    lens = torch.tensor([3 * cap // 4 - i * page // 2 for i in range(B)],
                        dtype=torch.int32, device="cuda")
    dplan, _ = fl.decode_plan(B, E["H"], hkv, d, page, E["pmax"], 4)
    q4 = torch.randn((B, hkv, dplan["gp"], d), generator=gen, device="cuda")
    pages = sum(-(-int(x) // page) for x in lens.tolist())
    io = pages * page * d * 4 * 2 * hkv + 2 * q4.numel() * 4
    qs = q4[:, :, :g].reshape(B, g * hkv, 1, d)
    got, want = (fl.paged_decode(q4, kp, vp, bt, lens, sc),
                 fl.plain_paged_decode(q4, kp, vp, bt, lens, sc))
    res["flash_decode_kernel"] = {
        "shape": [list(q4.shape), list(kp.shape)],
        "max_abs_err": (got - want).abs().max().item(),
        "ms": time_ms(lambda: fl.paged_decode(q4, kp, vp, bt, lens, sc), 10),
        "plain_ms": time_ms(lambda: fl.plain_paged_decode(
            q4, kp, vp, bt, lens, sc), 3),
        "library_ms": decode_library_ms(qs, kp, vp, bt, lens, 1),
        "bound_ms": io / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "live_pages": pages}
    del got, want, qs
    # one chunk of the plan's size, half the capacity (4096 tokens) into
    # slot 0
    start = cap // 2
    lens1 = torch.tensor([start + C], dtype=torch.int32, device="cuda")
    bt1 = bt[:1].contiguous()
    q4 = torch.randn((1, hkv, plan["gp"], d), generator=gen, device="cuda")
    horizon = sum(start + 1 + r % C for r in range(g * C))
    flops = 4 * horizon * d * hkv
    io = (-(-(start + C) // page) * page * d * 4 * 2 * hkv
          + 2 * q4.numel() * 4)
    by_bytes, by_ops = io / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    qs = q4.reshape(hkv, g, C, d).reshape(1, hkv * g, C, d)
    args = (q4, kp, vp, bt1, lens1, sc, C)
    got, want = fl.paged_decode_span(*args), fl.plain_paged_decode(*args)
    res["flash_decode_span_kernel"] = {
        "shape": [[1, hkv, plan["gp"], d], list(kp.shape)],
        "max_abs_err": (got - want).abs().max().item(),
        "ms": time_ms(lambda: fl.paged_decode_span(*args), 10),
        "plain_ms": time_ms(lambda: fl.plain_paged_decode(*args), 3),
        "library_ms": decode_library_ms(qs, kp, vp, bt1, lens1, C),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "tensor_core_bound_ms": max(by_bytes, flops / TF32_TC_FLOPS * 1e3),
        "useful_gflop": flops / 1e9}
    for name, r in res.items():
        log(f"  {name} {r['shape']} f32: kernel {r['ms']!r} ms, plain "
            f"{r['plain_ms']!r} ms, SDPA (gather excluded) "
            f"{r['library_ms']!r} ms, bound {r['bound_ms']!r} ms "
            f"({r['bound_by']}), max_abs_err {r['max_abs_err']!r}")
    del kp, vp, q4, got, want, qs, args
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 2: the pipeline relay kernel (row 20)
# ---------------------------------------------------------------------------

#: phase 3k's stage: Megatron-LM 8.3B's block (hidden 3072, FFN 12288, 32
#: heads of 96; Shoeybi et al. 2019, Table 1), 512 rows per microbatch, 8
#: microbatches
PIPE = {"d": 3072, "h": 12288, "heads": 32, "rows": 512, "M": 8}
#: the scale of phase 3k's inputs and targets. The block has no norm, so
#: each sublayer about doubles the activations' variance down the stages,
#: and the attention scores grow as its square: from inputs at 0.3 N(0, 1)
#: (the JAX suite's scale) the last stages' softmax saturates and float32
#: rounding differences grow to percents of the gradients against float64
#: (a CPU run of 8 stages at d 256, 128 rows), at 0.1 and below they stay
#: near 1e-6
XSCALE = 0.03


def relay_operands(shape, dtype, gen):
    """Random relay payloads, the float ones with NaN, -NaN, +0 and -0 at
    their start."""
    import torch
    t = make(shape, dtype, gen)
    if t.is_floating_point():
        sp = torch.tensor([float("nan"), -float("nan"), 0.0, -0.0],
                          device="cuda").to(dtype)
        flat = t.view(-1)
        flat[:min(4, flat.numel())] = sp[:flat.numel()]
    return t


def check_pp_relay_kernel(gen) -> None:
    """pp_relay_kernel against its plain version and against torch.roll, by
    bits: P in {2, 3, 8}, lanes 1 and 2, payloads of one element, one
    segment, a ragged multi-segment length (f32: 3 segments, lanes not
    16-byte aligned) and the main path's (512, 3072); f32, bf16 and int32
    (and int8 on the one-element payload, the byte path), NaN and +-0 among
    the floats."""
    import torch
    from accl_tpu_torch.ops import pipeline_relay as pr
    n_cases = 0
    for P in (2, 3, 8):
        for L in (1, 2):
            for n, d in ((1, 1), (16, 64), (5, 130001), (512, 3072)):
                dts = [torch.float32, torch.bfloat16, torch.int32]
                if n * d == 1:
                    dts.append(torch.int8)
                for dt in dts:
                    shape = (P, n, d) if L == 1 else (P, L, n, d)
                    f = relay_operands(shape, dt, gen)
                    b = relay_operands(shape, dt, gen)
                    plan = pr.pp_plan(n, d, dt, P)
                    fo, bo = pr.relay(f, b, plan)
                    pf, pb = pr.plain_relay(f, b, plan["C"],
                                            plan["seg_elems"])
                    torch.cuda.synchronize()
                    case = (P, L, n, d, dt, plan["C"])
                    if not (same_bits(fo, pf) and same_bits(bo, pb)):
                        fail(f"pp_relay_kernel != plain {case}")
                    if not (same_bits(fo, torch.roll(f, 1, 0))
                            and same_bits(bo, torch.roll(b, -1, 0))):
                        fail(f"pp_relay_kernel is not the +1/-1 shift "
                             f"{case}")
                    n_cases += 1
    log(f"phase 2: {n_cases} pp_relay kernel-vs-plain cases bit-equal")


def time_queued_ms(fn, iters: int) -> float:
    """Median device time of ``fn()`` in ms with the host's launch work
    hidden: each sample queues a ~1 ms device sleep before its start event,
    so the card is busy while the host prepares and enqueues ``fn``'s
    launches, and the events see only their device time (``time_ms`` of a
    call shorter than its host dispatch measures the dispatch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return statistics.median(samples)


def time_in_turns(fns, iters: int) -> list:
    """Median device time (ms) of each of ``fns``, taken as
    ``time_queued_ms`` takes it but in turns: each round times every
    function once, in forward order on even rounds and in reverse on odd
    ones, so a drift of the card's clocks spreads over all alike."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    samples = [[] for _ in fns]
    for it in range(iters):
        idx = range(len(fns)) if it % 2 == 0 else reversed(range(len(fns)))
        for i in idx:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            fns[i]()
            b.record()
            b.synchronize()
            samples[i].append(a.elapsed_time(b))
    return [statistics.median(t) for t in samples]


def measure_pp_relay_kernel(gen) -> dict:
    """pp_relay_kernel at phase 3k's tick, (8, 512, 3072) f32 per channel
    (6 segments of 1 MiB). Bound: each channel's payload read once and
    written once. Yardstick: torch.roll(f, 1, 0) and torch.roll(b, -1, 0),
    timed together."""
    import torch
    from accl_tpu_torch.ops import pipeline_relay as pr
    P, n, d = 8, PIPE["rows"], PIPE["d"]
    f = torch.randn((P, n, d), generator=gen, device="cuda")
    b = torch.randn((P, n, d), generator=gen, device="cuda")
    plan = pr.pp_plan(n, d, torch.float32, P)
    fo, bo = pr.relay(f, b, plan)
    pf, pb = pr.plain_relay(f, b, plan["C"], plan["seg_elems"])
    if not (torch.equal(fo, pf) and torch.equal(bo, pb)):
        fail("pp_relay_kernel != plain at the main-path shape")
    err = max((fo - pf).abs().max().item(), (bo - pb).abs().max().item())
    r = {"shape": [P, n, d], "max_abs_err": err, "segments": plan["C"],
         "ms": time_queued_ms(lambda: pr.relay(f, b, plan), 20),
         "plain_ms": time_queued_ms(lambda: pr.plain_relay(
             f, b, plan["C"], plan["seg_elems"]), 20),
         "library_ms": time_queued_ms(lambda: (torch.roll(f, 1, 0),
                                               torch.roll(b, -1, 0)), 20),
         "host_ms": time_ms(lambda: pr.relay(f, b, plan), 20),
         "bound_ms": 2 * 2 * f.numel() * 4 / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes"}
    log(f"  pp_relay_kernel {tuple(f.shape)} x 2 channels, {plan['C']} "
        f"segments: kernel {r['ms']!r} ms (with its host dispatch "
        f"{r['host_ms']!r} ms), plain {r['plain_ms']!r} ms, library (two "
        f"rolls) {r['library_ms']!r} ms, bound {r['bound_ms']!r} ms")
    del f, b, fo, bo, pf, pb
    torch.cuda.empty_cache()
    return {"pp_relay_kernel": r}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def wrappers() -> dict:
    """Every kernel's launch-counting wrapper, by kernel name."""
    from accl_tpu_torch.ops import collective_alltoall as ca
    from accl_tpu_torch.ops import collective_matmul as cm
    from accl_tpu_torch.ops import compression as cp
    from accl_tpu_torch.ops import flash as fl
    from accl_tpu_torch.ops import pipeline_relay as ppr
    from accl_tpu_torch.ops import reduce_ops as ro
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr
    return {"rs_fold_kernel": pr.ring_reduce_scatter,
            "ring_ag_kernel": pr.ring_allgather,
            "chunked_rs_kernel": pc.chunked_reduce_scatter,
            "chunked_ag_kernel": pc.chunked_allgather,
            "combine_kernel": ro.pallas_combine,
            "cast_kernel": cp.pallas_cast,
            "sr_kernel": cp.pallas_compress_stochastic,
            "bcast_relay_kernel": pc.chunked_bcast,
            "scatter_copy_kernel": pc.chunked_scatter,
            "gather_copy_kernel": pc.chunked_gather,
            "alltoall_copy_kernel": pc.chunked_alltoall,
            "a2a_mm_kernel": ca.a2a_mm,
            "mm_a2a_kernel": ca.mm_a2a,
            "agmm_kernel": cm.agmm,
            "mmrs_kernel": cm.mmrs,
            "wgrad_kernel": cm.wgrad,
            "a2a_wgrad_kernel": ca.a2a_wgrad,
            "flash_fwd_kernel": fl.flash_fwd,
            "flash_bwd_fused_kernel": fl.flash_bwd_fused,
            "flash_bwd_kv_kernel": fl.flash_bwd_kv,
            "flash_bwd_q_kernel": fl.flash_bwd_q,
            "flash_fwd_packed_kernel": fl.flash_fwd_packed,
            "flash_bwd_fused_packed_kernel": fl.flash_bwd_fused_packed,
            "flash_bwd_kv_packed_kernel": fl.flash_bwd_kv_packed,
            "flash_bwd_q_packed_kernel": fl.flash_bwd_q_packed,
            "flash_decode_kernel": fl.paged_decode,
            "flash_decode_span_kernel": fl.paged_decode_span,
            "pp_relay_kernel": ppr.relay}


def counts() -> dict:
    return {k: w.launches for k, w in wrappers().items()}


def reset_counts() -> None:
    for w in wrappers().values():
        w.launches = 0


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
        iters = 10 if nbytes <= 16 * MIB else (5 if nbytes <= 64 * MIB
                                               else 3)
        p50 = p50_call(lambda: acc.allreduce(
            send, recv, count, reduceFunction.SUM, from_device=True,
            to_device=True), iters)
        c1 = counts()
        fired = {k: c1[k] - c0[k] for k in c1}
        algo = algorithms.select(operation.allreduce, nbytes, acc.comms[0],
                                 acc.config, count=count).value
        err = check_result(send.data, recv.data, P)
        ring = fired["rs_fold_kernel"] + fired["ring_ag_kernel"]
        seg = fired["chunked_rs_kernel"] + fired["chunked_ag_kernel"]
        if MIB <= nbytes <= 4 * MIB:
            ok = fired["rs_fold_kernel"] > 0 and fired["ring_ag_kernel"] > 0 \
                and seg == 0
        elif nbytes > 4 * MIB:
            ok = fired["chunked_rs_kernel"] > 0 and \
                fired["chunked_ag_kernel"] > 0 and ring == 0
        else:
            ok = ring == 0 and seg == 0
        if not ok:
            fail(f"{nbytes} B: unexpected kernel launches {fired} "
                 f"(algorithm {algo})")
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
    return counts()


def p50_call(fn, iters: int) -> float:
    """Median host time (s) of ``fn()`` to its end on the card, after one
    warm-up call."""
    import torch
    from accl_tpu_torch.utils.timing import Timer
    timer, times = Timer(), []
    for i in range(iters + 1):
        torch.cuda.synchronize()
        timer.start()
        fn()
        torch.cuda.synchronize()
        timer.end()
        if i:
            times.append(timer.elapsed() / 1e6)
    return statistics.median(times)


def check_fold(y, xs, wire_ulps: float, what: str) -> float:
    """``y`` (rows, n) against the float64 fold of ``xs`` (k, rows, n) over
    its first axis: |y - sum| <= (k-1) 2^-24 sum|x| + wire_ulps sum|x|
    (the f32 fold bound, plus one rounding of each slice's partial on a
    bf16 DCN wire: 2^-8 relative to nearest, 2^-7 stochastic). Returns
    the largest |y - sum|."""
    import torch
    k = xs.shape[0]
    worst = 0.0
    step = 1 << 22
    for lo in range(0, xs.shape[-1], step):
        xd = xs[..., lo:lo + step].double()
        ref = xd.sum(0)
        mag = xd.abs().sum(0)
        bound = ((k - 1) * 2.0 ** -24 + wire_ulps) * mag
        err = (y[..., lo:lo + step].double() - ref).abs()
        if bool((err > bound).any()):
            fail(f"{what}: result outside its bound at columns {lo}..")
        worst = max(worst, err.max().item())
        del xd, ref, mag, bound, err
    return worst


def slice2_paths(gen) -> dict:
    """Phase 3b: combine, copy, the RING window of reduce-scatter, the
    explicit families and the two-tier schedules at world 8, f32, payloads
    generated and kept on the card. Returns the launch counts of this
    part."""
    import torch
    from accl_tpu_torch import ACCL, Algorithm, dataType, operation, \
        reduceFunction as F
    from accl_tpu_torch.parallel import algorithms

    P = 8
    f32 = dataType.float32
    acc = ACCL(world=P)
    reset_counts()

    def buf(count, x=None):
        b = acc.create_buffer(count, f32)
        if x is not None:
            b.device_store(x)
        return b

    def rand(count):
        return torch.randn((P, count), generator=gen, device="cuda")

    def report(what, p50, fired_before, err, algo=None):
        c = counts()
        fired = {k: c[k] - fired_before[k] for k in c if c[k] -
                 fired_before[k]}
        log(f"{what}: p50 {p50 * 1e6!r} us"
            + (f", algorithm {algo}" if algo else "")
            + f", launches {json.dumps(fired)}, max|err| {err!r}")
        return fired

    # combine and copy at 256 MiB per rank
    count = 256 * MIB // 4
    xa, xb = rand(count), rand(count)
    a, b, r = buf(count, xa), buf(count, xb), buf(count)
    for func in (F.SUM, F.MAX):
        c0 = counts()
        p50 = p50_call(lambda: acc.combine(
            count, func, a, b, r, val1_from_device=True,
            val2_from_device=True, to_device=True), 3)
        want = xa + xb if func == F.SUM else torch.where(xb > xa, xb, xa)
        if not torch.equal(r.data, want):
            fail(f"combine {func.name} != the f32 {func.name}")
        if report(f"combine {func.name} 256 MiB/rank", p50, c0,
                  0.0).get("combine_kernel", 0) == 0:
            fail("combine did not launch combine_kernel")
        del want
    c0 = counts()
    p50 = p50_call(lambda: acc.copy(a, r, count, from_device=True,
                                    to_device=True), 3)
    if not torch.equal(r.data, xa):
        fail("copy != its source")
    report("copy 256 MiB/rank", p50, c0, 0.0)
    del a, b, r, xa, xb
    torch.cuda.empty_cache()

    def run(op, nbytes, algo, iters):
        """One call shape: its p50, the fired launches and max|err|."""
        world_in = op == "reduce_scatter"
        count = nbytes // 4 // (P if world_in else 1)
        n_in = count * P if world_in else count
        n_out = count * P if op == "allgather" else count
        x = rand(n_in)
        s, r = buf(n_in, x), buf(n_out)
        kw = {} if op == "allgather" else {"function": F.SUM}
        if algo is not None:
            kw["algorithm"] = algo
        c0 = counts()
        p50 = p50_call(lambda: getattr(acc, op)(
            s, r, count, from_device=True, to_device=True, **kw), iters)
        wire = acc.config.dcn_wire_dtype if algo == Algorithm.TWOTIER \
            else "off"
        ulps = {"off": 0.0, "bf16": 2.0 ** -8, "bf16_sr": 2.0 ** -7}[wire]
        if op == "allreduce":
            err = check_fold(r.data, x.unsqueeze(1), ulps, f"{op} {algo}")
        elif op == "reduce_scatter":
            err = check_fold(r.data, x.view(P, P, count), ulps,
                             f"{op} {algo}")
        else:
            err = check_gather(r.data, x, wire)
        resolved = algorithms.select(
            operation[op], nbytes, acc.comms[0], acc.config, algo,
            count=n_in).value
        fired = report(f"{op} {nbytes} B/rank {wire}", p50, c0, err,
                       resolved)
        del s, r, x
        torch.cuda.empty_cache()
        return resolved, fired

    # AUTO reduce-scatter in the RING window (4-8 MiB of input per rank)
    for nbytes in (4 * MIB, 6 * MIB):
        resolved, _ = run("reduce_scatter", nbytes, None, 5)
        if resolved != "ring":
            fail(f"AUTO reduce_scatter at {nbytes} B resolved {resolved}")
    for algo in (Algorithm.RING, Algorithm.TREE, Algorithm.HIERARCHICAL):
        run("allreduce", 64 * MIB, algo, 3)
    for wire in ("off", "bf16", "bf16_sr"):
        acc.config = acc.config.replace(dcn_wire_dtype=wire)
        for op in ("allreduce", "reduce_scatter", "allgather"):
            for nbytes in (4 * MIB, 64 * MIB, 256 * MIB):
                _, fired = run(op, nbytes, Algorithm.TWOTIER,
                               5 if nbytes <= 64 * MIB else 3)
                lane = {"bf16": "cast_kernel", "bf16_sr": "sr_kernel"}
                if wire in lane and fired.get(lane[wire], 0) == 0:
                    fail(f"TWOTIER {op} {wire} did not launch "
                         f"{lane[wire]}")
    return counts()


def check_gather(y, x, wire: str) -> float:
    """An all-gather's every rank holds every rank's block in rank order:
    exactly at "off", x's nearest bf16 at "bf16", one of x's two bf16
    neighbours at "bf16_sr". Returns max|y - x|."""
    import torch
    P = x.shape[0]
    flat = x.reshape(1, -1)
    if wire == "bf16":
        near = flat.to(torch.bfloat16).float()
    elif wire == "bf16_sr":
        lo = (flat.view(torch.int32) & -65536).view(torch.float32)
        hi = (lo.view(torch.int32) + 65536).view(torch.float32)
    worst = 0.0
    for rank in range(P):
        got = y[rank:rank + 1]
        if wire == "off":
            ok = torch.equal(got, flat)
        elif wire == "bf16":
            ok = torch.equal(got, near)
        else:
            ok = bool(((got == lo) | (got == hi)).all())
        if not ok:
            fail(f"allgather ({wire}) rank {rank} holds wrong blocks")
        worst = max(worst, (got - flat).abs().max().item())
    return worst


#: the root of each rooted op in phase 3c
ROOT = {"bcast": 0, "scatter": 7, "gather": 3, "reduce": 5}
#: the kernels each rooted op's PALLAS program launches
RELAYS = {"bcast": ("bcast_relay_kernel",),
          "scatter": ("scatter_copy_kernel",),
          "gather": ("gather_copy_kernel",),
          "reduce": ("chunked_rs_kernel", "gather_copy_kernel")}


def rooted_paths(gen, big_ok: bool) -> dict:
    """Phase 3c: bcast, scatter, gather and reduce (f32 SUM) at world 8
    through the host API, payloads generated and kept on the card. Sizes
    are per rank: a bcast's or reduce's payload, a scatter's or gather's
    block (the selection bytes of each op). Non-root receive rows are
    pre-filled with -(r+1)/2 and must keep it. Returns the launch counts of
    this part."""
    import torch
    from accl_tpu_torch import ACCL, Algorithm, dataType, operation, \
        reduceFunction as F
    from accl_tpu_torch.parallel import algorithms

    P = 8
    f32 = dataType.float32
    acc = ACCL(world=P)
    reset_counts()

    def buf(count, x):
        b = acc.create_buffer(count, f32)
        b.device_store(x)
        return b

    def rand(count):
        return torch.randn((P, count), generator=gen, device="cuda")

    def pattern(count):
        return (-0.5 * torch.arange(1, P + 1, device="cuda",
                                    dtype=torch.float32)) \
            .view(P, 1).expand(P, count).contiguous()

    def kept_pattern(y, root, what):
        for r in range(P):
            if r != root and not bool((y[r] == -0.5 * (r + 1)).all()):
                fail(f"{what}: non-root rank {r}'s receive row changed")

    def run(op, nbytes, algo=None, wire=None, iters=3):
        """One call shape: p50, resolved family, fired launches, max|err|."""
        count = nbytes // 4
        root = ROOT[op]
        kw = {"from_device": True, "to_device": True}
        if algo is not None:
            kw["algorithm"] = algo
        if wire is not None:
            kw["compress_dtype"] = dataType.bfloat16
        c0 = counts()
        err = 0.0
        if op == "bcast":
            b = buf(count, rand(count))
            ref = b.data[root].clone()
            p50 = p50_call(lambda: acc.bcast(b, count, root, **kw), iters)
            peer = ref if wire is None else ref.to(torch.bfloat16).float()
            for r in range(P):
                if not torch.equal(b.data[r], ref if r == root else peer):
                    fail(f"bcast {nbytes} B {algo} {wire}: rank {r} wrong")
                err = max(err, (b.data[r] - ref).abs().max().item())
            del b, ref, peer
        elif op == "scatter":
            s, r_ = buf(count * P, rand(count * P)), buf(count, rand(count))
            p50 = p50_call(lambda: acc.scatter(s, r_, count, root, **kw),
                           iters)
            if not torch.equal(r_.data, s.data[root].view(P, count)):
                fail(f"scatter {nbytes} B {algo}: wrong blocks")
            del s, r_
        elif op == "gather":
            s, r_ = buf(count, rand(count)), buf(count * P, pattern(count * P))
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            p50 = p50_call(lambda: acc.gather(s, r_, count, root, **kw),
                           iters)
            extra = torch.cuda.max_memory_allocated() - held
            log(f"gather {nbytes} B/rank {algo}: peak allocation beyond the "
                f"send and receive buffers {extra} B ({extra / GIB!r} GiB)")
            if not torch.equal(r_.data[root], s.data.reshape(-1)):
                fail(f"gather {nbytes} B {algo}: wrong blocks at the root")
            kept_pattern(r_.data, root, f"gather {nbytes} B {algo}")
            del s, r_
        else:
            s, r_ = buf(count, rand(count)), buf(count, pattern(count))
            p50 = p50_call(lambda: acc.reduce(s, r_, count, root, F.SUM,
                                              **kw), iters)
            # the f32 fold bound, plus a bf16 wire's roundings: one per
            # reduce-scatter hop and one on the gather (2^-9 each)
            ulps = 0.0 if wire is None else (P + 1) * 2.0 ** -9
            err = check_fold(r_.data[root:root + 1], s.data.view(P, 1, count),
                             ulps, f"reduce {nbytes} B {algo} {wire}")
            kept_pattern(r_.data, root, f"reduce {nbytes} B {algo}")
            del s, r_
        torch.cuda.empty_cache()
        resolved = algorithms.select(operation[op], nbytes, acc.comms[0],
                                     acc.config, algo, count=count).value
        c = counts()
        fired = {k: c[k] - c0[k] for k in c if c[k] - c0[k]}
        log(f"{op} {nbytes} B/rank root {root}"
            + (f" wire {wire}" if wire else "")
            + f": p50 {p50 * 1e6!r} us, algorithm {resolved}, launches "
            f"{json.dumps(fired)}, max|err| {err!r}")
        return resolved, fired

    full = {"bcast": GIB, "reduce": GIB, "scatter": GIB // P,
            "gather": GIB // P}
    if not big_ok:
        full = {k: v // 4 for k, v in full.items()}
    for op in ("bcast", "scatter", "gather", "reduce"):
        for nbytes in (4, 64 * 1024, 4 * MIB, 16 * MIB, full[op]):
            iters = 10 if nbytes <= 4 * MIB else (5 if nbytes <= 64 * MIB
                                                  else 3)
            resolved, fired = run(op, nbytes, iters=iters)
            relays = [fired.get(k, 0) for k in RELAYS[op]]
            big = nbytes >= 8 * MIB
            if big and (resolved != "pallas" or min(relays) == 0):
                fail(f"AUTO {op} at {nbytes} B: {resolved}, launches "
                     f"{fired}: the rooted kernels did not run")
            if not big and (resolved == "pallas" or any(relays) or
                            fired.get("chunked_rs_kernel", 0)):
                fail(f"AUTO {op} at {nbytes} B: {resolved}, launches "
                     f"{fired}: a rooted kernel ran below 8 MiB")
    families = {"bcast": ("xla", "flat", "tree", "ring"),
                "scatter": ("xla", "flat"),
                "gather": ("xla", "flat", "ring"),
                "reduce": ("xla", "flat", "tree", "ring")}
    for op, algos in families.items():
        for algo in algos:
            run(op, 64 * MIB, Algorithm(algo), iters=3)
    for op in ("bcast", "reduce"):
        _, fired = run(op, 64 * MIB, Algorithm.PALLAS, wire="bf16", iters=3)
        if min(fired.get(k, 0) for k in RELAYS[op]) == 0:
            fail(f"PALLAS {op} with a bf16 wire did not launch {RELAYS[op]}")
    acc.barrier()
    log("barrier: done")
    return counts()


def alltoall_paths(gen, big_ok: bool) -> dict:
    """Phase 3d: ``ACCL.alltoall`` (f32) at world 8 through the host API,
    payloads generated and kept on the card. Sizes are per-rank send
    buffers; AUTO selects on the per-destination chunk. Returns the launch
    counts of this part."""
    import torch
    from accl_tpu_torch import ACCL, Algorithm, dataType, operation
    from accl_tpu_torch.parallel import algorithms

    P = 8
    f32 = dataType.float32
    acc = ACCL(world=P)
    reset_counts()

    def run(nbytes, algo=None, wire=False, iters=3):
        count = max(1, nbytes // 4 // P)
        s = acc.create_buffer(count * P, f32)
        s.device_store(torch.randn((P, count * P), generator=gen,
                                   device="cuda"))
        r = acc.create_buffer(count * P, f32)
        kw = {"from_device": True, "to_device": True}
        if algo is not None:
            kw["algorithm"] = algo
        if wire:
            kw["compress_dtype"] = dataType.bfloat16
        c0 = counts()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        p50 = p50_call(lambda: acc.alltoall(s, r, count, **kw), iters)
        extra = torch.cuda.max_memory_allocated() - held
        c = counts()
        fired = {k: c[k] - c0[k] for k in c if c[k] - c0[k]}
        resolved = algorithms.select(operation.alltoall, count * 4,
                                     acc.comms[0], acc.config, algo).value
        sent = s.data.view(P, P, count)
        got = r.data.view(P, P, count)
        err = 0.0
        for q in range(P):                # rank q's slot p holds rank p's q
            want = sent[:, q]
            if wire:
                want = want.to(torch.bfloat16).float()
                if resolved != "xla":
                    want[q] = sent[q, q]
            if not torch.equal(got[q], want):
                fail(f"alltoall {nbytes} B {resolved} wire={wire}: rank {q} "
                     f"holds wrong chunks")
            err = max(err, (got[q] - sent[:, q]).abs().max().item())
        log(f"alltoall {count * P * 4:>10} B/rank"
            + (" wire bf16" if wire else "")
            + f": p50 {p50 * 1e6!r} us, algorithm {resolved}, launches "
            f"{json.dumps(fired)}, max|err| {err!r}, peak allocation beyond "
            f"the send and receive buffers {extra} B ({extra / GIB!r} GiB)")
        del s, r, sent, got
        torch.cuda.empty_cache()
        return resolved, fired

    top = GIB if big_ok else 256 * MIB
    for nbytes in [4 * 4 ** i for i in range(15)]:
        if nbytes > top:
            break
        iters = 10 if nbytes <= 16 * MIB else (5 if nbytes <= 64 * MIB
                                               else 3)
        resolved, fired = run(nbytes, iters=iters)
        ran = fired.get("alltoall_copy_kernel", 0) > 0
        if ran != (resolved == "pallas"):
            fail(f"AUTO alltoall at {nbytes} B: {resolved}, launches {fired}")
    for algo in ("xla", "flat", "pallas"):
        run(64 * MIB, Algorithm(algo))
    _, fired = run(64 * MIB, Algorithm.PALLAS, wire=True)
    if fired.get("alltoall_copy_kernel", 0) == 0:
        fail("PALLAS alltoall with a bf16 wire did not launch "
             "alltoall_copy_kernel")
    return counts()


def moe_paths(gen, kernel_ms: dict) -> dict:
    """Phase 3e: the MoE forward at the full width of Switch-Base-8
    (:data:`SWITCH`; random weights from a seed), world 8 on the card, the
    fused path (``overlap=True``, both MoE kernels must launch) and the
    unfused baseline (``overlap=False``, neither may), checked against each
    other and against the float64 ``reference_moe``; then the fused
    dispatch against the unfused pair at the lane shape. ``kernel_ms``:
    the two kernels' times at these shapes (phase 2). Returns the launch
    counts of this part."""
    import torch
    from accl_tpu_torch import Communicator
    from accl_tpu_torch.models import moe
    from accl_tpu_torch.ops import collective_alltoall as ca

    P, E, C, d, h, n = (SWITCH[k] for k in ("P", "E", "C", "d", "h", "n"))
    comm = Communicator(P, "cuda")
    params = moe.shard_params(moe.init_params(gen, comm, d, h, E), comm)
    x = torch.randn((P, n, d), generator=gen, device="cuda")
    fused = moe.build_moe_forward(comm, E, C, overlap=True)
    base = moe.build_moe_forward(comm, E, C, overlap=False)
    reset_counts()
    c0 = counts()
    p50_f = p50_call(lambda: fused(params, x), 5)
    c1 = counts()
    p50_b = p50_call(lambda: base(params, x), 5)
    c2 = counts()
    f_fired = {k: c1[k] - c0[k] for k in c1 if c1[k] - c0[k]}
    b_fired = {k: c2[k] - c1[k] for k in c2 if c2[k] - c1[k]}
    if not f_fired.get("a2a_mm_kernel") or not f_fired.get("mm_a2a_kernel"):
        fail(f"the fused MoE forward did not launch both kernels: {f_fired}")
    if b_fired:
        fail(f"the MoE baseline launched kernels: {b_fired}")
    yf, yb = fused(params, x), base(params, x)
    if not bool(torch.isfinite(yf).all()) or tuple(yf.shape) != (P, n, d):
        fail("MoE fused output not finite or misshapen")
    ref = torch.from_numpy(moe.reference_moe(params, x, E, C)).to("cuda")
    # fused and baseline run f32 on the card: rtol 1e-5, atol 1e-6. Against
    # float64 both carry f32 rounding over sums of d = 768 and h = 3072
    # products (about sqrt(3072) 2^-24 = 3.3e-6 of outputs of magnitude
    # up to a few units): atol 1e-5.
    errs = {}
    for name, a, b, atol in (("fused - baseline", yf, yb, 1e-6),
                             ("fused - f64", yf.double(), ref, 1e-5),
                             ("baseline - f64", yb.double(), ref, 1e-5)):
        diff = (a - b).abs()
        errs[name] = diff.max().item()
        bad = int((diff > atol + 1e-5 * b.abs()).sum())
        if bad:
            fail(f"MoE {name}: {bad} elements outside rtol 1e-5 atol "
                 f"{atol} (max|diff| {errs[name]!r})")
    tokens = P * n
    log(f"moe Switch-Base-8 world {P}, {n} tokens/rank, C {C}: fused p50 "
        f"{p50_f * 1e6!r} us ({tokens / p50_f!r} tokens/s), launches "
        f"{json.dumps(f_fired)}, kernels {kernel_ms['a2a_mm_kernel']!r} + "
        f"{kernel_ms['mm_a2a_kernel']!r} ms; baseline p50 {p50_b * 1e6!r} us "
        f"({tokens / p50_b!r} tokens/s); max|diff| {json.dumps(errs)}")
    del yf, yb, ref
    # the lane shape (bench/lanes.py): e_local 2, C 128, d 256, h 512
    xl = torch.randn((P, 2 * P, 128, 256), generator=gen, device="cuda")
    wl = torch.randn((P, 2, 256, 512), generator=gen, device="cuda")
    t_f = p50_call(lambda: ca.alltoall_matmul_body(xl, wl, overlap=True), 10)
    t_u = p50_call(lambda: ca.xla_alltoall_matmul(xl, wl), 10)
    log(f"moe lane shape (2, 128, 256, 512) world {P}: fused dispatch p50 "
        f"{t_f * 1e6!r} us, unfused pair (all-to-all + einsum) p50 "
        f"{t_u * 1e6!r} us")
    return counts()


def tp_mlp_paths(gen, kernel_ms: dict) -> dict:
    """Phase 3f: the tensor-parallel MLP forward at Megatron-LM 8.3B's
    block width (:data:`MEGATRON`; random weights and biases from a seed),
    world 8 = (dp 1, tp 8) on the card, 2048 tokens, f32: the fused path
    (``overlap=True``: the stream plans launch agmm_kernel once and
    mmrs_kernel twice per forward) and the psum baseline (no kernel),
    checked against each other and against a float64 forward; p50 and
    tokens/s of each over 5 timed forwards after a warm-up. Then the lane
    shape: the fused bodies against the unfused pair, within the f32
    summation bound. ``kernel_ms``: the two kernels' times at these shapes
    (phase 2). Returns the launch counts of this part."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch import Communicator
    from accl_tpu_torch.models import mlp
    from accl_tpu_torch.ops import collective_matmul as cm

    d, h, tp, n = (MEGATRON[k] for k in ("d", "h", "tp", "tokens"))
    comm = Communicator(tp, "cuda")
    dense = mlp.init_params(gen, d, h)
    dense = dense._replace(
        b1=torch.randn((h,), generator=gen, device="cuda") * 0.1,
        b2=torch.randn((d,), generator=gen, device="cuda") * 0.1)
    params = mlp.shard_params(dense, comm, 1, tp)
    x = torch.randn((n, d), generator=gen, device="cuda")
    fused = mlp.make_forward(comm, 1, tp, overlap=True)
    base = mlp.make_forward(comm, 1, tp, overlap=False)
    reset_counts()
    yf = fused(params, x)
    c1 = counts()
    fired = {k: v for k, v in c1.items() if v}
    if fired != {"agmm_kernel": 1, "mmrs_kernel": 2}:
        fail(f"one fused forward launched {fired}, not agmm_kernel once "
             f"and mmrs_kernel twice")
    yb = base(params, x)
    if counts() != c1:
        fail("the psum baseline launched a kernel")
    p50_f = p50_call(lambda: fused(params, x), 5)
    c2 = counts()
    p50_b = p50_call(lambda: base(params, x), 5)
    if counts() != c2 or c2["agmm_kernel"] != 7 or c2["mmrs_kernel"] != 14:
        fail(f"unexpected launches over the timed forwards: {counts()}")
    if not bool(torch.isfinite(yf).all()) or tuple(yf.shape) != (n, d):
        fail("MLP fused output not finite or misshapen")
    ref = F.gelu(x.double() @ dense.w1.double() + dense.b1.double(),
                 approximate="tanh") @ dense.w2.double() + dense.b2.double()
    # both paths run f32 sums of d = 3072 and h = 12288 products of
    # unit-scale terms in different orders: about sqrt(12288) 2^-24 = 7e-6
    # of outputs of magnitude up to a few units. Against each other rtol
    # 1e-5 / atol 1e-5, against float64 rtol 1e-5 / atol 1e-4.
    errs = {}
    for name, a, b, atol in (("fused - f64", yf.double(), ref, 1e-4),
                             ("baseline - f64", yb.double(), ref, 1e-4),
                             ("fused - baseline", yf, yb, 1e-5)):
        diff = (a - b).abs()
        errs[name] = diff.max().item()
        bad = int((diff > atol + 1e-5 * b.abs()).sum())
        if bad:
            fail(f"MLP {name}: {bad} elements outside rtol 1e-5 atol "
                 f"{atol} (max|diff| {errs[name]!r})")
    log(f"tp-mlp Megatron-LM 8.3B block (d {d}, ffn {h}), world {tp} "
        f"(dp 1, tp {tp}), {n} tokens: fused p50 {p50_f * 1e6!r} us "
        f"({n / p50_f!r} tokens/s), launches {json.dumps(fired)} per "
        f"forward, "
        f"kernels {kernel_ms['agmm_kernel']!r} + "
        f"{kernel_ms['mmrs_kernel']!r} ms; baseline p50 {p50_b * 1e6!r} us "
        f"({n / p50_b!r} tokens/s); max|diff| {json.dumps(errs)}")
    del yf, yb, ref, params, dense, x
    torch.cuda.empty_cache()
    # the lane shape: the fused bodies (resident plans) against the pair
    m, k, nn = CMATMUL_LANE
    xl, xrl, wl = cmatmul_operands(gen, tp, m, k, nn)
    for name, fn, pair, a, b, K in (
            ("allgather_matmul", cm.all_gather_matmul_body,
             cm.xla_all_gather_matmul, xl, wl, k),
            ("matmul_reduce_scatter", cm.matmul_reduce_scatter_body,
             cm.xla_matmul_reduce_scatter, xrl, wl, tp * k)):
        err = (fn(a, b, overlap=True) - pair(a, b)).abs()
        if bool((err > f32_sum_bound(K, pair(a.abs(), b.abs()))).any()):
            fail(f"fused {name} outside the f32 sum bound of the unfused "
                 f"pair at the lane shape")
        t_f = p50_call(lambda: fn(a, b, overlap=True), 10)
        t_u = p50_call(lambda: pair(a, b), 10)
        log(f"tp-mlp lane shape {(m, k, nn)} world {tp}: fused {name} p50 "
            f"{t_f * 1e6!r} us, unfused pair p50 {t_u * 1e6!r} us")
    return counts()


def check_grads(what: str, got, ref, rel: float) -> float:
    """Fail unless ``|got - ref| <= rel (max|ref| + |ref|)`` elementwise;
    returns max|got - ref| / max|ref|."""
    diff = (got.double() - ref.double()).abs()
    top = ref.double().abs().max().item()
    if bool((diff > rel * (top + ref.double().abs())).any()):
        fail(f"{what}: outside {rel} of the largest magnitude (max|diff| "
             f"{diff.max().item()!r}, max|ref| {top!r})")
    return diff.max().item() / top


#: the gradients' tolerance against each other and float64: each element
#: sums f32 products over 2048-16384 rows (tokens) and 3072-12288 columns,
#: in other orders on each path; their rounding is about sqrt(K) 2^-24 of
#: the products' absolute sum, which for random signs is sqrt(K) times an
#: element's size: up to about 2e-5 of the largest element
GRAD_REL = 1e-4


def tp_train_paths(gen, kernel_ms: dict) -> dict:
    """Phase 3g: the Megatron-LM 8.3B MLP train step (:data:`MEGATRON`;
    random weights, biases and targets from a seed), world 8 = (dp 1, tp
    8), 2048 tokens, f32, SGD at lr 1e-2: the fused step (``overlap=True``)
    must launch per step what the ported plans give (agmm_kernel for the
    forward and for dx of the matmul x reduce-scatter, mmrs_kernel for the
    forward only, since x needs no gradient, wgrad_kernel ``nctb`` times
    for each of the two dws), the psum baseline no kernel. The loss, the
    gradients (``make_loss_and_grads``) and the new parameters are checked
    fused against baseline and both against a float64 step of the dense
    block, whose gradients of w1, b1 and w2 are scaled by tp as the JAX
    step's are; p50 and tokens/s of each step. ``kernel_ms``: the kernels'
    times at these shapes (phase 2). Returns the launch counts of this
    part."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch import Communicator
    from accl_tpu_torch.models import mlp
    from accl_tpu_torch.ops import collective_matmul as cm

    d, h, tp, n = (MEGATRON[k] for k in ("d", "h", "tp", "tokens"))
    lr, f32 = 1e-2, torch.float32
    comm = Communicator(tp, "cuda")
    dense = mlp.init_params(gen, d, h)
    dense = dense._replace(
        b1=torch.randn((h,), generator=gen, device="cuda") * 0.1,
        b2=torch.randn((d,), generator=gen, device="cuda") * 0.1)
    params = mlp.shard_params(dense, comm, 1, tp)
    x = torch.randn((n, d), generator=gen, device="cuda")
    t = torch.randn((n, d), generator=gen, device="cuda")
    ms, hl = n // tp, h // tp

    def planned(p):
        return p.get("nmb", p.get("nnb", p.get("nctb", 1)))
    # dx of the matmul x reduce-scatter is an all-gather x matmul of the
    # forward's shape, and both dws have one (ms, d) traveller against
    # (n, h/tp) rows
    expect = {"agmm_kernel": 2 * planned(cm.agmm_plan(ms, d, hl, tp, f32,
                                                      True)),
              "mmrs_kernel": planned(cm.mmrs_plan(n, hl, d, tp, f32, True)),
              "wgrad_kernel": 2 * planned(cm.wgrad_plan(ms, d, hl, tp, f32,
                                                        f32, True))}
    fused = mlp.make_train_step(comm, 1, tp, lr, overlap=True)
    base = mlp.make_train_step(comm, 1, tp, lr, overlap=False)
    reset_counts()
    new_f, loss_f = fused(params, x, t)
    c1 = counts()
    fired = {k: v for k, v in c1.items() if v}
    if fired != expect:
        fail(f"one fused train step launched {fired}, the ported plans give "
             f"{expect}")
    new_b, loss_b = base(params, x, t)
    if counts() != c1:
        fail("the psum baseline's train step launched a kernel")
    p50_f = p50_call(lambda: fused(params, x, t), 5)
    c2 = counts()
    p50_b = p50_call(lambda: base(params, x, t), 5)
    if counts() != c2 or any(c2[k] != 7 * v for k, v in expect.items()):
        fail(f"unexpected launches over the timed steps: {counts()}")
    loss_gf, g_f = mlp.make_loss_and_grads(comm, 1, tp, overlap=True)(
        params, x, t)
    loss_gb, g_b = mlp.make_loss_and_grads(comm, 1, tp, overlap=False)(
        params, x, t)
    # the float64 step of the dense block, scaled as the JAX step scales
    w64 = [p.detach().double().requires_grad_() for p in dense]
    y64 = F.gelu(x.double() @ w64[0] + w64[1], approximate="tanh") \
        @ w64[2] + w64[3]
    loss64 = ((y64 - t.double()) ** 2).mean()
    loss64.backward()
    scaled = mlp.MLPParams(w64[0].grad * tp, w64[1].grad * tp,
                           w64[2].grad * tp, w64[3].grad)
    g64 = mlp.shard_params(scaled, comm, 1, tp)
    new64 = mlp.shard_params(mlp.MLPParams(
        *(p.detach() - lr * g for p, g in zip(w64, scaled))), comm, 1, tp)
    errs = {}
    for name, a, b in (("loss fused - baseline", loss_f, loss_b),
                       ("loss fused - f64", loss_f, loss64),
                       ("loss baseline - f64", loss_b, loss64),
                       ("grads' loss fused - step's", loss_gf, loss_f),
                       ("grads' loss baseline - step's", loss_gb, loss_b)):
        errs[name] = abs(a.item() - b.item())
        if errs[name] > 1e-5 * abs(b.item()):
            fail(f"MLP {name}: {a.item()!r} vs {b.item()!r}")
    for field, gf, gb, gd in zip(mlp.MLPParams._fields, g_f, g_b, g64):
        errs[f"d{field} fused - baseline"] = check_grads(
            f"MLP d{field} fused - baseline", gf, gb, GRAD_REL)
        errs[f"d{field} fused - f64"] = check_grads(
            f"MLP d{field} fused - f64", gf, gd, GRAD_REL)
        errs[f"d{field} baseline - f64"] = check_grads(
            f"MLP d{field} baseline - f64", gb, gd, GRAD_REL)
    # the new parameters: the update is lr g, a few thousandths of the
    # weights, so the f32 rounding of w - lr g bounds their differences
    for field, pf, pb, pd in zip(mlp.MLPParams._fields, new_f, new_b, new64):
        for name, a, b in (("fused - baseline", pf, pb),
                           ("fused - f64", pf, pd),
                           ("baseline - f64", pb, pd)):
            diff = (a.double() - b.double()).abs()
            bad = int((diff > 1e-6 + 1e-5 * b.double().abs()).sum())
            if bad:
                fail(f"MLP new {field} {name}: {bad} elements outside rtol "
                     f"1e-5 atol 1e-6 (max|diff| {diff.max().item()!r})")
    log(f"tp-mlp train step, Megatron-LM 8.3B block (d {d}, ffn {h}), world "
        f"{tp} (dp 1, tp {tp}), {n} tokens, lr {lr}: fused p50 "
        f"{p50_f * 1e6!r} us ({n / p50_f!r} tokens/s), launches "
        f"{json.dumps(fired)} per step (the plans give "
        f"{json.dumps(expect)}), kernels agmm {kernel_ms['agmm_kernel']!r} "
        f"+ mmrs {kernel_ms['mmrs_kernel']!r} + wgrad "
        f"{kernel_ms['wgrad_kernel']!r} ms per call; baseline p50 "
        f"{p50_b * 1e6!r} us ({n / p50_b!r} tokens/s); loss "
        f"{loss_f.item()!r}; errors {json.dumps(errs)}")
    del new_f, new_b, g_f, g_b, g64, new64, w64, y64, scaled, params, dense
    del x, t
    torch.cuda.empty_cache()
    return counts()


class relu_pattern:
    """Within this block ``torch.relu`` records the sign pattern of each
    input (``masks`` None), or applies the recorded ones in turn as ``t *
    mask``, whose gradient is the mask, and counts the entries where the
    input's own sign disagrees (``flips``). The MoE layer's gradient jumps
    where an expert's pre-activation crosses 0, and one within rounding of
    0 may fall either side in f32 and float64: replaying an f32 run's
    pattern makes the float64 step take that run's side of every kink."""

    def __init__(self, masks=None):
        self.replay = masks is not None
        self.masks = list(masks or [])
        self.flips = 0

    def __enter__(self):
        import torch
        self.relu = torch.relu

        def relu(t):
            if not self.replay:
                self.masks.append(t.detach() > 0)
                return self.relu(t)
            m = self.masks.pop(0)
            self.flips += int(((t.detach() > 0) != m).sum())
            return t * m.to(t.dtype)
        torch.relu = relu
        return self

    def __exit__(self, *exc):
        import torch
        torch.relu = self.relu


def moe_train_paths(gen, kernel_ms: dict) -> dict:
    """Phase 3h: the Switch-Base-8 MoE layer forward and backward
    (:data:`SWITCH`; random weights, tokens and output cotangent from a
    seed), world 8, 2048 tokens per rank, capacity 320, the tokens
    requiring grad as a layer inside a model does: the fused path must
    launch a2a_mm_kernel, mm_a2a_kernel and a2a_wgrad_kernel twice each
    (forward, the duals' dx, the two dws), the baseline none. The output
    and the gradients of the router, w_in, w_out and the tokens are
    checked fused against baseline and each against the baseline run in
    float64 on that path's ReLU pattern (:class:`relu_pattern`; where the
    two f32 paths' patterns differ, w_in's and the tokens' gradients are
    held to their float64 steps only); p50 of forward and backward, fused
    and baseline.
    ``kernel_ms``: the kernels' times at these shapes (phase 2). Returns
    the launch counts of this part."""
    import torch
    from accl_tpu_torch import Communicator
    from accl_tpu_torch.models import moe

    P, E, C, d, h, n = (SWITCH[k] for k in ("P", "E", "C", "d", "h", "n"))
    comm = Communicator(P, "cuda")
    params = moe.shard_params(moe.init_params(gen, comm, d, h, E), comm)
    x = torch.randn((P, n, d), generator=gen, device="cuda")
    cot = torch.randn((P, n, d), generator=gen, device="cuda")
    fused = moe.build_moe_forward(comm, E, C, overlap=True)
    base = moe.build_moe_forward(comm, E, C, overlap=False)

    def fwd_bwd(prog, ps, xs, cs):
        ps = moe.MoEParams(*(q.detach().requires_grad_() for q in ps))
        xs = xs.detach().requires_grad_()
        out = prog(ps, xs)
        (out * cs).sum().backward()
        return out.detach(), [q.grad for q in (*ps, xs)]

    expect = {"a2a_mm_kernel": 2, "mm_a2a_kernel": 2, "a2a_wgrad_kernel": 2}
    reset_counts()
    with relu_pattern() as pat_f:
        yf, gf = fwd_bwd(fused, params, x, cot)
    c1 = counts()
    fired = {k: v for k, v in c1.items() if v}
    if fired != expect:
        fail(f"one fused MoE forward and backward launched {fired}, not "
             f"{expect}")
    with relu_pattern() as pat_b:
        yb, gb = fwd_bwd(base, params, x, cot)
    if counts() != c1:
        fail("the MoE baseline's backward launched a kernel")
    p50_f = p50_call(lambda: fwd_bwd(fused, params, x, cot), 5)
    p50_b = p50_call(lambda: fwd_bwd(base, params, x, cot), 5)
    if not bool(torch.isfinite(yf).all()) or tuple(yf.shape) != (P, n, d):
        fail("MoE fused output not finite or misshapen")
    kinks = int((pat_f.masks[0] != pat_b.masks[0]).sum())
    p64 = moe.MoEParams(*(q.double() for q in params))
    errs = {"relu pattern fused != baseline": kinks}
    fields = ("router", "w_in", "w_out", "x")
    for path, y, g, pat in (("fused", yf, gf, pat_f),
                            ("baseline", yb, gb, pat_b)):
        with relu_pattern(pat.masks) as rep:
            y64, g64 = fwd_bwd(base, p64, x.double(), cot.double())
        errs[f"relu signs flipped in f64 ({path})"] = rep.flips
        diff = (y.double() - y64).abs()
        errs[f"y {path} - f64"] = diff.max().item()
        bad = int((diff > 1e-5 + 1e-5 * y64.abs()).sum())
        if bad:
            fail(f"MoE y {path} - f64: {bad} elements outside rtol 1e-5 atol "
                 f"1e-5")
        for field, a, c in zip(fields, g, g64):
            errs[f"d{field} {path} - f64"] = check_grads(
                f"MoE d{field} {path} - f64", a, c, GRAD_REL)
    diff = (yf - yb).abs()
    errs["y fused - baseline"] = diff.max().item()
    if bool((diff > 1e-6 + 1e-5 * yb.abs()).any()):
        fail("MoE y fused - baseline outside rtol 1e-5 atol 1e-6")
    # w_in's and the tokens' gradients jump at the kinks; the router's and
    # w_out's do not (the output is continuous there)
    for field, a, b in zip(fields, gf, gb):
        if kinks == 0 or field in ("router", "w_out"):
            errs[f"d{field} fused - baseline"] = check_grads(
                f"MoE d{field} fused - baseline", a, b, GRAD_REL)
    tokens = P * n
    log(f"moe forward + backward, Switch-Base-8 world {P}, {n} tokens/rank, "
        f"C {C}: fused p50 {p50_f * 1e6!r} us ({tokens / p50_f!r} tokens/s), "
        f"launches {json.dumps(fired)}, kernels a2a_mm "
        f"{kernel_ms['a2a_mm_kernel']!r} + mm_a2a "
        f"{kernel_ms['mm_a2a_kernel']!r} + a2a_wgrad "
        f"{kernel_ms['a2a_wgrad_kernel']!r} ms per call; baseline p50 "
        f"{p50_b * 1e6!r} us ({tokens / p50_b!r} tokens/s); errors "
        f"{json.dumps(errs)}")
    del yf, yb, y64, gf, gb, g64, p64, pat_f, pat_b, params, x, cot
    torch.cuda.empty_cache()
    return counts()


def dense_f64(q, k, v, cot, sc: float, causal: bool = True):
    """Softmax attention of (h, S, d) heads in float64, causal unless told
    otherwise, and the gradients of sum(out cot)."""
    import torch
    ts = [t.double().detach().requires_grad_() for t in (q, k, v)]
    s = torch.matmul(ts[0], ts[1].transpose(-1, -2)) * sc
    if causal:
        S = s.shape[-1]
        mask = torch.ones((S, S), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
        del mask
    p = torch.softmax(s, -1)
    del s
    out = torch.matmul(p, ts[2])
    del p
    (out * cot.double()).sum().backward()
    return out.detach(), [t.grad for t in ts]


def step(prog, xs, cot):
    """One forward and backward of ``prog`` on fresh leaves of ``xs``: the
    output and the gradients of sum(out cot)."""
    ts = [x.detach().requires_grad_() for x in xs]
    out = prog(*ts)
    (out.float() * cot).sum().backward()
    return out.detach(), [t.grad for t in ts]


def launched(fn):
    """``fn()`` and the launches it made, by kernel (those above 0)."""
    before = counts()
    r = fn()
    return r, {k: v - before[k] for k, v in counts().items()
               if v - before[k]}


def context_paths(gen, kernel_ms: dict) -> dict:
    """Phase 3i: context-parallel attention at Megatron-LM 8.3B's attention
    width (:data:`ATTN`: 32 heads of 96, causal), world 8 on one card, a
    global sequence of 8192 tokens (n 1024 per rank), random q, k, v and
    output cotangent from a seed.

    * Ulysses (q, k, v (8, 1024, 32, 96)), ``use_flash`` True against False,
      f32 and bf16: one forward must launch ``flash_fwd_kernel`` once, one
      forward and backward the forward once and ``flash_bwd_fused_kernel``
      (the JAX policy's fused (512, 512) arm; its launches are the dQ-slab
      runs), the plain arm nothing; outputs and gradients flash against
      plain within 1e-5 (f32) or 1e-2 (bf16) of each tensor's largest
      magnitude; in f32 the flash arm against float64 dense attention on
      heads 0 and 17 (outputs and gradients, 1e-5); forward and forward +
      backward p50 and tokens/s of both arms.
    * the same f32 step with ``ACCLConfig.flash_bwd = "two_pass"`` written
      through ``ACCL.config``: ``flash_bwd_kv_kernel`` and
      ``flash_bwd_q_kernel`` once each and bit-equal gradients; and
      Ulysses at 16384 tokens (n 2048), where the policy answers None and
      the default mode runs the two-pass pair, against float64 on head 5.
    * ring and zigzag ring attention at their API's single-head shape (8,
      1024, 96), causal, both arms, forward and backward: flash against
      plain (1e-5) and the outputs against float64 dense attention of the
      8192-token sequence; p50 of each.
    ``kernel_ms``: the flash kernels' times at the Ulysses shape (phase 2).
    Returns the launch counts of this part."""
    import torch
    from accl_tpu_torch import ACCL, Communicator
    from accl_tpu_torch.parallel import context as ctx

    P, H, d, n = (ATTN[k] for k in ("P", "H", "d", "n"))
    comm = Communicator(P, "cuda")
    sc = d ** -0.5
    reset_counts()

    def heads(x, hs):
        """(P, n, H, d) -> the (len(hs), P n, d) heads hs"""
        return x[:, :, list(hs)].permute(2, 0, 1, 3).reshape(
            len(hs), -1, x.shape[-1])

    report = {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        rel = 1e-5 if dt == torch.float32 else 1e-2
        xs = [torch.randn((P, n, H, d), generator=gen, device="cuda").to(dt)
              for _ in range(3)]
        cot = torch.randn((P, n, H, d), generator=gen, device="cuda")
        progs = {f: ctx.build_ulysses_attention(comm, H, causal=True,
                                                use_flash=f)
                 for f in (True, False)}
        with torch.no_grad():
            _, fwd_l = launched(lambda: progs[True](*xs))
        if fwd_l != {"flash_fwd_kernel": 1}:
            fail(f"one Ulysses flash forward ({name}) launched {fwd_l}")
        (yf, gf), step_l = launched(lambda: step(progs[True], xs, cot))
        if set(step_l) != {"flash_fwd_kernel", "flash_bwd_fused_kernel"} \
                or step_l["flash_fwd_kernel"] != 1:
            fail(f"one Ulysses flash forward + backward ({name}) launched "
                 f"{step_l}")
        (yb, gb), plain_l = launched(lambda: step(progs[False], xs, cot))
        if plain_l:
            fail(f"the Ulysses plain arm launched {plain_l}")
        errs = {"out flash - plain": near(f"Ulysses {name} out flash - "
                                          f"plain", yf, yb, rel)}
        for g, b, w in zip(gf, gb, ("dq", "dk", "dv")):
            errs[f"{w} flash - plain"] = near(
                f"Ulysses {name} {w} flash - plain", g, b, rel)
        del yb, gb
        if dt == torch.float32:
            hs = (0, 17)
            y64, g64 = dense_f64(*(heads(x, hs) for x in xs),
                                 heads(cot, hs), sc)
            errs["out flash - f64 (heads 0, 17)"] = near(
                "Ulysses out flash - f64", heads(yf, hs), y64, 1e-5)
            for g, w64, w in zip(gf, g64, ("dq", "dk", "dv")):
                errs[f"{w} flash - f64 (heads 0, 17)"] = near(
                    f"Ulysses {w} flash - f64", heads(g, hs), w64, 1e-5)
            del y64, g64
            # the two-pass arm through the session register
            acc = ACCL(world=P, device="cuda")
            acc.config = acc.config.replace(flash_bwd="two_pass")
            try:
                (yt, gt), two_l = launched(lambda: step(progs[True], xs,
                                                        cot))
            finally:
                acc.config = acc.config.replace(flash_bwd="fused")
            if two_l != {"flash_fwd_kernel": 1, "flash_bwd_kv_kernel": 1,
                         "flash_bwd_q_kernel": 1}:
                fail(f"Ulysses with flash_bwd two_pass launched {two_l}")
            for g, t, w in zip(gf, gt, ("dq", "dk", "dv")):
                if not torch.equal(g, t):
                    fail(f"Ulysses {w}: two-pass bits differ from fused")
            del yt, gt
        tokens = P * n
        t = {}
        for f in (True, False):
            arm = "flash" if f else "plain"
            with torch.no_grad():
                t[f"{arm} forward"] = p50_call(
                    lambda: progs[f](*xs), 5 if f else 3)
            t[f"{arm} forward + backward"] = p50_call(
                lambda: step(progs[f], xs, cot), 3 if f else 2)
        report[f"ulysses {name}"] = {
            "p50_ms": {k: v * 1e3 for k, v in t.items()},
            "tokens_per_s": {k: tokens / v for k, v in t.items()},
            "launches per forward": fwd_l,
            "launches per forward + backward": step_l, "errors": errs}
        log(f"ulysses {name}, Megatron-LM 8.3B attention (32 x 96), world "
            f"{P}, {tokens} tokens, causal: "
            f"{json.dumps(report[f'ulysses {name}'])}")
        del xs, cot, yf, gf, progs
        torch.cuda.empty_cache()

    # 16384 tokens: the JAX policy has no fused geometry, two-pass runs
    n2 = 2 * n
    xs = [torch.randn((P, n2, H, d), generator=gen, device="cuda")
          for _ in range(3)]
    cot = torch.randn((P, n2, H, d), generator=gen, device="cuda")
    prog = ctx.build_ulysses_attention(comm, H, causal=True, use_flash=True)
    (yl, gl), long_l = launched(lambda: step(prog, xs, cot))
    if long_l != {"flash_fwd_kernel": 1, "flash_bwd_kv_kernel": 1,
                  "flash_bwd_q_kernel": 1}:
        fail(f"Ulysses at {P * n2} tokens launched {long_l}")
    y64, g64 = dense_f64(*(heads(x, (5,)) for x in xs), heads(cot, (5,)),
                         sc)
    errs = {"out - f64 (head 5)": near("Ulysses 16384 out - f64",
                                       heads(yl, (5,)), y64, 1e-5)}
    for g, w64, w in zip(gl, g64, ("dq", "dk", "dv")):
        errs[f"{w} - f64 (head 5)"] = near(f"Ulysses 16384 {w} - f64",
                                           heads(g, (5,)), w64, 1e-5)
    t_long = p50_call(lambda: step(prog, xs, cot), 2)
    report["ulysses f32 16384 tokens"] = {
        "p50_ms forward + backward": t_long * 1e3,
        "launches per forward + backward": long_l, "errors": errs}
    log(f"ulysses f32 at {P * n2} tokens (two-pass by the policy): "
        f"{json.dumps(report['ulysses f32 16384 tokens'])}")
    del xs, cot, yl, gl, y64, g64, prog
    torch.cuda.empty_cache()

    # ring and zigzag at (8, 1024, 96), single head, causal
    from accl_tpu_torch.parallel.context import zigzag_unlayout
    layers = {
        "ring": lambda f: ctx.build_ring_attention(comm, causal=True,
                                                   use_flash=f),
        "zigzag": lambda f: ctx.build_zigzag_ring_attention(comm,
                                                            use_flash=f)}
    for name, build in layers.items():
        xs = [torch.randn((P, n, d), generator=gen, device="cuda")
              for _ in range(3)]
        cot = torch.randn((P, n, d), generator=gen, device="cuda")
        progs = {f: build(f) for f in (True, False)}
        (yf, gf), fl_l = launched(lambda: step(progs[True], xs, cot))
        (yb, gb), pl_l = launched(lambda: step(progs[False], xs, cot))
        if pl_l or set(fl_l) != {"flash_fwd_kernel",
                                 "flash_bwd_fused_kernel"}:
            fail(f"{name}: flash arm launched {fl_l}, plain arm {pl_l}")
        errs = {"out flash - plain": near(f"{name} out flash - plain", yf,
                                          yb, 1e-5)}
        for g, b, w in zip(gf, gb, ("dq", "dk", "dv")):
            errs[f"{w} flash - plain"] = near(f"{name} {w} flash - plain",
                                              g, b, 1e-5)
        seq = (zigzag_unlayout if name == "zigzag"
               else lambda x, w: x.reshape(-1, x.shape[-1]))
        y64, _ = dense_f64(*(seq(x, P)[None] for x in xs),
                           seq(cot, P)[None], sc)
        errs["out flash - f64"] = near(f"{name} out flash - f64",
                                       seq(yf, P)[None], y64, 1e-5)
        t = {}
        for f in (True, False):
            arm = "flash" if f else "plain"
            with torch.no_grad():
                t[f"{arm} forward"] = p50_call(lambda: progs[f](*xs), 5)
            t[f"{arm} forward + backward"] = p50_call(
                lambda: step(progs[f], xs, cot), 5)
        report[name] = {"p50_ms": {k: v * 1e3 for k, v in t.items()},
                        "launches per forward + backward": fl_l,
                        "errors": errs}
        log(f"{name} attention (8, 1024, 96) causal f32: "
            f"{json.dumps(report[name])}")
        del xs, cot, yf, gf, yb, gb, y64, progs
        torch.cuda.empty_cache()
    log(f"flash kernels at the Ulysses shape (phase 2): "
        f"{json.dumps(kernel_ms)}")
    return counts()


def serving_f64(p, xs, sc: float):
    """Float64 attention block of one slot's whole sequence: x (S, d_model)
    -> causal GQA attention over its own projections -> (S, d_model), from
    the rank-layout params."""
    import torch
    from accl_tpu_torch.models import decode as dm
    wq, wk, wv, wo = (w.double() for w in dm._dense(p))
    E = EXAONE
    x = xs.double()
    S, hd = x.shape[0], E["hd"]
    q = (x @ wq).reshape(S, E["H"], hd).transpose(0, 1)
    k = (x @ wk).reshape(S, E["hkv"], hd).transpose(0, 1)
    v = (x @ wv).reshape(S, E["hkv"], hd).transpose(0, 1)
    g = E["H"] // E["hkv"]
    k, v = (t.repeat_interleave(g, dim=0) for t in (k, v))
    s = torch.matmul(q, k.transpose(-1, -2)) * sc
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    att = torch.matmul(torch.softmax(s.masked_fill(~mask, float("-inf")),
                                     -1), v)
    return att.transpose(0, 1).reshape(S, E["H"] * hd) @ wo


def step_breakdown(p, st, gen, C: int, reasons: dict) -> dict:
    """Device ms of the pieces of one decode step (all 32 slots) and one
    prefill chunk (C rows into slot 0) of the paged arm, each timed on its
    own with CUDA events: the projections on the path the engage reasons
    pick, the cache append, the attention and the output projection. The
    pieces write rows past the session's lengths, which nothing reads."""
    import torch
    from accl_tpu_torch.models import decode as dm
    from accl_tpu_torch.ops import flash as fl
    tp, h_l, hkv_l, hd = dm._geometry(p, st)
    out = {}
    for what, rows in (("decode step", st.seq_lens.shape[0]),
                       ("prefill chunk", C)):
        fused = reasons[what.split()[0]]["qkv"] is None
        x = torch.randn((rows, EXAONE["d_model"]), generator=gen,
                        device="cuda")
        qkv = dm._project_qkv(p, x, fused, None, None)
        q, k, v = dm._split_heads(qkv, h_l, hkv_l, hd)
        t = {"qkv projection": time_ms(
            lambda: dm._project_qkv(p, x, fused, None, None), 3)}
        if rows == C:
            t["append + span kernel"] = time_ms(lambda: fl.flash_prefill(
                q, k, v, st.k_pages, st.v_pages, st.block_tables,
                st.seq_lens, 0), 3)
            attn = fl.flash_prefill(q, k, v, st.k_pages, st.v_pages,
                                    st.block_tables, st.seq_lens, 0)[0]
        else:
            t["append"] = time_ms(lambda: fl.kv_cache_append(
                st.k_pages, st.v_pages, st.block_tables, st.seq_lens, k, v,
                active=st.active), 3)
            t["decode kernel"] = time_ms(lambda: fl.flash_decode(
                q, st.k_pages, st.v_pages, st.block_tables, st.seq_lens), 3)
            attn = fl.flash_decode(q, st.k_pages, st.v_pages,
                                   st.block_tables, st.seq_lens)
        t["output projection"] = time_ms(
            lambda: dm._project_out(p, attn, x, fused, None, None), 3)
        out[what] = t
    return out


def serving_paths(gen, kernel_ms: dict) -> dict:
    """Phase 3j: a serving session at K-EXAONE-236B's global-attention
    width (:data:`EXAONE`), tp 8 ranks on the card, f32, under an ``ACCL``
    session's registers: 32 slots of 8192 tokens in pages of 64 (2.1 GB of
    K and V pools an arm); every slot admitted, prompts of 512 to 4096
    tokens prefilled in the plan's chunks (448; most end in a partial
    chunk), 32 decode steps over every slot, slots 5 and 9 retired after
    step 16 and slot 5 admitted again. Two arms on their own pools: the
    paged one (``flash_decode_kernel`` exactly once a decode step,
    ``flash_decode_span_kernel`` once a chunk) and ``decode_mode`` /
    ``prefill_mode`` "unpaged" (neither kernel); their outputs within
    :data:`DECODE_REL` of scale, and on slots 0 and 31 the paged arm's
    prefill and decode outputs against a float64 attention block over each
    slot's whole sequence. p50 of a decode step and of a prefill chunk,
    tokens/s, and the projection path (fused or psum, with its engage
    reasons). Returns the launch counts of this part."""
    import torch
    from accl_tpu_torch import ACCL, Communicator
    from accl_tpu_torch.models import decode as dm
    from accl_tpu_torch.ops import flash as fl
    E = EXAONE
    d, tp, slots, page = E["d_model"], E["tp"], E["slots"], E["page"]
    acc = ACCL(world=tp, device="cuda")
    comm = Communicator(tp, "cuda")
    params = dm.init_decode_params(gen, d, E["H"], E["hkv"], E["hd"], tp)
    plan, _ = fl.prefill_plan(E["H"] // tp, E["hkv"] // tp, E["hd"], page,
                              E["pmax"], 4)
    C = plan["chunk"]
    reasons = {
        "decode": dm.decode_engage_reasons(slots, d, E["H"], E["hkv"],
                                           E["hd"], tp, page=page,
                                           pages_max=E["pmax"]),
        "prefill": dm.decode_engage_reasons(C, d, E["H"], E["hkv"], E["hd"],
                                            tp, page=page,
                                            pages_max=E["pmax"])}
    arms = {}
    for arm, mode in (("paged", None), ("unpaged", "unpaged")):
        st = dm.init_decode_state(slots, E["pmax"], page, E["hkv"],
                                  E["hd"], device="cuda")
        for s in range(slots):
            st = dm.admit(st, s)
        arms[arm] = {"state": st,
                     "pre": dm.build_prefill_step(comm, prefill_mode=mode),
                     "dec": dm.build_decode_step(comm, decode_mode=mode),
                     "t_pre": [], "t_dec": []}
    ref_slots = (0, slots - 1)
    seqs = {s: [] for s in ref_slots}          # each slot's hidden states
    outs = {s: [] for s in ref_slots}          # the paged arm's outputs
    prompt = [512 + (4096 - 512) * s // (slots - 1) for s in range(slots)]
    worst = {"prefill paged - unpaged": 0.0, "decode paged - unpaged": 0.0}
    per_chunk, per_step = [], []
    reset_counts()

    def run(arm, fn, *a, **kw):
        """One step of an arm: its output, state, host seconds and the
        decode kernels it launched."""
        r = arms[arm]
        c0 = (fl.paged_decode.launches, fl.paged_decode_span.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, r["state"] = fn(params, r["state"], *a, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return y, dt, (fl.paged_decode.launches - c0[0],
                       fl.paged_decode_span.launches - c0[1])

    for s in range(slots):
        for c0 in range(0, prompt[s], C):
            live = min(C, prompt[s] - c0)
            x = torch.zeros((C, d), device="cuda")
            x[:live] = torch.randn((live, d), generator=gen, device="cuda")
            ys = {}
            for arm in arms:
                ys[arm], dt, n = run(arm, arms[arm]["pre"], x, s, live=live)
                arms[arm]["t_pre"].append(dt)
                want = (0, 1) if arm == "paged" else (0, 0)
                if n != want:
                    fail(f"prefill chunk of slot {s} ({arm}) launched "
                         f"{n} decode kernels, not {want}")
            worst["prefill paged - unpaged"] = max(
                worst["prefill paged - unpaged"],
                near(f"prefill slot {s} chunk {c0 // C} paged - unpaged",
                     ys["paged"][:live], ys["unpaged"][:live], DECODE_REL))
            per_chunk.append(live)
            if s in seqs:
                seqs[s].append(x[:live])
                outs[s].append(ys["paged"][:live])
    for step in range(32):
        if step == 16:
            for arm in arms:
                st = dm.retire(dm.retire(arms[arm]["state"], 5), 9)
                arms[arm]["state"] = dm.admit(st, 5)
        x = torch.randn((slots, d), generator=gen, device="cuda")
        ys = {}
        for arm in arms:
            ys[arm], dt, n = run(arm, arms[arm]["dec"], x)
            arms[arm]["t_dec"].append(dt)
            want = (1, 0) if arm == "paged" else (0, 0)
            if n != want:
                fail(f"decode step {step} ({arm}) launched {n} decode "
                     f"kernels, not {want}")
        worst["decode paged - unpaged"] = max(
            worst["decode paged - unpaged"],
            near(f"decode step {step} paged - unpaged", ys["paged"],
                 ys["unpaged"], DECODE_REL))
        if step >= 16 and not bool((ys["paged"][9] == 0).all()):
            fail("a retired slot answered non-zero")
        per_step.append(int(arms["paged"]["state"].active.sum()))
        for s in ref_slots:
            seqs[s].append(x[s:s + 1])
            outs[s].append(ys["paged"][s:s + 1])
    launched = counts()
    lens = arms["paged"]["state"].seq_lens.tolist()
    for arm in arms:
        if arms[arm]["state"].seq_lens.tolist() != lens:
            fail(f"the {arm} arm's lengths differ")
    cap = E["pmax"] * page
    want_lens = [min(prompt[s] + 32, cap) for s in range(slots)]
    want_lens[5], want_lens[9] = 16, 0
    if lens != want_lens:
        fail(f"lengths after the session {lens} != {want_lens}")
    for s in ref_slots:
        y64 = serving_f64(params, torch.cat(seqs[s]), E["hd"] ** -0.5)
        worst[f"slot {s} paged - f64"] = near(
            f"slot {s} paged - float64", torch.cat(outs[s]), y64,
            DECODE_REL)
        del y64
    t_pre = statistics.median(arms["paged"]["t_pre"])
    t_dec = statistics.median(arms["paged"]["t_dec"])
    fused = {k: v for k, v in launched.items()
             if k in ("agmm_kernel", "mmrs_kernel") and v}
    report = {
        "chunk": C, "chunks": len(per_chunk),
        "prompt_tokens": sum(per_chunk), "decode_steps": 32,
        "p50_ms": {"prefill chunk paged": t_pre * 1e3,
                   "prefill chunk unpaged": statistics.median(
                       arms["unpaged"]["t_pre"]) * 1e3,
                   "decode step paged": t_dec * 1e3,
                   "decode step unpaged": statistics.median(
                       arms["unpaged"]["t_dec"]) * 1e3},
        "tokens_per_s": {"prefill paged": sum(per_chunk) / sum(
                             arms["paged"]["t_pre"]),
                         "decode paged": statistics.median(per_step) / t_dec},
        "projections": {"decode": "fused" if reasons["decode"]["qkv"] is None
                        and reasons["decode"]["wo"] is None else "psum",
                        "prefill": "fused" if reasons["prefill"]["qkv"] is None
                        and reasons["prefill"]["wo"] is None else "psum"},
        "engage_reasons": reasons, "fused_kernel_launches": fused,
        "decode_kernel_launches": {
            k: launched[k] for k in ("flash_decode_kernel",
                                     "flash_decode_span_kernel")},
        "errors": worst}
    report["breakdown_ms"] = step_breakdown(params, arms["paged"]["state"],
                                            gen, C, reasons)
    log(f"serving, K-EXAONE-236B global attention (64 x 128 over 8 KV "
        f"heads), tp {tp}, {slots} slots, f32: {json.dumps(report)}")
    log(f"decode kernels at these shapes (phase 2): {json.dumps(kernel_ms)}")
    del arms, params, seqs, outs
    acc.deinit()
    torch.cuda.empty_cache()
    return launched


# ---------------------------------------------------------------------------
# phase 3k: pipeline-parallel training
# ---------------------------------------------------------------------------

def transformer_loss64(params, x, y, heads: int) -> float:
    """The composed step's loss at (pp, 1, 1) in float64 on the card: each
    stage's block (attention with residual, then the tanh-GELU MLP with
    residual, no biases, no norm) over every microbatch's rows as the
    sequence; the mean over microbatches of the per-microbatch MSE."""
    import torch
    import torch.nn.functional as F
    M, b, d = x.shape
    dh = d // heads
    h = x.double()
    for p in range(params.attn.shape[0]):
        bucket = params.attn[p, 0, 0].double()
        wqkv = bucket[:3 * d * d].view(d, 3 * d)
        wo = bucket[3 * d * d:4 * d * d].view(d, d)

        def th(t):
            return t.reshape(M, b, heads, dh).transpose(1, 2)
        q, k, v = (h @ wqkv).split(d, -1)
        s = th(q) @ th(k).transpose(-2, -1) / math.sqrt(dh)
        o = (torch.softmax(s, -1) @ th(v)).transpose(1, 2).reshape(M, b, d)
        h = h + o @ wo
        u = F.gelu(h @ params.w1t[p, 0, 0].double().T, approximate="tanh")
        h = h + u @ params.w2t[p, 0, 0].double().T
        del bucket, wqkv, wo, q, k, v, s, o, u
    return ((h - y.double()) ** 2).mean(dim=(1, 2)).mean().item()


def scale_err(what: str, got, ref, rel: float) -> float:
    """max|got - ref| / max|ref|; fail above ``rel``."""
    err = (got.double() - ref.double()).abs().max().item()
    top = ref.double().abs().max().item()
    if err > rel * top:
        fail(f"{what}: max|diff| {err!r} > {rel} x {top!r}")
    return err / top


def compare_steps(what: str, a, b, rel: float) -> dict:
    """Two steps' (new params, loss) within ``rel`` of each tensor's largest
    magnitude; returns the ratios, and whether they are bit-equal."""
    import torch
    (pa, la), (pb, lb) = a, b
    out = {"bit_equal": bool(torch.equal(la, lb) and all(
        torch.equal(x, y) for x, y in zip(pa, pb)))}
    out["loss"] = scale_err(f"{what} loss", la, lb, rel)
    for f, x, y in zip(pa._fields, pa, pb):
        out[f] = scale_err(f"{what} new {f}", x, y, rel)
    return out


def planned(p) -> int:
    """Launches one body call makes under its plan."""
    return p.get("nmb", p.get("nnb", p.get("nctb", 1)))


def run_arm(step, params, x, y, iters: int):
    """One step with the counters at 0 (its result and every counter after
    it), then the p50 of ``iters`` more."""
    import torch
    reset_counts()
    new, loss = step(params, x, y)
    torch.cuda.synchronize()
    after = counts()
    return (new, loss), after, p50_call(lambda: step(params, x, y), iters)


def nonzero(c: dict) -> dict:
    return {k: v for k, v in c.items() if v}


def pp_paths(gen, kernel_ms: dict) -> dict:
    """Phase 3k: pipeline-parallel training at Megatron-LM 8.3B's block
    width (:data:`PIPE`; random weights from the seed, no biases, no norm),
    f32, SGD at lr 1e-2, one block per stage.

    * (pp 8, dp 1, tp 1), M 8 microbatches of 512 rows: the fused 1F1B step
      (one pp_relay_kernel launch per tick, 30 ticks; flash forward and
      fused backward), the requested ``overlap=False`` 1F1B baseline (the
      roll pair, no relay launch) and GPipe (no relay launch). Fused
      against baseline bit-equal or within 1e-6 of scale (which is
      printed), 1F1B against GPipe within 1e-4 of scale, the first loss
      against a float64 forward of the same parameters within 1e-4
      relative.
    * (pp 4, dp 2, tp 1), M 4, 512 rows per dp rank: the JAX plans decline
      the dual reduce-scatter (h 12288 rows) with ``vmem_miss``, so the step
      demotes whole to GPipe on the flat datapath, counted under
      op="pp_pipeline", and no collective-matmul kernel launches; it is held
      against the flat 1F1B step within 1e-4 of scale.
    * (pp 2, dp 4, tp 1), M 4, 512 rows per dp rank: the plans engage, and
      the fused 1F1B step launches agmm_kernel, mmrs_kernel and wgrad_kernel
      as many times as the plans give, against the flat 1F1B step within
      1e-4 of scale.
    * The relay ladder: ``build_pipeline_relay`` PALLAS against XLA at 4 KiB
      to 64 MiB per rank per direction, world 8, exact, p50s.

    Per arm: p50 per step, tokens/s (M x rows x dp per step), the schedule's
    bubble fraction and stash slots, launches per kernel per step, and the
    relay kernel's share of the step (its phase 2 time x its launches).
    ``kernel_ms``: pp_relay_kernel's time at this tick's shape (phase 2).
    Returns the launch counts of one fused step at (8, 1, 1)."""
    import torch
    import accl_tpu_torch as at
    from accl_tpu_torch.models import pipeline as pp
    from accl_tpu_torch.obs import metrics
    from accl_tpu_torch.parallel import algorithms

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for float32 matmuls")
    d, h, heads, rows, M = (PIPE[k] for k in ("d", "h", "heads", "rows",
                                              "M"))
    lr, f32 = 1e-2, torch.float32
    relay_ms = kernel_ms["pp_relay_kernel"]
    report = {}

    def arm_report(step, fired, p50, pp_, dp, M_):
        tab = pp.schedule_table(pp_, M_) if step.schedule == "1f1b" \
            else None
        return {"schedule": step.schedule, "fused": step.fused,
                "engage_reason": step.engage_reason,
                "p50_ms": p50 * 1e3,
                "tokens_per_s": M_ * rows * dp / p50,
                "bubble": tab.bubble_fraction if tab is not None
                else pp.gpipe_bubble_fraction(pp_, M_),
                "stash_slots": step.stash_slots, "launches": fired,
                "relay_share": relay_ms * fired.get("pp_relay_kernel", 0)
                / (p50 * 1e3)}

    # (pp 8, dp 1, tp 1): the three arms
    mesh = pp.make_pp_mesh("cuda", 8)
    params = pp.init_pp_transformer(gen, mesh, d, h, heads)
    # inputs and targets at XSCALE N(0, 1): see XSCALE
    x = torch.randn((M, rows, d), generator=gen, device="cuda") * XSCALE
    y = torch.randn((M, rows, d), generator=gen, device="cuda") * XSCALE
    tab = pp.schedule_table(8, M)
    steps = {"fused": pp.build_pp_transformer_train_step(
                 mesh, d, h, heads, M, lr, schedule="1f1b", wire_dtype="off"),
             "baseline": pp.build_pp_transformer_train_step(
                 mesh, d, h, heads, M, lr, schedule="1f1b", overlap=False),
             "gpipe": pp.build_pp_transformer_train_step(
                 mesh, d, h, heads, M, lr, schedule="gpipe",
                 wire_dtype="off")}
    res, main_counts = {}, None
    for name, step in steps.items():
        res[name], after, p50 = run_arm(step, params, x, y, 3)
        if name == "fused":
            main_counts = after
        report[f"(8,1,1) {name}"] = arm_report(step, nonzero(after), p50, 8,
                                               1, M)
    fired = report["(8,1,1) fused"]["launches"]
    if not steps["fused"].fused or steps["fused"].schedule != "1f1b":
        fail(f"the fused (8, 1, 1) step resolved {steps['fused'].schedule} "
             f"({steps['fused'].engage_reason})")
    if fired.get("pp_relay_kernel") != tab.steps:
        fail(f"one fused 1F1B step launched pp_relay_kernel "
             f"{fired.get('pp_relay_kernel')} times, not once per tick "
             f"({tab.steps})")
    if not fired.get("flash_fwd_kernel") or \
            not fired.get("flash_bwd_fused_kernel"):
        fail(f"the fused step did not run the flash kernels: {fired}")
    for name in ("baseline", "gpipe"):
        if report[f"(8,1,1) {name}"]["launches"].get("pp_relay_kernel"):
            fail(f"the {name} arm launched pp_relay_kernel")
    if steps["fused"].stash_slots != tab.stash_slots or tab.stash_slots > 8:
        fail(f"stash slots {steps['fused'].stash_slots}, table "
             f"{tab.stash_slots}")
    errs = {"fused - baseline": compare_steps(
                "(8,1,1) fused - baseline", res["fused"], res["baseline"],
                1e-6),
            "1f1b - gpipe": compare_steps(
                "(8,1,1) 1f1b - gpipe", res["fused"], res["gpipe"], 1e-4)}
    loss64 = transformer_loss64(params, x, y, heads)
    errs["loss - f64"] = abs(res["fused"][1].item() - loss64) / abs(loss64)
    if errs["loss - f64"] > 1e-4:
        fail(f"(8,1,1) loss {res['fused'][1].item()!r} vs float64 "
             f"{loss64!r}")
    report["(8,1,1) errors"] = errs
    report["(8,1,1) loss"] = res["fused"][1].item()
    report["(8,1,1) tick breakdown ms"] = pp_breakdown(params, x, heads)
    del res, params, x, y, steps
    torch.cuda.empty_cache()

    # (pp 4, dp 2, tp 1): the plans decline, the step demotes whole
    M2 = 4
    for shape, demoted in (((4, 2), True), ((2, 4), False)):
        pp_, dp = shape
        mesh = pp.make_pp_mesh("cuda", pp_, dp)
        params = pp.init_pp_transformer(gen, mesh, d, h, heads)
        x = torch.randn((M2, rows * dp, d), generator=gen,
                        device="cuda") * XSCALE
        y = torch.randn((M2, rows * dp, d), generator=gen,
                        device="cuda") * XSCALE
        key = "accl_cmatmul_fallback_total{op=\"pp_pipeline\"," \
              "reason=\"vmem_miss\"}"
        before = metrics.snapshot()["counters"].get(key, 0.0)
        fused = pp.build_pp_transformer_train_step(
            mesh, d, h, heads, M2, lr, schedule="1f1b", wire_dtype="off")
        flat = pp.build_pp_transformer_train_step(
            mesh, d, h, heads, M2, lr, schedule="1f1b", overlap=False)
        rf, fired_f, p50_f = run_arm(fused, params, x, y, 2)
        rb, fired_b, p50_b = run_arm(flat, params, x, y, 2)
        fired_f, fired_b = nonzero(fired_f), nonzero(fired_b)
        tag = f"({pp_},{dp},1)"
        cmm = ("agmm_kernel", "mmrs_kernel", "wgrad_kernel")
        if demoted:
            got = (fused.schedule, fused.fused, fused.engage_reason)
            if got != ("gpipe", False, "vmem_miss"):
                fail(f"{tag} resolved {got}, not the demotion to gpipe")
            if metrics.snapshot()["counters"].get(key, 0.0) != before + 1:
                fail(f"{tag} demotion not counted under op=pp_pipeline")
            if any(fired_f.get(k) for k in cmm + ("pp_relay_kernel",)):
                fail(f"{tag} demoted step launched {fired_f}")
        else:
            if not fused.fused or fused.schedule != "1f1b":
                fail(f"{tag} fused step resolved {fused.schedule} "
                     f"({fused.engage_reason})")
            ms, hb = rows, h // dp
            calls = 2 * pp_ * M2               # forwards and recomputes
            expect = {
                "agmm_kernel": calls * (
                    planned(cm_plan("agmm", hb, d, ms, dp))
                    + planned(cm_plan("agmm", d // dp, h, ms, dp))),
                "mmrs_kernel": calls // 2 * (
                    planned(cm_plan("mmrs", h, ms, d, dp))
                    + planned(cm_plan("mmrs", d, ms, h, dp))),
                "wgrad_kernel": calls // 2 * (
                    planned(cm_plan("wgrad", hb, d, ms, dp))
                    + planned(cm_plan("wgrad", d // dp, h, ms, dp))),
                "pp_relay_kernel": pp.schedule_table(pp_, M2).steps}
            got = {k: fired_f.get(k, 0) for k in expect}
            if got != expect:
                fail(f"{tag} fused step launched {got}, the plans give "
                     f"{expect}")
        if any(fired_b.get(k) for k in cmm + ("pp_relay_kernel",)):
            fail(f"{tag} flat step launched {fired_b}")
        report[f"{tag} fused"] = arm_report(fused, fired_f, p50_f, pp_, dp,
                                            M2)
        report[f"{tag} flat"] = arm_report(flat, fired_b, p50_b, pp_, dp,
                                           M2)
        report[f"{tag} errors"] = compare_steps(
            f"{tag} fused - flat", rf, rb, 1e-4)
        del rf, rb, params, x, y, fused, flat
        torch.cuda.empty_cache()

    # the relay ladder
    comm = at.Communicator(8, "cuda")
    pal = algorithms.build_pipeline_relay(comm, at.Algorithm.PALLAS)
    xla = algorithms.build_pipeline_relay(comm, at.Algorithm.XLA)
    ladder = {}
    for sz in (4 << 10, 16 << 10, 64 << 10, 256 << 10, MIB, 4 * MIB,
               16 * MIB, 64 * MIB):
        f = torch.randn((8, sz // 1024, 256), generator=gen, device="cuda")
        b = torch.randn((8, sz // 1024, 256), generator=gen, device="cuda")
        outs = pal(f, b), xla(f, b)
        for o in outs:
            if not (torch.equal(o[0], torch.roll(f, 1, 0))
                    and torch.equal(o[1], torch.roll(b, -1, 0))):
                fail(f"relay ladder at {sz} B per rank: not the shift")
        ladder[sz] = {"pallas_ms": time_queued_ms(lambda: pal(f, b), 20),
                      "xla_ms": time_queued_ms(lambda: xla(f, b), 20),
                      "pallas_host_ms": time_ms(lambda: pal(f, b), 20)}
        del f, b, outs
    report["relay ladder p50 ms (bytes per rank per direction)"] = ladder
    log(f"pipeline training, Megatron-LM 8.3B block (d {d}, ffn {h}, "
        f"{heads} heads), {rows} rows per microbatch, f32: "
        f"{json.dumps(report)}")
    log(f"pp_relay_kernel at the (8, 512, 3072) tick (phase 2): "
        f"{relay_ms!r} ms")
    torch.cuda.empty_cache()
    return main_counts


def pp_breakdown(params, x, heads: int) -> dict:
    """Device ms of a tick with all 8 stages busy at phase 3k's width, one
    microbatch each (the block's sublayers batched over the stages as the
    step batches them): each sublayer forward, and forward + backward
    (what a 1F1B backward tick runs: the recompute and the gradients of
    the input and the weights), and the flash kernels alone at the shape
    the attention sublayer gives them (8 x 32 heads of (512, 96))."""
    import torch
    from accl_tpu_torch.models import zero
    from accl_tpu_torch.ops import flash as fl
    P_, (rows, d) = params.attn.shape[0], x.shape[1:]
    hid = params.w1t.shape[-2]
    h0 = x[0].expand(P_, 1, rows, d).contiguous()

    def leaves():
        return (h0.clone().requires_grad_(),
                params.attn.reshape(P_, 1, -1).clone().requires_grad_(),
                params.w1t.reshape(P_, 1, hid, d).clone().requires_grad_(),
                params.w2t.reshape(P_, 1, d, hid).clone().requires_grad_())

    h, bucket, w1, w2 = leaves()
    subl = {
        "attention": (lambda: zero._attn_sublayer(h, bucket, d, 1, heads),
                      (h, bucket)),
        "mlp": (lambda: zero._mlp_sublayer(
            h, lambda xt: torch.matmul(w1, xt),
            lambda u: torch.matmul(w2, u), 1), (h, w1, w2))}
    q, k, v = (torch.randn((P_ * heads, rows, d // heads), device="cuda")
               .requires_grad_() for _ in range(3))
    subl["flash kernels"] = (lambda: fl.flash_attention(q, k, v), (q, k, v))
    out = {}
    for name, (fn, wrt) in subl.items():
        with torch.no_grad():
            out[f"{name} forward"] = time_queued_ms(fn, 5)

        def both(fn=fn, wrt=wrt):
            with torch.enable_grad():
                y = fn()
                torch.autograd.grad(y, wrt, torch.ones_like(y))
        out[f"{name} forward + backward"] = time_queued_ms(both, 5)
    return out


# ---------------------------------------------------------------------------
# phase 3l: the head-packed flash arm
# ---------------------------------------------------------------------------

#: the packed arm's kernels, and the general arm's
PACKED_KERNELS = ("flash_fwd_packed_kernel", "flash_bwd_fused_packed_kernel",
                  "flash_bwd_kv_packed_kernel", "flash_bwd_q_packed_kernel")
GENERAL_KERNELS = ("flash_fwd_kernel", "flash_bwd_fused_kernel",
                   "flash_bwd_kv_kernel", "flash_bwd_q_kernel")


def packed_paths(gen, kernel_ms: dict) -> dict:
    """Phase 3l: ``flash_attention_packed`` at Switch-Base-8's attention
    width (:data:`PACKED`: 12 heads of 64 at world 8, 2048 tokens per rank,
    ranks x heads on the leading axis: q, k and v (96, 2048, 64)), the
    entry's default scale, f32 and bf16, non-causal (the encoder) and
    causal (the decoder); T5's relative-position bias lies outside the
    entry and is not added. Each variant: one forward must launch
    ``flash_fwd_packed_kernel`` once, one forward and backward in mode
    fused also ``flash_bwd_fused_packed_kernel`` once (one dQ-slab run, the
    JAX policy's fused arm), in mode two_pass the packed pair once each,
    and no general kernel; ``flash_attention`` at d 64 (the general arm,
    general kernels only) against it within 1e-5 (f32) or 1e-2 (bf16) of
    each tensor's largest magnitude, and whether the bits agree; the fused
    and the two-pass gradients bit-equal; in f32 against float64 on heads
    0 and 57 (1e-5); p50 and tokens/s of the packed and general arms and
    of ``scaled_dot_product_attention`` (timed only). Then an odd head
    count through ``flash_attention_packed`` must launch only general
    kernels, and the pack and unpack copies are timed on their own.
    ``kernel_ms``: the packed kernels' times at this shape (phase 2).
    Returns the launch counts of this part."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import flash as fl

    H, S, d = PACKED["H"], PACKED["S"], PACKED["d"]
    tokens = SWITCH["P"] * S
    sc = d ** -0.5
    hs = [0, 57]
    reset_counts()
    report = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = "f32" if dt == torch.float32 else "bf16"
        rel = 1e-5 if dt == torch.float32 else 1e-2
        for causal in (False, True):
            name = f"{'decoder (causal)' if causal else 'encoder'} {dname}"
            xs = list(attn_operands(gen, H, H, S, d, dt))
            cot = xs.pop().float()
            arms = {
                "packed": lambda m, *t: fl.flash_attention_packed(
                    *t, causal=causal, bwd_mode=m),
                "general": lambda m, *t: fl.flash_attention(
                    *t, causal=causal, bwd_mode=m)}
            with torch.no_grad():
                yp, fwd_l = launched(lambda: arms["packed"](None, *xs))
                yg, gfwd_l = launched(lambda: arms["general"](None, *xs))
            if fwd_l != {"flash_fwd_packed_kernel": 1} or \
                    gfwd_l != {"flash_fwd_kernel": 1}:
                fail(f"packed {name}: one forward launched {fwd_l}, the "
                     f"general arm's {gfwd_l}")
            errs = {"out packed - general": near(
                f"packed {name} out - general", yp, yg, rel)}
            bits = {"out": torch.equal(yp, yg)}
            res, step_l = {}, {}
            for mode in ("fused", "two_pass"):
                for arm, prog in arms.items():
                    res[arm, mode], step_l[arm, mode] = launched(
                        lambda: step(lambda *t: prog(mode, *t), xs, cot))
                kinds = dict(zip(("fwd", "fused", "kv", "q"),
                                 zip(PACKED_KERNELS, GENERAL_KERNELS)))
                for i, arm in enumerate(("packed", "general")):
                    want = {kinds["fwd"][i]: 1}
                    for kind in (("fused",) if mode == "fused"
                                 else ("kv", "q")):
                        want[kinds[kind][i]] = 1
                    if step_l[arm, mode] != want:
                        fail(f"packed {name}: one {arm} forward + backward "
                             f"in mode {mode} launched {step_l[arm, mode]}")
                (_, gp), (_, gg) = res["packed", mode], res["general", mode]
                for g, b, w in zip(gp, gg, ("dq", "dk", "dv")):
                    errs[f"{w} packed - general ({mode})"] = near(
                        f"packed {name} {w} - general ({mode})", g, b, rel)
                    bits[f"{w} ({mode})"] = torch.equal(g, b)
            for a, b, w in zip(res["packed", "fused"][1],
                               res["packed", "two_pass"][1],
                               ("dq", "dk", "dv")):
                if not torch.equal(a, b):
                    fail(f"packed {name} {w}: two-pass bits differ from "
                         f"fused")
            if dt == torch.float32:
                y64, g64 = dense_f64(*(x[hs] for x in xs), cot[hs], sc,
                                     causal)
                errs["out packed - f64 (heads 0, 57)"] = near(
                    f"packed {name} out - f64", yp[hs], y64, 1e-5)
                for g, w64, w in zip(res["packed", "fused"][1], g64,
                                     ("dq", "dk", "dv")):
                    errs[f"{w} packed - f64 (heads 0, 57)"] = near(
                        f"packed {name} {w} - f64", g[hs], w64, 1e-5)
                del y64, g64
            del res, yg
            x4 = [x[None].detach().requires_grad_() for x in xs]
            cot4 = cot[None].to(dt)

            def sdpa():
                return F.scaled_dot_product_attention(
                    *x4, is_causal=causal, scale=sc)

            t = {}
            for arm, prog in arms.items():
                with torch.no_grad():
                    t[f"{arm} forward"] = p50_call(
                        lambda: prog(None, *xs), 5)
                for mode in ("fused", "two_pass"):
                    t[f"{arm} forward + backward ({mode})"] = p50_call(
                        lambda: step(lambda *a: prog(mode, *a), xs, cot), 3)
            with torch.no_grad():
                t["SDPA forward"] = p50_call(sdpa, 5)
            t["SDPA forward + backward"] = p50_call(
                lambda: sdpa().backward(cot4), 3)
            report[name] = {
                "p50_ms": {k: v * 1e3 for k, v in t.items()},
                "tokens_per_s": {k: tokens / v for k, v in t.items()},
                "launches per forward": fwd_l,
                "launches per forward + backward": {
                    m: step_l["packed", m] for m in ("fused", "two_pass")},
                "bit-equal to the general arm": bits, "errors": errs}
            log(f"packed {name}, Switch-Base-8 attention (96 x 2048 x 64), "
                f"{tokens} tokens: {json.dumps(report[name])}")
            del xs, cot, yp, x4, cot4, arms
            torch.cuda.empty_cache()

    # outside the envelope (an odd head count): the general kernels alone
    xs = list(attn_operands(gen, H - 1, H - 1, S, d, torch.float32))
    cot = xs.pop()
    _, odd_l = launched(lambda: step(
        lambda *t: fl.flash_attention_packed(*t), xs, cot))
    if set(odd_l) - set(GENERAL_KERNELS) or "flash_fwd_kernel" not in odd_l:
        fail(f"flash_attention_packed at {H - 1} heads launched {odd_l}")
    del xs, cot
    q = torch.randn((H, S, d), generator=gen, device="cuda")
    qp = fl._pack_heads(q)
    copies = {"pack (96, 2048, 64) f32": time_ms(
        lambda: fl._pack_heads(q), 5),
        "unpack (48, 2048, 128) f32": time_ms(
            lambda: fl._unpack_heads(qp), 5)}
    log(f"packed entry outside its envelope ({H - 1} heads): {odd_l}; the "
        f"copies alone, device ms (a forward makes three packs and one "
        f"unpack, a forward + backward four of each): {json.dumps(copies)}")
    report["copies_ms"] = copies
    del q, qp
    torch.cuda.empty_cache()
    log(f"packed flash kernels at this shape (phase 2): "
        f"{json.dumps(kernel_ms)}")
    return counts()


def cm_plan(op: str, a: int, b: int, c: int, P: int) -> dict:
    """The port's collective-matmul plan of one body call, f32,
    bidirectional (the composed step's defaults)."""
    import torch
    from accl_tpu_torch.ops import collective_matmul as cm
    f32 = torch.float32
    if op == "agmm":
        return cm.agmm_plan(a, b, c, P, f32, True, w_dtype=f32)
    if op == "mmrs":
        return cm.mmrs_plan(a, b, c, P, f32, True, w_dtype=f32)
    return cm.wgrad_plan(a, b, c, P, f32, f32, True)


# ---------------------------------------------------------------------------

REPLACES = {
    "rs_fold_kernel": "accl_tpu/parallel/pallas_ring.py:330",
    "ring_ag_kernel": "accl_tpu/parallel/pallas_ring.py:194",
    "chunked_rs_kernel": "accl_tpu/parallel/pallas_chunked.py:82",
    "chunked_ag_kernel": "accl_tpu/parallel/pallas_chunked.py:275",
    "combine_kernel": "accl_tpu/ops/reduce_ops.py:62",
    "cast_kernel": "accl_tpu/ops/compression.py:43",
    "sr_kernel": "accl_tpu/ops/compression.py:119",
    "bcast_relay_kernel": "accl_tpu/parallel/pallas_chunked.py:430",
    "scatter_copy_kernel": "accl_tpu/parallel/pallas_chunked.py:570",
    "gather_copy_kernel": "accl_tpu/parallel/pallas_chunked.py:856",
    "alltoall_copy_kernel": "accl_tpu/parallel/pallas_chunked.py:710",
    "a2a_mm_kernel": "accl_tpu/ops/collective_alltoall.py:230",
    "mm_a2a_kernel": "accl_tpu/ops/collective_alltoall.py:349",
    "agmm_kernel": "accl_tpu/ops/collective_matmul.py:418",
    "mmrs_kernel": "accl_tpu/ops/collective_matmul.py:543",
    "wgrad_kernel": "accl_tpu/ops/collective_matmul.py:1050",
    "a2a_wgrad_kernel": "accl_tpu/ops/collective_alltoall.py:466",
    "flash_fwd_kernel": "accl_tpu/ops/flash.py:62",
    "flash_bwd_fused_kernel": "accl_tpu/ops/flash.py:724",
    "flash_bwd_kv_kernel": "accl_tpu/ops/flash.py:612",
    "flash_bwd_q_kernel": "accl_tpu/ops/flash.py:658",
    "flash_fwd_packed_kernel": "accl_tpu/ops/flash.py:874",
    "flash_bwd_fused_packed_kernel": "accl_tpu/ops/flash.py:1147",
    "flash_bwd_kv_packed_kernel": "accl_tpu/ops/flash.py:982",
    "flash_bwd_q_packed_kernel": "accl_tpu/ops/flash.py:1024",
    "flash_decode_kernel": "accl_tpu/ops/flash.py:1590",
    "flash_decode_span_kernel": "accl_tpu/ops/flash.py:1661",
    "pp_relay_kernel": "accl_tpu/ops/pipeline_relay.py:155",
}
#: the streaming variant each kernel replaces as well
ALSO_REPLACES = {
    "agmm_kernel": "accl_tpu/ops/collective_matmul.py:676",
    "mmrs_kernel": "accl_tpu/ops/collective_matmul.py:896",
}
SOURCE = {"rs_fold_kernel": "ring.cu", "ring_ag_kernel": "ring.cu",
          "chunked_rs_kernel": "ring.cu", "chunked_ag_kernel": "ring.cu",
          "combine_kernel": "plugins.cu", "cast_kernel": "plugins.cu",
          "sr_kernel": "plugins.cu", "bcast_relay_kernel": "ring.cu",
          "scatter_copy_kernel": "ring.cu", "gather_copy_kernel": "ring.cu",
          "alltoall_copy_kernel": "ring.cu", "a2a_mm_kernel": "a2a.cu",
          "mm_a2a_kernel": "a2a.cu", "agmm_kernel": "cmatmul.cu",
          "mmrs_kernel": "cmatmul.cu", "wgrad_kernel": "cmatmul.cu",
          "a2a_wgrad_kernel": "a2a.cu", "flash_fwd_kernel": "flash.cu",
          "flash_bwd_fused_kernel": "flash.cu",
          "flash_bwd_kv_kernel": "flash.cu",
          "flash_bwd_q_kernel": "flash.cu",
          "flash_fwd_packed_kernel": "flash.cu",
          "flash_bwd_fused_packed_kernel": "flash.cu",
          "flash_bwd_kv_packed_kernel": "flash.cu",
          "flash_bwd_q_packed_kernel": "flash.cu",
          "flash_decode_kernel": "decode.cu",
          "flash_decode_span_kernel": "decode.cu",
          "pp_relay_kernel": "pipeline.cu"}
#: the part of phase 3 whose launch counts each kernel's entry reports
PART = {"rs_fold_kernel": "allreduce", "ring_ag_kernel": "allreduce",
        "chunked_rs_kernel": "allreduce", "chunked_ag_kernel": "allreduce",
        "combine_kernel": "slice2", "cast_kernel": "slice2",
        "sr_kernel": "slice2", "bcast_relay_kernel": "rooted",
        "scatter_copy_kernel": "rooted", "gather_copy_kernel": "rooted",
        "alltoall_copy_kernel": "alltoall", "a2a_mm_kernel": "moe",
        "mm_a2a_kernel": "moe", "agmm_kernel": "tp_mlp",
        "mmrs_kernel": "tp_mlp", "wgrad_kernel": "tp_train",
        "a2a_wgrad_kernel": "moe_train", "flash_fwd_kernel": "context",
        "flash_bwd_fused_kernel": "context", "flash_bwd_kv_kernel": "context",
        "flash_bwd_q_kernel": "context",
        "flash_fwd_packed_kernel": "packed",
        "flash_bwd_fused_packed_kernel": "packed",
        "flash_bwd_kv_packed_kernel": "packed",
        "flash_bwd_q_packed_kernel": "packed",
        "flash_decode_kernel": "serving",
        "flash_decode_span_kernel": "serving",
        "pp_relay_kernel": "pipeline"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from accl_tpu_torch import cuda_build

    # phase 1: build
    secs = cuda_build.build()
    for lib in cuda_build.SOURCES:
        cuda_build.load(lib)
    log(f"phase 1: built {sorted(cuda_build.SOURCES)} in {secs:.1f} s")
    for name, out in cuda_build.build_log.items():
        for fn, regs, spill in ptxas_report(out):
            log(f"  nvcc[{name}]: {fn}: {regs} registers, {spill} B spill "
                f"stores")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {name}; nvidia-smi: {card}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    check_kernels(gen)
    check_plugin_kernels(gen)
    check_relay_kernels(gen)
    check_alltoall_kernels(gen)
    check_moe_kernels(gen)
    check_cmatmul_kernels(gen)
    check_wgrad_kernel(gen)
    check_flash_kernels(gen)
    check_flash_packed_kernels(gen)
    check_decode_kernels(gen)
    check_pp_relay_kernel(gen)
    total = torch.cuda.get_device_properties(0).total_memory
    big_ok = total >= 60 * GIB
    meas = measure_kernels(gen, big_ok)
    meas.update(measure_plugin_kernels(gen))
    meas.update(measure_relay_kernels(gen, big_ok))
    meas.update(measure_alltoall_kernel(gen, big_ok))
    meas.update(measure_moe_kernels(gen))
    meas.update(measure_cmatmul_kernels(gen))
    meas.update(measure_flash_kernels(gen))
    meas.update(measure_flash_packed_kernels(gen))
    meas.update(measure_decode_kernels(gen))
    meas.update(measure_pp_relay_kernel(gen))

    parts = {"allreduce": main_path(gen), "slice2": slice2_paths(gen),
             "rooted": rooted_paths(gen, big_ok),
             "alltoall": alltoall_paths(gen, big_ok),
             "moe": moe_paths(gen, {k: meas[k]["ms"] for k in
                                    ("a2a_mm_kernel", "mm_a2a_kernel")}),
             "tp_mlp": tp_mlp_paths(gen, {k: meas[k]["ms"] for k in
                                          ("agmm_kernel", "mmrs_kernel")}),
             "tp_train": tp_train_paths(gen, {
                 k: meas[k]["ms"] for k in ("agmm_kernel", "mmrs_kernel",
                                            "wgrad_kernel")}),
             "moe_train": moe_train_paths(gen, {
                 k: meas[k]["ms"] for k in ("a2a_mm_kernel", "mm_a2a_kernel",
                                            "a2a_wgrad_kernel")}),
             "context": context_paths(gen, {
                 k: meas[k]["ms"] for k in GENERAL_KERNELS}),
             "serving": serving_paths(gen, {
                 k: meas[k]["ms"] for k in REPLACES if "decode" in k}),
             "pipeline": pp_paths(gen, {
                 "pp_relay_kernel": meas["pp_relay_kernel"]["ms"]}),
             "packed": packed_paths(gen, {
                 k: meas[k]["ms"] for k in PACKED_KERNELS})}
    launches = {k: parts[PART[k]][k] for k in REPLACES}
    for k, v in launches.items():
        if v <= 0:
            fail(f"{k} was not launched on the main path")
    kernels = []
    for k in REPLACES:
        m = meas[k]
        entry = {
            "name": k, "route": "cuda",
            "source": f"accl_tpu_torch/csrc/{SOURCE[k]}",
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": m["shape"]}
        for extra in ("ring_bound_ms", "tensor_core_bound_ms",
                      "f32_core_bound_ms",
                      "live_pages", "useful_gflop", "segments", "general_ms",
                      "causal_ms", "causal_general_ms", "causal_library_ms",
                      "causal_bound_ms"):
            if extra in m:
                entry[extra] = m[extra]
        if k in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[k]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
