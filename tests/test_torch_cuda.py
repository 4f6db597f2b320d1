"""The port's CUDA kernels (the ring kernels, the rooted ones, the
all-to-all, the plugin lanes, the fused MoE dispatch, combine and a2a-wgrad,
the collective matmuls with their gathered wgrad, the four flash
attention kernels and the four of its head-packed arm, the two paged
decode kernels and the pipeline relay)
against their plain PyTorch versions on the card:
bit-equal (``torch.equal``, or the raw bits where NaN can occur; the matmul
kernels on integer-valued operands), the flash kernels within 1e-5 (f32) or
1e-2 (bf16) of each tensor's largest magnitude, their backward bit-equal
across two runs and between the fused and the two-pass arm (the packed
kernels also bit-equal to the general ones at d 64), the decode
kernels within 1e-5; the context-parallel layers, the TP decode and
prefill steps and the pipeline train steps on the card against the CPU.
This test needs an NVIDIA GPU with ``nvcc`` (the kernels build at first
use); where no card is visible it skips. On the card, where JAX is not
installed, skip the suite's conftest: ``pytest --noconftest
tests/test_torch_cuda.py -m cuda``.

One test loops over every case and names the failing one in its message,
so the suite adds one item to the tier-1 collection."""
import math

import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ring kernels run only there)")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    return g


def _make(shape, dtype, gen):
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


DTYPES = [torch.float32, torch.int32, torch.bfloat16, torch.float16,
          torch.float64]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _specials(n: int, gen) -> torch.Tensor:
    """f32 with NaN, -NaN, +-0, +-inf, subnormals and out-of-range values
    spread over random data."""
    x = torch.randn(n, generator=gen, device="cuda")
    sp = torch.tensor([float("nan"), -float("nan"), 0.0, -0.0,
                       float("inf"), -float("inf"), 1e-40, -1e-40, 3.4e38,
                       -3.4e38, 65520.0, 65519.0, 6e-8, 1e-45],
                      device="cuda")
    x[::7][:sp.numel()] = sp
    return x
WIRES = [(torch.bfloat16, None), (torch.float16, None), (torch.int8, 10.0)]


def test_ring_kernels_on_card(gen, monkeypatch):
    """Every kernel against its plain version, then the host API on the
    card against the CPU, then the spin timeouts (last: they patch the
    spin bound)."""
    _reduce_scatter_kernels(gen)
    _allgather_kernels(gen)
    _alltoall_kernels(gen)
    _moe_kernels(gen)
    _cmatmul_kernels(gen)
    _flash_kernels(gen)
    _flash_packed_kernels(gen)
    _context_on_card(gen)
    _decode_kernels(gen)
    _serving_on_card(gen)
    _pp_relay_kernel(gen)
    _pipeline_on_card(gen)
    _accl_on_card(gen, monkeypatch)


def _reduce_scatter_kernels(gen):
    """rs_fold_kernel over P in {2, 3, 8} at L 1000, 1024 and 777 (the
    16-byte path with and without an element tail, and the element path):
    every dtype, SUM and MAX, f32 under each wire, and MAX on +-0 / NaN;
    chunked_rs_kernel with each wire, both directions; then the plugin
    combine kernel (the other fold)."""
    from accl_tpu_torch.constants import reduceFunction
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr
    for P in (2, 3, 8):
        for L in (1000, 1024, 777):
            for dtype in DTYPES:
                for f in (reduceFunction.SUM, reduceFunction.MAX):
                    x = _make((P, P, L), dtype, gen)
                    assert torch.equal(pr.ring_reduce_scatter(x, f),
                                       pr.plain_ring_reduce_scatter(x, f)), \
                        (P, L, dtype, f.name)
            for wire in WIRES:
                x = _make((P, P, L), torch.float32, gen) * 4
                assert torch.equal(
                    pr.ring_reduce_scatter(x, reduceFunction.SUM, wire),
                    pr.plain_ring_reduce_scatter(x, reduceFunction.SUM,
                                                 wire)), (P, L, wire)
    # IEEE maximum on +-0 / NaN: +0 > -0, NaN propagates
    for L in (1000, 777):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.where(torch.rand((8, 8, L), generator=gen,
                                       device="cuda") < 0.5, 0.0, -0.0)
            x[0, 3, ::97] = float("nan")
            x = x.to(dtype)
            assert _same_bits(pr.ring_reduce_scatter(x, reduceFunction.MAX),
                              pr.plain_ring_reduce_scatter(
                                  x, reduceFunction.MAX)), (L, dtype)
    f = reduceFunction.SUM
    for wire in WIRES:
        for bidir in (False, True):
            x = _make((8, 8, 5, 777), torch.float32, gen) * 4
            assert torch.equal(
                pc.chunked_reduce_scatter(x, f, wire, bidir),
                pc.plain_chunked_reduce_scatter(x, f, wire, bidir)), \
                (wire, bidir)
    _combine_kernel_cases(gen)


def _combine_kernel_cases(gen):
    """combine_kernel (csrc/plugins.cu) against plain_combine: every lane
    dtype, SUM and MAX, with and without donate, ragged, aligned and
    misaligned (scalar path), NaN and +-0 compared by bits."""
    from accl_tpu_torch.constants import reduceFunction
    from accl_tpu_torch.ops import reduce_ops as ro
    for dtype in (torch.float32, torch.bfloat16, torch.float16,
                  torch.int32):
        for n in (1000, 4096, 4099):
            if dtype == torch.int32:
                a, b = (torch.randint(-2 ** 31, 2 ** 31 - 1, (2, n),
                                      generator=gen, device="cuda",
                                      dtype=torch.int32))
            else:
                a = _specials(n, gen).to(dtype)
                b = torch.roll(_specials(n, gen), 1).to(dtype)
                b[::5] = -a[::5]
            for func in (reduceFunction.SUM, reduceFunction.MAX):
                want = ro.plain_combine(a, b, func)
                assert _same_bits(ro.pallas_combine(a, b, func), want), \
                    (dtype, n, func.name)
                acc = a.clone()
                out = ro.pallas_combine(acc, b, func, donate=True)
                assert out is acc and _same_bits(out, want), \
                    (dtype, n, func.name, "donate")
                a1, b1 = a[1:], b[1:]          # 16-byte misaligned
                assert _same_bits(ro.pallas_combine(a1, b1, func),
                                  ro.plain_combine(a1, b1, func)), \
                    (dtype, n, func.name, "misaligned")


def _allgather_kernels(gen):
    """ring_ag_kernel and chunked_ag_kernel, then the rooted kernels (their
    transport cousins), then the plugin cast and stochastic-round kernels
    (the wire)."""
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr
    for dtype in (torch.int8, torch.bfloat16, torch.float32, torch.int64):
        b = _make((8, 1234), torch.float32, gen).mul(50).to(dtype)
        assert torch.equal(pr.ring_allgather(b),
                           pr.plain_ring_allgather(b)), dtype
        for bidir in (False, True):
            b = _make((8, 4, 1234), torch.float32, gen).mul(50).to(dtype)
            assert torch.equal(pc.chunked_allgather(b, bidir),
                               pc.plain_chunked_allgather(b, bidir)), \
                (dtype, bidir)
    _relay_kernel_cases(gen)
    _cast_and_round_cases(gen)


def _relay_kernel_cases(gen):
    """bcast_relay_kernel, scatter_copy_kernel and gather_copy_kernel
    against their plain versions, by bits: P in {2, 3, 8}, roots 0, P-1 and
    a middle rank, one and three segments of a ragged length (777) and,
    for the scatter and gather, an aligned one (1024), so blocks take both
    the 16-byte and the element path; 1-, 2-, 4- and 8-byte elements (f32
    with NaN and +-0). The root's row, which these kernels leave unwritten,
    is not compared. Then a gather whose send rows alias its receive
    buffer, at roots 3 and 0, through the body that hands the kernel the
    root's receive row."""
    from accl_tpu_torch.parallel import pallas_chunked as pc

    def data(shape, dtype):
        x = _specials(math.prod(shape), gen).view(*shape)
        return x.to(dtype) if dtype.is_floating_point else \
            x.nan_to_num(0.0).mul(50).to(dtype)

    for P in (2, 3, 8):
        for root in sorted({0, P // 2, P - 1}):
            keep = [r for r in range(P) if r != root]
            for dtype in (torch.int8, torch.bfloat16, torch.float32,
                          torch.int64):
                for C in (1, 3):
                    x = data((P, C, 777), dtype)
                    assert _same_bits(pc.chunked_bcast(x, root)[keep],
                                      pc.plain_chunked_bcast(x, root)[keep]), \
                        ("bcast", P, root, dtype, C)
                    for S in (777, 1024):
                        x, xs = data((P, C, S), dtype), \
                            data((P, P, C, S), dtype)
                        for name, got, want in (
                                ("scatter", pc.chunked_scatter(xs, root),
                                 pc.plain_chunked_scatter(xs, root)),
                                ("gather", pc.chunked_gather(x, root),
                                 pc.plain_chunked_gather(x, root))):
                            assert _same_bits(got[keep], want[keep]), \
                                (name, P, root, dtype, C, S)
    # the send buffer is the receive buffer: x = dest[:, :n], n one
    # 4096-byte segment, so the root's slot 0 is x[root]
    P, n = 8, 1024
    for root in (3, 0):
        dest = data((P, P * n), torch.float32)
        want = dest.clone()
        want[root] = dest[:, :n].reshape(-1)
        pc.chunked_gather_body(dest[:, :n], dest, P=P, root=root,
                               dtype=torch.float32, segment_bytes=4096)
        assert _same_bits(dest, want), ("aliased gather", root)


def _cast_and_round_cases(gen):
    """cast_kernel over the four CAST_PAIRS and sr_kernel (scalar and
    per-row seeds, ragged and aligned) against their plain versions, by
    bits; NaN keeps the JAX lane's patterns."""
    from accl_tpu_torch.ops import compression as cp
    for n in (1000, 4096, 4099):
        x = _specials(n, gen)
        for dst in (torch.bfloat16, torch.float16):
            y = cp.pallas_cast(x, dst)
            assert _same_bits(y, cp.plain_cast(x, dst)), (n, dst)
            assert _same_bits(cp.pallas_cast(y, torch.float32),
                              cp.plain_cast(y, torch.float32)), (n, dst)
        assert _bits(cp.pallas_cast(x, torch.bfloat16))[:8:7].tolist() == \
            [0x7FC0, -64]                       # 0x7FC0, 0xFFC0
        for seed in (0, 7, -123456789):
            assert _same_bits(
                cp.pallas_compress_stochastic(x, seed=seed),
                cp.plain_compress_stochastic(x, seed)), (n, seed)
        rows = _specials(8 * n, gen).view(8, n)
        seeds = torch.arange(-3, 5, dtype=torch.int32, device="cuda") * 977
        assert _same_bits(cp.pallas_compress_stochastic(rows, seed=seeds),
                          cp.plain_compress_stochastic(rows, seeds)), n


def _accl_on_card(gen, monkeypatch):
    """The host API on the card against the same program on the CPU, on
    the flat, ring-kernel and segmented-kernel paths, each call completed
    by its request, and the rooted collectives below and above their
    kernels' 8 MiB threshold; then hop timeouts fail their requests: the
    all-reduce's all-gather ring (its reduce-scatter fold waits on
    nothing) and the reduce's segmented reduce-scatter (its one-hop gather
    waits on nothing); the one-hop all-to-all waits on nothing and
    completes."""
    import accl_tpu_torch as at
    from accl_tpu_torch.parallel import pallas_ring as pr
    for nbytes in (4, 1 << 20, 4 << 20, 16 << 20):
        count = nbytes // 4
        x = _make((8, count), torch.float32, gen)
        out = {}
        for dev in ("cuda", "cpu"):
            acc = at.ACCL(world=8, device=dev, config=at.ACCLConfig(
                transport=at.TransportBackend.ICI))
            s = acc.create_buffer(count, at.dataType.float32)
            r = acc.create_buffer(count, at.dataType.float32)
            s.device_store(x.to(dev))
            req = acc.allreduce(s, r, count, at.reduceFunction.SUM,
                                from_device=True, to_device=True,
                                run_async=True)
            req.wait()
            out[dev] = r.data.cpu()
        assert torch.equal(out["cuda"], out["cpu"]), nbytes
    _rooted_on_card(gen)
    _alltoall_and_moe_on_card(gen)
    _mlp_on_card()

    # with a zero spin bound every hop that has to wait times out: the
    # launches still return, and the call's request raises at wait
    monkeypatch.setattr(pr, "SPIN_TIMEOUT_S", 0.0)
    acc = at.ACCL(world=8, config=at.ACCLConfig(
        transport=at.TransportBackend.ICI))
    count = (4 << 20) // 4
    s = acc.create_buffer(count, at.dataType.float32)
    r = acc.create_buffer(count, at.dataType.float32)
    s.device_store(_make((8, count), torch.float32, gen))
    req = acc.allreduce(s, r, count, at.reduceFunction.SUM,
                        from_device=True, to_device=True, run_async=True)
    with pytest.raises(at.ACCLError) as ei:
        req.wait()
    assert ei.value.code == at.errorCode.KRNL_TIMEOUT_STS_ERROR
    assert req.status == at.requestStatus.ERROR
    d = acc.create_buffer(count, at.dataType.float32)
    req = acc.reduce(s, d, count, 5, at.reduceFunction.SUM,
                     from_device=True, to_device=True, run_async=True,
                     algorithm=at.Algorithm.PALLAS)
    with pytest.raises(at.ACCLError) as ei:
        req.wait()
    assert ei.value.code == at.errorCode.KRNL_TIMEOUT_STS_ERROR
    req = acc.alltoall(s, d, count // 8, from_device=True, to_device=True,
                       run_async=True, algorithm=at.Algorithm.PALLAS)
    req.wait()
    assert torch.equal(d.data.view(8, 8, -1),
                       s.data.view(8, 8, -1).transpose(0, 1))


def _alltoall_kernels(gen):
    """alltoall_copy_kernel against its plain version, by bits: P in {2, 3,
    8}, one and three segments of a ragged length (777, the element path)
    and an aligned one (1024, the 16-byte path), 1-, 2-, 4- and 8-byte
    elements (f32 with NaN and +-0). Each rank's own slot, which the kernel
    leaves unwritten, is not compared."""
    from accl_tpu_torch.parallel import pallas_chunked as pc
    for P in (2, 3, 8):
        off = ~torch.eye(P, dtype=torch.bool, device="cuda")
        for dtype in (torch.int8, torch.bfloat16, torch.float32,
                      torch.int64):
            for C in (1, 3):
                for S in (777, 1024):
                    x = _specials(P * P * C * S, gen).view(P, P, C, S)
                    x = x.to(dtype) if dtype.is_floating_point else \
                        x.nan_to_num(0.0).mul(50).to(dtype)
                    assert _same_bits(pc.chunked_alltoall(x)[off],
                                      pc.plain_chunked_alltoall(x)[off]), \
                        (P, dtype, C, S)


def _moe_kernels(gen):
    """a2a_mm_kernel, mm_a2a_kernel and a2a_wgrad_kernel against their plain
    versions on integer-valued operands (exact): worlds 2, 3 and 8, the
    aligned and an uneven shape, f32 and bf16 token payloads, the combine
    rounded to f32, bf16 and f16, the wgrad in both orientations with one
    and (P >= 4) two channels and an f32 or bf16 traveller."""
    from accl_tpu_torch.ops import collective_alltoall as ca

    def ints(shape, lo=-4, hi=5):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda") \
            .float()

    for P in (2, 3, 8):
        for el, C, d, h in ((2, 8, 128, 128), (2, 5, 72, 40)):
            case = (P, el, C, d, h)
            x, w = ints((P, P * el, C, d)), ints((P, el, d, h))
            for xdt in (torch.float32, torch.bfloat16):
                xx = x.to(xdt)
                assert torch.equal(ca.a2a_mm(xx, w),
                                   ca.plain_a2a_mm(xx, w)), (case, xdt)
            hx, wo = ints((P, el, P * C, h), -9, 10), ints((P, el, h, d))
            for odt in (torch.float32, torch.bfloat16, torch.float16):
                assert torch.equal(ca.mm_a2a(hx, wo, odt),
                                   ca.plain_mm_a2a(hx, wo, odt)), (case, odt)
            loc = ints((P, el, P * C, h))
            for nchan in ((1, 2) if P >= 4 else (1,)):
                for lhs in (True, False):
                    for tdt in (torch.float32, torch.bfloat16):
                        xx = x.to(tdt)
                        assert torch.equal(
                            ca.a2a_wgrad(xx, loc, nchan, lhs),
                            ca.plain_a2a_wgrad(xx, loc, nchan, lhs)), \
                            ("a2a_wgrad", case, nchan, lhs, tdt)


#: the operand dtype pairs of the collective-matmul cases: f32, 16-bit pairs
#: (the split-TF32 kernels take them unsplit) and mixed ones
_CM_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float16, torch.float16), (torch.bfloat16, torch.float32),
              (torch.float32, torch.float16))


def _f32_sum_bound(k, mag):
    """Two f32 sums of the same k products in different orders each lie
    within k 2^-24 sum|a b| of the exact value."""
    return 2 * k * 2.0 ** -24 * mag


def _cmatmul_kernels(gen):
    """agmm_kernel, mmrs_kernel and wgrad_kernel against their plain
    versions on integer-valued operands (exact), through the bodies, whose
    plans pick the launches: worlds 2, 3 and 8, bidirectional off and on (P
    >= 4), an aligned per-rank shape, a ragged one, one straddling the 128
    x 128 block tile and one whose rows do not start on 16 bytes, the
    resident plan and, with the plan budget pinched, the k-blocked and the
    accumulator-blocked ones (the wgrad's streaming column blocks), the
    operand dtype pairs of _CM_DTYPES, f32 and a bf16 wire (the travelling
    sum past 256, so it rounds), the wgrad in both orientations; then
    random operands at the smallest contraction (k 8 a hop, 8 rows a rank)
    within :func:`_f32_sum_bound` of the plain versions."""
    from accl_tpu_torch.ops import collective_matmul as cm

    def ints(shape, lo=-9, hi=10):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda") \
            .float()

    _wgrad_kernel_cases(cm, ints, gen)
    kernels = (cm.agmm, cm.mmrs)
    saved = cm._VMEM_BUDGET

    def both(x, xr, w, bidir, wire):
        return (cm.all_gather_matmul_body(x, w, overlap=True,
                                          bidirectional=bidir,
                                          wire_dtype=wire),
                cm.matmul_reduce_scatter_body(xr, w, overlap=True,
                                              bidirectional=bidir,
                                              wire_dtype=wire))

    def plain(*args):
        cm.agmm, cm.mmrs = cm.plain_agmm, cm.plain_mmrs
        try:
            return both(*args)
        finally:
            cm.agmm, cm.mmrs = kernels

    try:
        for P in (2, 3, 8):
            for m, k, n in ((32, 256, 256), (12, 72, 40), (136, 264, 200),
                            (20, 37, 45)):
                for xdt, wdt in _CM_DTYPES:
                    x, xr, w = ints((P, m, k)).to(xdt), \
                        ints((P, P * m, k)).to(xdt), ints((P, k, n)).to(wdt)
                    for budget in (12 << 20, 200 << 10, 96 << 10):
                        cm._VMEM_BUDGET = budget
                        for bidir in ((False, True) if P >= 4 else (False,)):
                            for wire in ("off", "bf16"):
                                case = (P, m, k, n, xdt, wdt, budget, bidir,
                                        wire)
                                got = both(x, xr, w, bidir, wire)
                                want = plain(x, xr, w, bidir, wire)
                                assert torch.equal(got[0], want[0]), \
                                    ("agmm", case)
                                assert torch.equal(got[1], want[1]), \
                                    ("mmrs", case)
            cm._VMEM_BUDGET = saved
            x, xr, w = (torch.randn(s, generator=gen, device="cuda")
                        for s in ((P, 8, 8), (P, P * 8, 8), (P, 8, 40)))
            got, want = both(x, xr, w, True, "off"), \
                plain(x, xr, w, True, "off")
            mag = plain(x.abs(), xr.abs(), w.abs(), True, "off")
            for i, K in enumerate((8, P * 8)):
                assert bool(((got[i] - want[i]).abs()
                             <= _f32_sum_bound(K, mag[i])).all()), \
                    ("random", ("agmm", "mmrs")[i], P)
    finally:
        cm._VMEM_BUDGET = saved


def _wgrad_kernel_cases(cm, ints, gen):
    """wgrad_kernel through ``gathered_wgrad_body`` against the same body
    on its plain version: worlds 2, 3 and 8, one and two channels, an
    aligned and a ragged shard (ms 12: channel 1 from row 8), one
    straddling the 128 x 128 block tile and one whose rows do not start on
    16 bytes, the resident plan and the streaming one (ct in 128-column
    blocks), both orientations, the operand dtype pairs of _CM_DTYPES, f32
    and a bf16 wire (traveller past bf16's 8 bits); then random operands at
    the smallest contraction (8 rows a rank) within :func:`_f32_sum_bound`."""
    saved = cm._VMEM_BUDGET

    def run(trav, loc, bidir, wire, lhs):
        return cm.gathered_wgrad_body(trav, loc, overlap=True,
                                      bidirectional=bidir, wire_dtype=wire,
                                      travel_lhs=lhs)

    def plain(*args):
        kernel, cm.wgrad = cm.wgrad, cm.plain_wgrad
        try:
            return run(*args)
        finally:
            cm.wgrad = kernel

    try:
        for P in (2, 3, 8):
            for ms, ct, cl in ((32, 256, 128), (12, 256, 40), (136, 264, 200),
                               (20, 37, 45)):
                for tdt, ldt in _CM_DTYPES:
                    for budget in (12 << 20, 150 << 10):
                        cm._VMEM_BUDGET = budget
                        for bidir in ((False, True) if P >= 4 else (False,)):
                            for lhs in (True, False):
                                for wire in ("off", "bf16"):
                                    case = (P, ms, ct, cl, tdt, ldt, budget,
                                            bidir, lhs, wire)
                                    lo = -600 if wire == "bf16" else -9
                                    trav = ints((P, ms, ct), lo, -lo).to(tdt)
                                    loc = ints((P, P * ms, cl)).to(ldt)
                                    args = (trav, loc, bidir, wire, lhs)
                                    assert torch.equal(run(*args),
                                                       plain(*args)), \
                                        ("wgrad", case)
            cm._VMEM_BUDGET = saved
            trav = torch.randn((P, 8, 72), generator=gen, device="cuda")
            loc = torch.randn((P, P * 8, 40), generator=gen, device="cuda")
            for lhs in (True, False):
                got, want = run(trav, loc, True, "off", lhs), \
                    plain(trav, loc, True, "off", lhs)
                mag = plain(trav.abs(), loc.abs(), True, "off", lhs)
                assert bool(((got - want).abs()
                             <= _f32_sum_bound(P * 8, mag)).all()), \
                    ("random wgrad", P, lhs)
    finally:
        cm._VMEM_BUDGET = saved


def _mlp_on_card():
    """The TP MLP forward and train step (fused and baseline) on the card
    against the same calls on the CPU, within rtol 1e-5 / atol 1e-6 (the
    f32 matmuls sum in another order)."""
    import accl_tpu_torch as at
    from accl_tpu_torch.models import mlp
    g = torch.Generator(device="cpu")
    g.manual_seed(5)
    dense = mlp.init_params(g, 128, 512)
    x = torch.randn((64, 128), generator=g)
    targets = torch.randn((64, 128), generator=g)
    for dp, tp in ((1, 8), (2, 4)):
        for overlap in (True, False):
            got, step = {}, {}
            for dev in ("cuda", "cpu"):
                c = at.Communicator(dp * tp, dev)
                p = mlp.shard_params(dense, c, dp, tp)
                got[dev] = mlp.make_forward(c, dp, tp, overlap=overlap)(
                    p, x.to(dev)).cpu()
                new, loss = mlp.make_train_step(c, dp, tp, overlap=overlap)(
                    p, x.to(dev), targets.to(dev))
                step[dev] = [t.cpu() for t in (*new, loss)]
            case = f"mlp dp={dp} tp={tp} overlap={overlap}"
            torch.testing.assert_close(got["cuda"], got["cpu"], rtol=1e-5,
                                       atol=1e-6, msg=case)
            for a, b in zip(step["cuda"], step["cpu"]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                           msg=f"train step {case}")


def _alltoall_and_moe_on_card(gen):
    """ACCL.alltoall in its three families and the MoE forward and
    backward (fused and baseline) on the card against the same calls on the
    CPU: the all-to-all bit-equal, the MoE layer within rtol 1e-5 / atol
    1e-6 and its gradients within rtol 1e-5 and 1e-6 of each tensor's
    largest magnitude (the f32 matmuls sum in another order)."""
    import accl_tpu_torch as at
    from accl_tpu_torch.models import moe
    f32 = at.dataType.float32
    n = (16 << 20) // 4 // 8
    x = _make((8, 8 * n), torch.float32, gen)
    for algo in ("xla", "flat", "pallas"):
        out = {}
        for dev in ("cuda", "cpu"):
            acc = at.ACCL(world=8, device=dev, config=at.ACCLConfig(
                transport=at.TransportBackend.ICI))
            s, r = acc.create_buffer(8 * n, f32), acc.create_buffer(8 * n,
                                                                    f32)
            s.device_store(x.to(dev))
            acc.alltoall(s, r, n, from_device=True, to_device=True,
                         algorithm=at.Algorithm(algo))
            out[dev] = r.data.cpu()
        assert torch.equal(out["cuda"], out["cpu"]), algo
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    comm = at.Communicator(4, "cpu")
    params = moe.init_params(g, comm, 128, 256, 8)
    tokens = torch.randn((4, 64, 128), generator=g)
    cot = torch.randn((4, 64, 128), generator=g)
    for overlap in (True, False):
        got, grads = {}, {}
        for dev in ("cuda", "cpu"):
            c = at.Communicator(4, dev)
            p = moe.MoEParams(*(t.detach().clone().requires_grad_()
                                for t in moe.shard_params(params, c)))
            xt = tokens.to(dev).detach().requires_grad_()
            out = moe.build_moe_forward(c, 8, 24, top_k=2,
                                        overlap=overlap)(p, xt)
            (out * cot.to(dev)).sum().backward()
            got[dev] = out.detach().cpu()
            grads[dev] = [t.grad.cpu() for t in (*p, xt)]
        torch.testing.assert_close(got["cuda"], got["cpu"], rtol=1e-5,
                                   atol=1e-6, msg=f"moe overlap={overlap}")
        for name, a, b in zip(("router", "w_in", "w_out", "x"),
                              grads["cuda"], grads["cpu"]):
            torch.testing.assert_close(
                a, b, rtol=1e-5, atol=1e-6 * b.abs().max().item(),
                msg=f"moe d{name} overlap={overlap}")


def _rooted_on_card(gen):
    """bcast, scatter, gather and reduce through the host API on the card
    against the CPU, AUTO at 64 KiB and 16 MiB per rank (a plain family,
    then the PALLAS kernels: the gather's writes the root's receive row in
    place), the receive buffers pre-filled."""
    import accl_tpu_torch as at
    f32 = at.dataType.float32
    for nbytes in (64 << 10, 16 << 20):
        n = nbytes // 4
        x = _make((8, 8 * n), torch.float32, gen)
        pre = _make((8, 8 * n), torch.float32, gen)
        out = {}
        for dev in ("cuda", "cpu"):
            acc = at.ACCL(world=8, device=dev, config=at.ACCLConfig(
                transport=at.TransportBackend.ICI))

            def buf(count, t):
                b = acc.create_buffer(count, f32)
                b.device_store(t[:, :count].contiguous().to(dev))
                return b

            kw = {"from_device": True, "to_device": True}
            b = buf(n, x)
            acc.bcast(b, n, 2, **kw)
            s, r = buf(8 * n, x), buf(n, pre)
            acc.scatter(s, r, n, 7, **kw)
            g_s, g_r = buf(n, x), buf(8 * n, pre)
            acc.gather(g_s, g_r, n, 0, **kw)
            d_s, d_r = buf(n, x), buf(n, pre)
            acc.reduce(d_s, d_r, n, 5, at.reduceFunction.SUM, **kw)
            acc.barrier()
            out[dev] = [t.data.cpu() for t in (b, r, g_r, d_r)]
        for op, a, c in zip(("bcast", "scatter", "gather", "reduce"),
                            out["cuda"], out["cpu"]):
            assert torch.equal(a, c), (op, nbytes)


def _near(what, got, want, rel):
    top = want.double().abs().max().item()
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rel * top, f"{what}: max|err| {err} > {rel} x {top}"


def _flash_kernels(gen):
    """flash_fwd_kernel and the three backward kernels against their plain
    versions (f32 and bf16, causal and not, d 64 / 96 / 128 and a padded
    d 40, H = H_kv and H = 4 H_kv, S 128 to 1024); the fused and two-pass
    gradients bit-equal, two runs bit-equal, and the fused backward split
    into several launches (a small dQ slab budget) bit-equal to one."""
    from accl_tpu_torch.ops import flash as fl
    cases = [(2, 2, 128, 64, False, torch.float32),
             (4, 1, 256, 96, True, torch.float32),
             (2, 2, 1024, 128, True, torch.float32),
             (8, 2, 512, 40, False, torch.float32),
             (4, 4, 512, 96, True, torch.bfloat16),
             (4, 1, 256, 64, False, torch.float16)]
    for H, hkv, S, d, causal, dt in cases:
        case = (H, hkv, S, d, causal, dt)
        rel = 1e-5 if dt == torch.float32 else 1e-2
        q = _make((H, S, d), dt, gen)
        k, v = (_make((hkv, S, d), dt, gen) for _ in range(2))
        sc = d ** -0.5
        out, lse = fl.flash_fwd(q, k, v, causal, sc)
        pout, plse = fl.plain_flash_fwd(q, k, v, causal, sc)
        _near(f"fwd out {case}", out.float(), pout.float(), rel)
        _near(f"fwd lse {case}", lse, plse, 1e-5)
        do = _make((H, S, d), dt, gen)
        dd = (do.float() * out.float()).sum(-1) - torch.randn(
            (H, S), generator=gen, device="cuda")
        fused = fl.flash_bwd_fused(q, k, v, do, lse, dd, causal, sc)
        two = (fl.flash_bwd_q(q, k, v, do, lse, dd, causal, sc),
               *fl.flash_bwd_kv(q, k, v, do, lse, dd, causal, sc))
        plain = fl.plain_flash_bwd_fused(q, k, v, do, lse, dd, causal, sc)
        again = fl.flash_bwd_fused(q, k, v, do, lse, dd, causal, sc)
        saved = fl._DQ_SLAB_BUDGET
        fl._DQ_SLAB_BUDGET = H * S * d * 4 * 3      # 3 k tiles a launch
        try:
            split = fl.flash_bwd_fused(q, k, v, do, lse, dd, causal, sc)
        finally:
            fl._DQ_SLAB_BUDGET = saved
        for n, name in enumerate(("dq", "dk", "dv")):
            _near(f"bwd {name} {case}", fused[n], plain[n], 1e-5)
            assert torch.equal(fused[n], two[n]), (name, case)
            assert torch.equal(fused[n], again[n]), (name, case)
            assert torch.equal(fused[n], split[n]), (name, case)
    torch.cuda.synchronize()


def _flash_packed_kernels(gen):
    """The four packed kernels against their plain versions and, at d 64,
    bit-equal to the general kernels on the unpacked heads (f32, bf16 and
    f16, causal and not, H 2 to 8, S 128 to 1024); the fused and two-pass
    gradients bit-equal, and the fused backward split into several
    launches bit-equal to one; then the entry point against
    ``flash_attention``, bit for bit, launching only packed kernels."""
    from accl_tpu_torch.ops import flash as fl
    cases = [(2, 128, False, torch.float32), (4, 256, True, torch.float32),
             (8, 1024, True, torch.float32), (4, 512, False, torch.bfloat16),
             (2, 256, True, torch.float16)]
    for H, S, causal, dt in cases:
        case = (H, S, causal, dt)
        rel = 1e-5 if dt == torch.float32 else 1e-2
        q, k, v, do = (_make((H // 2, S, 128), dt, gen) for _ in range(4))
        heads = [fl._unpack_heads(t).contiguous() for t in (q, k, v, do)]
        sc = 64 ** -0.5
        out, lse = fl.flash_fwd_packed(q, k, v, causal, sc)
        pout, plse = fl.plain_flash_fwd_packed(q, k, v, causal, sc)
        _near(f"packed fwd out {case}", out.float(), pout.float(), rel)
        _near(f"packed fwd lse {case}", lse, plse, 1e-5)
        gout, glse = fl.flash_fwd(*heads[:3], causal, sc)
        assert torch.equal(fl._unpack_heads(out), gout), case
        assert torch.equal(lse.reshape(H, S), glse), case
        dd = (do.float() * out.float()).reshape(H // 2, S, 2, 64).sum(-1) \
            .transpose(1, 2).contiguous() - torch.randn(
                (H // 2, 2, S), generator=gen, device="cuda")
        args = (q, k, v, do, lse, dd, causal, sc)
        fused = fl.flash_bwd_fused_packed(*args)
        two = (fl.flash_bwd_q_packed(*args), *fl.flash_bwd_kv_packed(*args))
        plain = fl.plain_flash_bwd_fused_packed(*args)
        general = fl.flash_bwd_fused(*heads, glse, dd.reshape(H, S), causal,
                                     sc)
        saved = fl._DQ_SLAB_BUDGET
        fl._DQ_SLAB_BUDGET = H * S * 64 * 4 * 3      # 3 k tiles a launch
        try:
            split = fl.flash_bwd_fused_packed(*args)
        finally:
            fl._DQ_SLAB_BUDGET = saved
        for n, name in enumerate(("dq", "dk", "dv")):
            _near(f"packed bwd {name} {case}", fused[n], plain[n], 1e-5)
            assert torch.equal(fused[n], two[n]), (name, case)
            assert torch.equal(fused[n], split[n]), (name, case)
            assert torch.equal(fl._unpack_heads(fused[n]), general[n]), \
                (name, case)
    q, k, v, do = (_make((4, 512, 64), torch.float32, gen) for _ in range(4))
    for mode in ("fused", "two_pass"):
        res = []
        for fn in (fl.flash_attention_packed, fl.flash_attention):
            ts = [t.detach().requires_grad_() for t in (q, k, v)]
            before = [w.launches for w in (fl.flash_fwd_packed,
                                           fl.flash_fwd)]
            o = fn(*ts, causal=True, bwd_mode=mode)
            (o * do).sum().backward()
            after = [w.launches for w in (fl.flash_fwd_packed, fl.flash_fwd)]
            packed = fn is fl.flash_attention_packed
            assert [a - b for a, b in zip(after, before)] == \
                ([1, 0] if packed else [0, 1]), (mode, packed)
            res.append([o.detach(), *(t.grad for t in ts)])
        for a, b in zip(*res):
            assert torch.equal(a, b), mode
    torch.cuda.synchronize()


def _context_on_card(gen):
    """Ring, zigzag and Ulysses on the card against the CPU, use_flash off
    and on, forward and the gradient of a sum of squares."""
    import accl_tpu_torch as at
    from accl_tpu_torch.parallel import context as ctx
    W = 4
    builds = [
        ("ring", (W, 256, 64), lambda c, f: ctx.build_ring_attention(
            c, causal=True, use_flash=f)),
        ("zigzag", (W, 256, 96), lambda c, f:
         ctx.build_zigzag_ring_attention(c, use_flash=f)),
        ("ulysses", (W, 64, 8, 64), lambda c, f: ctx.build_ulysses_attention(
            c, 8, causal=True, use_flash=f)),
    ]
    for name, shape, build in builds:
        xs = [torch.randn(shape, generator=gen, device="cuda")
              for _ in range(3)]
        for flash in (False, True):
            res = {}
            for dev in ("cuda", "cpu"):
                ts = [x.to(dev).detach().requires_grad_() for x in xs]
                out = build(at.Communicator(W, dev), flash)(*ts)
                (out ** 2).sum().backward()
                res[dev] = [t.detach().cpu() for t in
                            (out, *(x.grad for x in ts))]
            for what, a, b in zip(("out", "dq", "dk", "dv"), res["cuda"],
                                  res["cpu"]):
                _near(f"{name} use_flash={flash} {what}", a, b, 1e-5)


def _decode_kernels(gen):
    """flash_decode_kernel and flash_decode_span_kernel against their plain
    version: d 128, g 1, 6 and 8, pages 8, 32, 64 and 96 (two steps a
    page), f32, bf16 and int8 pools (int8 with per-page scales too), q f32
    and bf16, lengths 0, one page and full capacity, spans 1, 16 and 64;
    within 1e-5 of the largest magnitude (f32 sums in another order), and
    a slot of length 0 gives zeros. Then the entry points launch them."""
    from accl_tpu_torch.ops import flash as fl
    cases = [(3, 2, 2, 8, 2, torch.float32, torch.float32, 1, False),
             (3, 6, 1, 8, 2, torch.bfloat16, torch.float32, 1, False),
             (3, 16, 2, 32, 2, torch.int8, torch.float32, 1, False),
             (3, 8, 1, 32, 2, torch.int8, torch.float32, 1, True),
             (3, 8, 1, 96, 2, torch.float32, torch.bfloat16, 1, False),
             (1, 6, 1, 8, 4, torch.bfloat16, torch.float32, 16, False),
             (1, 16, 2, 64, 3, torch.float32, torch.float32, 64, False),
             (1, 8, 1, 32, 4, torch.int8, torch.float32, 64, True)]
    for B, H, hkv, page, pmax, kvd, qd, span, per_page in cases:
        case = (B, H, hkv, page, pmax, kvd, qd, span, per_page)
        g, n_pages = H // hkv, B * pmax
        gp = -(-g * span // 8) * 8
        q4 = _make((B, hkv, gp, 128), qd, gen)
        kf, vf = (_make((hkv, n_pages, page, 128), torch.float32, gen)
                  for _ in range(2))
        scales = None
        if kvd == torch.int8 and per_page:
            kp, scales = fl.quantize_kv_paged(kf, "int8")
            vp = fl.quantize_kv(vf, torch.int8)
        else:
            kp, vp = fl.quantize_kv(kf, kvd, "off"), fl.quantize_kv(
                vf, kvd, "off")
        bt = torch.randperm(n_pages, generator=gen, device="cuda").to(
            torch.int32).reshape(B, pmax)
        cap = pmax * page
        lens = torch.tensor([0, page, cap] if span == 1 else [cap - 5],
                            dtype=torch.int32, device="cuda")
        if span == 1:
            got = fl.paged_decode(q4, kp, vp, bt, lens, 0.1, scales)
            assert torch.all(got[0] == 0), case
        else:
            got = fl.paged_decode_span(q4, kp, vp, bt, lens, 0.1, span,
                                       scales)
        want = fl.plain_paged_decode(q4, kp, vp, bt, lens, 0.1, span, scales)
        _near(f"decode {case}", got.float(), want.float(),
              1e-5 if qd == torch.float32 else 1e-2)
    launched = (fl.paged_decode.launches, fl.paged_decode_span.launches)
    q = _make((3, 8, 128), torch.float32, gen)
    kp = _make((2, 6, 32, 128), torch.float32, gen)
    bt = torch.arange(6, dtype=torch.int32, device="cuda").reshape(3, 2)
    lens = torch.tensor([0, 5, 64], dtype=torch.int32, device="cuda")
    out = fl.flash_decode(q, kp, kp, bt, lens)
    _near("flash_decode", out, fl._decode_reference(q, kp, kp, bt, lens,
                                                    128 ** -0.5), 1e-5)
    qc = _make((32, 8, 128), torch.float32, gen)
    kc = _make((32, 2, 128), torch.float32, gen)
    fl.flash_prefill(qc, kc, kc, kp.clone(), kp.clone(), bt, lens, 1,
                     live=20)
    assert (fl.paged_decode.launches - launched[0],
            fl.paged_decode_span.launches - launched[1]) == (1, 1)
    torch.cuda.synchronize()


def _serving_on_card(gen):
    """The TP decode and prefill steps on the card against the CPU, fused
    and baseline: two prefill chunks and two decode steps at tp 2."""
    import accl_tpu_torch as at
    from accl_tpu_torch.models import decode as dm
    tp, d_model, H, hkv, page = 2, 256, 4, 2, 8
    params = dm.init_decode_params(gen, d_model, H, hkv, 128, tp)
    xs = [torch.randn(s, generator=gen, device="cuda")
          for s in ((16, d_model), (16, d_model), (4, d_model),
                    (4, d_model))]
    for overlap in (True, False):
        res = {}
        for dev in ("cuda", "cpu"):
            comm = at.Communicator(tp, dev)
            p = dm.DecodeParams(*(w.to(dev) for w in params))
            st = dm.admit(dm.admit(dm.init_decode_state(
                4, 4, page, hkv, 128, device=dev), 0), 3)
            pre = dm.build_prefill_step(comm, overlap=overlap)
            dec = dm.build_decode_step(comm, overlap=overlap)
            ys = []
            for x, live in zip(xs[:2], (16, 9)):
                y, st = pre(p, st, x.to(dev), 0, live=live)
                ys.append(y[:live])
            for x in xs[2:]:
                y, st = dec(p, st, x.to(dev))
                ys.append(y)
            res[dev] = [t.cpu() for t in (*ys, st.k_pages, st.seq_lens)]
        for n, (a, b) in enumerate(zip(res["cuda"], res["cpu"])):
            _near(f"serving overlap={overlap} output {n}", a.float(),
                  b.float(), 1e-5)


def _pp_relay_kernel(gen):
    """pp_relay_kernel against its plain version by bits: P 2, 3 and 8, one
    and two lanes, one element, one segment and a ragged three-segment
    payload (lanes not 16-byte aligned), f32 with NaN and +-0, bf16, int32,
    and int8 (the byte path)."""
    from accl_tpu_torch.ops import pipeline_relay as pr
    for P in (2, 3, 8):
        for L in (1, 2):
            for n, d in ((1, 1), (16, 64), (5, 130001)):
                for dt in (torch.float32, torch.bfloat16, torch.int32,
                           torch.int8):
                    shape = (P, n, d) if L == 1 else (P, L, n, d)
                    f = _make(shape, dt, gen)
                    b = _make(shape, dt, gen)
                    if dt == torch.float32:
                        f.view(-1)[0] = float("nan")
                        b.view(-1)[0] = -0.0
                    plan = pr.pp_plan(n, d, dt, P)
                    launches = pr.relay.launches
                    got = pr.relay(f, b, plan)
                    want = pr.plain_relay(f, b, plan["C"], plan["seg_elems"])
                    torch.cuda.synchronize()
                    assert pr.relay.launches == launches + 1
                    for g, w in zip(got, want):
                        assert _same_bits(g, w), (P, L, n, d, dt)


def _pipeline_on_card(gen):
    """The 1F1B and GPipe train steps on the card against the CPU: the
    simple stage family at world 4, and the composed step at (2, 2, 1)
    fused and flat and (4, 1, 1) with 128 rows (the flash arm)."""
    import accl_tpu_torch as at
    from accl_tpu_torch.models import pipeline as pp
    from accl_tpu_torch.ops import pipeline_relay as pr
    world, M, n, d = 4, 4, 3, 16
    params = pp.init_stage_params(gen, at.Communicator(world, "cuda"), d)
    x = torch.randn((world, M, n, d), generator=gen, device="cuda")
    for sched in ("1f1b", "gpipe"):
        res = {}
        for dev in ("cuda", "cpu"):
            step = pp.build_pp_train_step(at.Communicator(world, dev), M, d,
                                          schedule=sched)
            launches = pr.relay.launches
            new, loss = step(pp.PPStageParams(*(t.to(dev) for t in params)),
                             x.to(dev), x.to(dev).flip(0))
            res[dev] = [t.cpu() for t in (*new, loss)]
            if dev == "cuda" and sched == "1f1b":
                assert pr.relay.launches - launches == step.table.steps
        for a, b in zip(res["cuda"], res["cpu"]):
            _near(f"simple {sched}", a, b, 1e-5)
    for shape, rows, overlap in (((2, 2, 1), 8, True), ((2, 2, 1), 8, False),
                                 ((4, 1, 1), 128, None)):
        D, H, heads = 64, 128, 2
        mesh = pp.make_pp_mesh("cuda", *shape)
        params = pp.init_pp_transformer(gen, mesh, D, H, heads)
        B = shape[1] * rows
        x = torch.randn((4, B, D), generator=gen, device="cuda") * 0.3
        res = {}
        for dev in ("cuda", "cpu"):
            m = pp.make_pp_mesh(dev, *shape)
            step = pp.build_pp_transformer_train_step(
                m, D, H, heads, 4, schedule="1f1b", overlap=overlap,
                wire_dtype="off")
            new, loss = step(pp.PPTransformerParams(
                *(t.to(dev) for t in params)), x.to(dev), x.to(dev) * 0.5)
            res[dev] = [t.cpu() for t in (*new, loss)]
        for a, b in zip(res["cuda"], res["cpu"]):
            _near(f"composed {shape} overlap={overlap}", a, b, 1e-5)
