"""Slices 5 and 6 of the port against the JAX package: the tensor-parallel
collective matmuls (``accl_tpu_torch.ops.collective_matmul``: plans, engage
policy, the all-gather x matmul, matmul x reduce-scatter and gathered-wgrad
bodies over the ``agmm``, ``mmrs`` and ``wgrad`` kernels' plain versions,
and the autograd Functions around them) and the TP MLP forward and train
step (``accl_tpu_torch.models.mlp``), on the same numpy inputs.

The JAX side runs its unfused XLA pair, and seven times its Pallas kernels
in TPU interpret mode (W = 4, small shapes; each oracle once through a
module-scoped cache), plus its fused MLP train step at (dp, tp) (1, 2) and
(2, 4). Tolerances: integer-valued operands are bit-equal (every product
and partial sum exact in f32, and the bf16 wire's roundings deterministic);
random f32 within the f32 summation bound, 2 K 2^-24 sum|a b| for K
products per output (the same products summed in another order: at W 8,
1024 products per mmrs output, elements near zero differ by up to 3.8e-6,
past an atol of 1e-6), or rtol 1e-5 where the wgrad's few products make
that the looser bound; the MLP forward and train step within rtol 1e-5 /
atol 1e-6, with the same engage decisions in both packages. Cases loop
inside the two test functions and every assert names its case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.communicator import Communicator as JComm
from accl_tpu.compat import shard_map
from accl_tpu.config import Algorithm as JAlgo
from accl_tpu.models import mlp as jmlp
from accl_tpu.obs import metrics as jmetrics
from accl_tpu.ops import collective_matmul as jcm
from accl_tpu.parallel import algorithms as jalg
from conftest import requires_interpret_rdma

import accl_tpu_torch as at
from accl_tpu_torch import device_api as tdapi
from accl_tpu_torch.models import mlp as tmlp
from accl_tpu_torch.obs import metrics as tmetrics
from accl_tpu_torch.ops import collective_matmul as tcm
from accl_tpu_torch.parallel import algorithms as talg

pytestmark = requires_interpret_rdma
torch.set_num_threads(1)

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16),
       "f16": (jnp.float16, torch.float16)}
#: the budgets the mode search tries (the JAX package's 12 MiB first)
_BUDGETS = (12 << 20, 200 << 10, 150 << 10, 128 << 10, 112 << 10,
            100 << 10, 96 << 10, 64 << 10, 48 << 10, 32 << 10)


def _ints(seed: int, shape, lo=-4, hi=5) -> np.ndarray:
    """Integer-valued f32: exact under any summation order."""
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


def _data(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _budget(monkeypatch, nbytes: int) -> None:
    monkeypatch.setattr(jcm, "_VMEM_BUDGET", nbytes)
    monkeypatch.setattr(tcm, "_VMEM_BUDGET", nbytes)


def _jrun(W, builder, algo, bidir, wire, a, b):
    comm = JComm(jax.devices()[:W])
    prog = builder(comm, algo, bidirectional=bidir, wire_dtype=wire)
    put = (lambda v: jax.device_put(v, comm.sharding()))
    return np.asarray(prog(put(a), put(b)))


def _trun(W, builder, algo, bidir, wire, a, b):
    prog = builder(at.Communicator(W, "cpu"), algo, bidirectional=bidir,
                   wire_dtype=wire)
    return prog(torch.from_numpy(a), torch.from_numpy(b)).numpy()


@pytest.fixture(scope="module")
def oracle():
    """Runs each JAX Pallas oracle once; later cases reuse it."""
    cache = {}

    def run(name, fn):
        if name not in cache:
            cache[name] = fn()
        return cache[name]

    return run


def _plan_modes(op, m, k, n, P, bidir):
    """{mode: budget} of the JAX plan for the shape under each budget of
    :data:`_BUDGETS`: "resident", "stream" (k-blocked) and "nblock" (the
    accumulator-blocking arm), the first budget that gives each."""
    plan = jcm.agmm_plan if op == "agmm" else jcm.mmrs_plan
    modes = {}
    saved = jcm._VMEM_BUDGET
    try:
        for b in _BUDGETS:
            jcm._VMEM_BUDGET = b
            p = plan(m, k, n, P, jnp.float32, bidir)
            if p is None:
                continue
            mode = p["mode"] if ("mb" not in p and "nb" not in p) \
                else "nblock"
            modes.setdefault(mode, b)
    finally:
        jcm._VMEM_BUDGET = saved
    return modes


def test_cmatmul_match_jax(monkeypatch, oracle):
    """Plans, engage reasons and fallback labels equal the JAX package's
    (the forward's and the gathered wgrad's); the bodies hold against its
    XLA pair at worlds 2, 4 and 8 in every plan mode and channel setting,
    and against its Pallas kernels in interpret mode, the wgrad's too; bad
    shapes raise the same ValueError; the device API entry points and their
    gradients against ``jax.grad`` through the JAX ``custom_vjp``s."""
    _plans_match(monkeypatch)
    _engage_and_fallbacks_match(monkeypatch)
    _wgrad_policy_matches(monkeypatch)
    _bodies_match_xla(monkeypatch)
    _bodies_match_pallas(monkeypatch, oracle)
    _wgrad_bodies_match_pallas(monkeypatch, oracle)
    _bad_shapes_raise()
    _entry_points()


def _plans_match(monkeypatch):
    shapes = [(256, 3072, 1536), (2048, 1536, 3072), (256, 512, 512),
              (2048, 512, 512), (16, 128, 128), (12, 72, 40), (48, 256, 128),
              (8, 128, 32768), (256, 256, 128), (64, 256, 512), (1, 1, 1)]
    for budget in (12 << 20, 150 << 10, 100 << 10):
        _budget(monkeypatch, budget)
        for nblock in (True, False):
            monkeypatch.setattr(jcm, "_NBLOCK_DEFAULT", nblock)
            monkeypatch.setattr(tcm, "_NBLOCK_DEFAULT", nblock)
            for m, k, n in shapes:
                for P in (1, 2, 3, 4, 8):
                    for dt in ("f32", "bf16"):
                        for bidir in (False, True):
                            for wire in (None, "bf16", "f16"):
                                for wdt in (None, "bf16"):
                                    case = (budget, nblock, m, k, n, P, dt,
                                            bidir, wire, wdt)
                                    jw = _DT[wire][0] if wire else None
                                    tw = _DT[wire][1] if wire else None
                                    jwd = _DT[wdt][0] if wdt else None
                                    twd = _DT[wdt][1] if wdt else None
                                    for name in ("agmm_plan", "mmrs_plan"):
                                        want = getattr(jcm, name)(
                                            m, k, n, P, _DT[dt][0], bidir,
                                            w_dtype=jwd, wire_dtype=jw)
                                        got = getattr(tcm, name)(
                                            m, k, n, P, _DT[dt][1], bidir,
                                            w_dtype=twd, wire_dtype=tw)
                                        assert got == want, (name, case)
    _budget(monkeypatch, 12 << 20)
    monkeypatch.setattr(jcm, "_NBLOCK_DEFAULT", True)
    monkeypatch.setattr(tcm, "_NBLOCK_DEFAULT", True)
    # Megatron-LM 8.3B's block at tp 8 and 2048 tokens: the stream plans
    # the card's phase 3f runs (one agmm launch, two mmrs launches)
    ag = tcm.agmm_plan(256, 3072, 1536, 8, torch.float32, True)
    rs = tcm.mmrs_plan(2048, 1536, 3072, 8, torch.float32, True)
    assert (ag["mode"], ag["kb"], ag["nkb"], ag.get("nmb", 1)) == \
        ("stream", 768, 4, 1), ag
    assert (rs["mode"], rs["kb"], rs["nkb"], rs["nb"], rs["nnb"]) == \
        ("stream", 384, 4, 1536, 2), rs
    # the lane shape (m 256, k 512, n 512): both resident
    assert tcm.agmm_plan(256, 512, 512, 8, torch.float32, True)["mode"] == \
        "resident"
    assert tcm.mmrs_plan(2048, 512, 512, 8, torch.float32,
                         True)["mode"] == "resident"
    for k, n in ((64, 128), (128, 64), (64, 96), (1, 1)):
        assert tcm.aspect_class(k, n) == jcm.aspect_class(k, n), (k, n)
    for dt in ("f32", "bf16", "f16"):
        for wire in (None, "off", "bf16", "f16", "bf16_sr"):
            assert tcm.wire_itemsize(_DT[dt][1], wire) == \
                jcm.wire_itemsize(_DT[dt][0], wire), (dt, wire)


def _set_registers(monkeypatch, overlap, ag, rs, ag_cls, rs_cls):
    for mod in (jcm, tcm):
        monkeypatch.setattr(mod, "_OVERLAP_DEFAULT", overlap)
        monkeypatch.setattr(mod, "_AG_THRESHOLD", ag)
        monkeypatch.setattr(mod, "_RS_THRESHOLD", rs)
        monkeypatch.setattr(mod, "_AG_CLASS_THRESHOLDS", ag_cls)
        monkeypatch.setattr(mod, "_RS_CLASS_THRESHOLDS", rs_cls)


def _fallbacks(metrics_mod, before) -> dict:
    d = metrics_mod.delta(before)["counters"]
    return {k: v for k, v in d.items()
            if k.startswith("accl_cmatmul_fallback_total")}


def _engage_and_fallbacks_match(monkeypatch):
    """The engage reasons over a sweep of registers, overlap modes, wires
    and shapes; then the fallback counter labels each body records
    (threshold, vmem_miss, and none for a requested or session-wide
    off)."""
    shapes = [(16, 64, 64), (16, 64, 256), (64, 256, 64), (8, 128, 32768),
              (10, 64, 64), (256, 3072, 1536), (2048, 1536, 3072)]
    registers = [(True, 0, 0, {}, {}), (False, 0, 0, {}, {}),
                 (True, 1 << 62, 1 << 62, {}, {}),
                 (True, 4096, 8192, {"wide": 1 << 62}, {"tall": 0})]
    for reg in registers:
        _set_registers(monkeypatch, *reg)
        for m, k, n in shapes:
            for P in (2, 4, 8):
                for overlap in (None, True, False):
                    for wire in (None, "bf16", "off"):
                        for dt in ("f32", "bf16"):
                            case = (reg[:3], m, k, n, P, overlap, wire, dt)
                            for name in ("agmm_engage_reason",
                                         "mmrs_engage_reason"):
                                want = getattr(jcm, name)(
                                    m, k, n, P, _DT[dt][0], overlap,
                                    wire_dtype=wire)
                                got = getattr(tcm, name)(
                                    m, k, n, P, _DT[dt][1], overlap,
                                    wire_dtype=wire)
                                assert got == want, (name, case)
    _set_registers(monkeypatch, True, 0, 0, {}, {})
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:4]), ("accl",))

    def jax_trace(body_name, overlap, m, k, n):
        def body(xs, ws):
            return getattr(jcm, body_name)(xs, ws, axis="accl",
                                           overlap=overlap)
        jax.make_jaxpr(shard_map(
            body, mesh=mesh, in_specs=(P("accl"), P(None)),
            out_specs=P("accl"), check_vma=False))(
            jnp.zeros((4 * m, k), jnp.float32),
            jnp.zeros((k, n), jnp.float32))

    def port_run(body_name, overlap, m, k, n):
        getattr(tcm, body_name)(torch.zeros((4, m, k)),
                                torch.zeros((4, k, n)), overlap=overlap)

    for setup, overlap, (m, k, n) in (
            ((True, 1 << 62, 1 << 62, {}, {}), None, (16, 64, 64)),
            ((True, 0, 0, {}, {}), True, (8, 128, 32768)),
            ((True, 0, 0, {}, {}), True, (64, 32768, 128)),
            ((True, 0, 0, {}, {}), False, (16, 64, 64)),
            ((False, 0, 0, {}, {}), None, (16, 64, 64))):
        _set_registers(monkeypatch, *setup)
        for body_name in ("all_gather_matmul_body",
                          "matmul_reduce_scatter_body"):
            case = (setup[:3], overlap, m, k, n, body_name)
            jb, tb = jmetrics.snapshot(), tmetrics.snapshot()
            jax_trace(body_name, overlap, m, k, n)
            port_run(body_name, overlap, m, k, n)
            assert _fallbacks(tmetrics, tb) == _fallbacks(jmetrics, jb), case
    _set_registers(monkeypatch, True, 0, 0, {}, {})


def _bodies_match_xla(monkeypatch):
    """Worlds 2, 4 and 8, bidirectional off and on (P >= 4), the aligned
    and the uneven shape, every plan mode the mode search finds (resident,
    k-blocked stream, accumulator blocks; the blocks need shapes whose rows
    or columns split): integer operands bit-equal to the JAX XLA pair, a
    bf16 wire on agmm bit-equal to the pair on pre-rounded shards, random
    f32 within the f32 summation bound."""
    T, J = at.Algorithm.PALLAS, JAlgo.XLA
    seen = set()
    for W in (2, 4, 8):
        for m, k, n in ((16, 128, 128), (12, 72, 40), (256, 256, 128),
                        (16, 256, 512)):
            ag_x, ag_w = _ints(W + m, (W, m, k)), _ints(W + k, (W, k, n))
            rs_x = _ints(W + n, (W, W * m, k))
            ag_ref = _jrun(W, jalg.build_allgather_matmul, J, False, None,
                           ag_x, ag_w)
            rs_ref = _jrun(W, jalg.build_matmul_reduce_scatter, J, False,
                           None, rs_x, ag_w)
            for bidir in ((False, True) if W >= 4 else (False,)):
                for op, x, ref, builder, rows in (
                        ("agmm", ag_x, ag_ref, talg.build_allgather_matmul,
                         m),
                        ("mmrs", rs_x, rs_ref,
                         talg.build_matmul_reduce_scatter, W * m)):
                    for mode, b in _plan_modes(op, rows, k, n, W,
                                               bidir).items():
                        _budget(monkeypatch, b)
                        case = (op, W, (m, k, n), bidir, mode)
                        got = _trun(W, builder, T, bidir, None, x, ag_w)
                        assert np.array_equal(got, ref), case
                        seen.add((op, mode))
            _budget(monkeypatch, 12 << 20)
            if (m, k, n) != (16, 128, 128):
                continue
            # a bf16 wire rounds agmm's shards once: the pair on the
            # rounded shards, bit for bit (integers past bf16's 8 bits)
            xb = _ints(W, (W, m, k), -600, 600)
            rounded = torch.from_numpy(xb).bfloat16().float().numpy()
            want = _jrun(W, jalg.build_allgather_matmul, J, False, None,
                         rounded, ag_w)
            got = _trun(W, talg.build_allgather_matmul, T, W >= 4, "bf16",
                        xb, ag_w)
            assert np.array_equal(got, want), ("agmm bf16 wire", W)
            # random f32: the same products summed in another order, so
            # each side is within K 2^-24 sum|a b| of the exact sum
            xr, wr = _data(W, (W, m, k)), _data(W + 1, (W, k, n))
            xrs = _data(W + 2, (W, W * m, k))
            for name, jb, tb, a, K, mag in (
                    ("agmm", jalg.build_allgather_matmul,
                     talg.build_allgather_matmul, xr, k,
                     tcm.xla_all_gather_matmul),
                    ("mmrs", jalg.build_matmul_reduce_scatter,
                     talg.build_matmul_reduce_scatter, xrs, W * k,
                     tcm.xla_matmul_reduce_scatter)):
                want = _jrun(W, jb, J, False, None, a, wr)
                got = _trun(W, tb, T, W >= 4, None, a, wr)
                bound = 2 * K * 2.0 ** -24 * mag(
                    torch.from_numpy(np.abs(a)).double(),
                    torch.from_numpy(np.abs(wr)).double()).numpy()
                err = np.abs(got.astype(np.float64) - want)
                assert (err <= bound).all(), (f"random {name}", W,
                                              err.max())
    for op in ("agmm", "mmrs"):
        for mode in ("resident", "stream", "nblock"):
            assert (op, mode) in seen, (op, mode)


def _bodies_match_pallas(monkeypatch, oracle):
    """The four interpret-mode oracles at W 4, bidirectional: resident agmm
    (integers), resident mmrs with a bf16 wire on the uneven shape (mc 12:
    rows 8-11 are channel 1 of the padded chunk of 16, so the halves fold
    in opposite orders and round on the wire), streaming agmm with a bf16
    wire (shards past bf16's 8 bits) and streaming mmrs with a bf16 wire,
    each with k in two 128-lane blocks; all bit-equal."""
    W = 4
    cases = (
        ("resident agmm", 12 << 20, "agmm", (16, 128, 128), None, (-4, 5)),
        ("resident mmrs", 12 << 20, "mmrs", (12, 72, 40), "bf16", (-9, 10)),
        ("stream agmm", 150 << 10, "agmm", (16, 256, 128), "bf16",
         (-600, 600)),
        ("stream mmrs", 150 << 10, "mmrs", (12, 256, 128), "bf16", (-9, 10)))
    for name, budget, op, (m, k, n), wire, (lo, hi) in cases:
        _budget(monkeypatch, budget)
        jb, tb = ((jalg.build_allgather_matmul, talg.build_allgather_matmul)
                  if op == "agmm" else
                  (jalg.build_matmul_reduce_scatter,
                   talg.build_matmul_reduce_scatter))
        rows = m if op == "agmm" else W * m
        x, w = _ints(k + m, (W, rows, k), lo, hi), _ints(k, (W, k, n))
        wdt = jnp.bfloat16 if wire else None
        plan = (jcm.agmm_plan(m, k, n, W, jnp.float32, True, wire_dtype=wdt)
                if op == "agmm" else
                jcm.mmrs_plan(rows, k, n, W, jnp.float32, True,
                              wire_dtype=wdt))
        assert plan["mode"] == name.split()[0], (name, plan)
        want = oracle(name, lambda: _jrun(W, jb, JAlgo.PALLAS, True, wire,
                                          x, w))
        got = _trun(W, tb, at.Algorithm.PALLAS, True, wire, x, w)
        assert np.array_equal(got, want), name
    _budget(monkeypatch, 12 << 20)


def _wgrad_policy_matches(monkeypatch):
    """``wgrad_plan`` over budgets, nblock, shapes, worlds, dtypes and
    channel settings; ``wgrad_engage_reason`` over the register settings,
    overlap modes, wires and both orientations; the Megatron-LM 8.3B pin
    (the stream arm, ctb 768 in 4 launches); then the ``{op}_dw`` fallback
    labels the port's body counts against the JAX body's."""
    shapes = [(256, 3072, 1536), (12, 72, 40), (16, 256, 64), (2048, 512, 512),
              (8, 128, 32768), (1, 1, 1)]
    for budget in (12 << 20, 150 << 10):
        _budget(monkeypatch, budget)
        for nblock in (True, False):
            monkeypatch.setattr(jcm, "_NBLOCK_DEFAULT", nblock)
            monkeypatch.setattr(tcm, "_NBLOCK_DEFAULT", nblock)
            for ms, ct, cl in shapes:
                for P in (1, 2, 4, 8):
                    for tdt, ldt in (("f32", "f32"), ("bf16", "f32"),
                                     ("bf16", "bf16")):
                        for bidir in (False, True):
                            case = (budget, nblock, ms, ct, cl, P, tdt, ldt,
                                    bidir)
                            assert tcm.wgrad_plan(
                                ms, ct, cl, P, _DT[tdt][1], _DT[ldt][1],
                                bidir) == jcm.wgrad_plan(
                                ms, ct, cl, P, _DT[tdt][0], _DT[ldt][0],
                                bidir), case
    _budget(monkeypatch, 12 << 20)
    monkeypatch.setattr(jcm, "_NBLOCK_DEFAULT", True)
    monkeypatch.setattr(tcm, "_NBLOCK_DEFAULT", True)
    plan = tcm.wgrad_plan(256, 3072, 1536, 8, torch.float32, torch.float32,
                          True)
    assert (plan["ctb"], plan["nctb"], plan["nchan"]) == (768, 4, 2), plan
    for reg in ((True, 0, 0, {}, {}), (False, 0, 0, {}, {}),
                (True, 1 << 62, 1 << 62, {}, {}),
                (True, 4096, 8192, {"wide": 1 << 62}, {"tall": 0})):
        _set_registers(monkeypatch, *reg)
        for ms, ct, cl in shapes[:4]:
            for P in (1, 2, 4, 8):
                for overlap in (None, True, False):
                    for wire in (None, "bf16", "off"):
                        for lhs in (True, False):
                            case = (reg[:3], ms, ct, cl, P, overlap, wire,
                                    lhs)
                            assert tcm.wgrad_engage_reason(
                                ms, ct, cl, P, torch.float32, overlap,
                                wire_dtype=wire, travel_lhs=lhs) == \
                                jcm.wgrad_engage_reason(
                                    ms, ct, cl, P, jnp.float32, overlap,
                                    wire_dtype=wire, travel_lhs=lhs), case
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:4]), ("accl",))

    def jax_trace(overlap, lhs, ms, ct, cl, op):
        def body(ts, ls):
            return jcm.gathered_wgrad_body(ts, ls, axis="accl",
                                           overlap=overlap, travel_lhs=lhs,
                                           op=op)
        jax.make_jaxpr(shard_map(
            body, mesh=mesh, in_specs=(P("accl"), P("accl")),
            out_specs=P("accl"), check_vma=False))(
            jnp.zeros((4 * ms, ct), jnp.float32),
            jnp.zeros((16 * ms, cl), jnp.float32))

    for setup, overlap, (ms, ct, cl), budget in (
            ((True, 1 << 62, 1 << 62, {}, {}), None, (16, 64, 64), 12 << 20),
            ((True, 0, 0, {}, {}), True, (16, 256, 64), 20 << 10),
            ((True, 0, 0, {}, {}), False, (16, 64, 64), 12 << 20),
            ((False, 0, 0, {}, {}), None, (16, 64, 64), 12 << 20)):
        _set_registers(monkeypatch, *setup)
        _budget(monkeypatch, budget)
        for lhs, op in ((True, "allgather_matmul"),
                        (False, "matmul_reduce_scatter")):
            case = (setup[:3], overlap, ms, ct, cl, op)
            jb, tb = jmetrics.snapshot(), tmetrics.snapshot()
            jax_trace(overlap, lhs, ms, ct, cl, op)
            tcm.gathered_wgrad_body(torch.zeros((4, ms, ct)),
                                    torch.zeros((4, 4 * ms, cl)),
                                    overlap=overlap, travel_lhs=lhs, op=op)
            got = _fallbacks(tmetrics, tb)
            assert got == _fallbacks(jmetrics, jb), case
            assert all("_dw" in k for k in got), case
    _set_registers(monkeypatch, True, 0, 0, {}, {})
    _budget(monkeypatch, 12 << 20)


def _jax_wgrad(W, pairs, lhs, wire):
    """The JAX body (bidirectional, overlap on) on each (trav, loc) pair, in
    one program."""
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:W]), ("accl",))

    def body(*ops):
        return tuple(jcm.gathered_wgrad_body(
            ts[0], ls[0], axis="accl", overlap=True, wire_dtype=wire,
            travel_lhs=lhs)[None] for ts, ls in zip(ops[::2], ops[1::2]))
    return [np.asarray(o) for o in jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P("accl"),) * (2 * len(pairs)),
        out_specs=(P("accl"),) * len(pairs), check_vma=False))(
        *(a for pair in pairs for a in pair))]


def _wgrad_bodies_match_pallas(monkeypatch, oracle):
    """``gathered_wgrad_body`` against the JAX body running
    ``_wgrad_kernel`` in interpret mode at W 4, bidirectional: the resident
    plan on the ragged shard (ms 12: rows 8-11 are channel 1 of the padded
    16, so the sum runs in the ring's two orders), integer operands
    bit-equal and random f32 within rtol 1e-5 / atol 1e-5 (48 products per
    output); the mirror with a bf16 wire (shards past bf16's 8 bits,
    rounded once) on the streaming arm (a pinched budget: ct 256 in two
    128-column blocks, two launches), bit-equal."""
    W = 4
    for name, budget, (ms, ct, cl), lhs, wire, (lo, hi) in (
            ("wgrad resident", 12 << 20, (12, 72, 40), True, None, (-4, 5)),
            ("wgrad stream bf16 mirror", 150 << 10, (12, 256, 40), False,
             "bf16", (-600, 600))):
        _budget(monkeypatch, budget)
        pairs = [(_ints(ct + ms, (W, ms, ct), lo, hi),
                  _ints(cl + ms, (W, W * ms, cl)))]
        if lhs:
            pairs.append((_data(21, (W, ms, ct)), _data(22, (W, W * ms, cl))))
        plan = jcm.wgrad_plan(ms, ct, cl, W,
                              jnp.bfloat16 if wire else jnp.float32,
                              jnp.float32, True)
        assert plan["nchan"] == 2 and plan.get("nctb", 1) == \
            (2 if "stream" in name else 1), (name, plan)
        want = oracle(name, lambda: _jax_wgrad(W, pairs, lhs, wire))
        got = [tcm.gathered_wgrad_body(
            torch.from_numpy(t), torch.from_numpy(lc), overlap=True,
            wire_dtype=wire, travel_lhs=lhs).numpy() for t, lc in pairs]
        assert np.array_equal(got[0], want[0]), name
        if lhs:
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5,
                                       err_msg="wgrad random f32")
    _budget(monkeypatch, 12 << 20)


def _bad_shapes_raise():
    """A contraction mismatch (both bodies), rows not divisible by the
    world (mmrs) and a wgrad row mismatch raise the JAX package's
    ValueError."""
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:4]), ("accl",))
    for body_name, (m, k, k2, n), wspec in (
            ("all_gather_matmul_body", (16, 64, 32, 64), None),
            ("matmul_reduce_scatter_body", (16, 64, 32, 64), None),
            ("matmul_reduce_scatter_body", (10, 64, 64, 64), None),
            ("gathered_wgrad_body", (16, 64, 40, 32), "accl")):
        def body(xs, ws):
            return getattr(jcm, body_name)(xs, ws, axis="accl", overlap=True)
        jw = (4 * k2, n) if wspec else (k2, n)
        with pytest.raises(ValueError) as jerr:
            jax.make_jaxpr(shard_map(
                body, mesh=mesh, in_specs=(P("accl"), P(wspec)),
                out_specs=P("accl"), check_vma=False))(
                jnp.zeros((4 * m, k), jnp.float32),
                jnp.zeros(jw, jnp.float32))
        with pytest.raises(ValueError) as terr:
            getattr(tcm, body_name)(torch.zeros((4, m, k)),
                                    torch.zeros((4, k2, n)), overlap=True)
        assert str(terr.value) == str(jerr.value), (body_name, m, k, k2)


def _entry_points():
    """``device_api`` calls route through the bodies; ``fsdp_matmul``
    against the JAX ``build_fsdp_matmul``'s XLA family; then the gradients
    of the two entry points (dx and dw, integer operands and cotangents:
    bit-equal)
    with overlap True and False against ``jax.grad`` through the JAX
    ``custom_vjp``s (their unfused duals), and a bf16 wire passed through
    to the backward's bodies."""
    W, m, k, n = 4, 8, 64, 96
    x, w = _ints(1, (W, m, k)), _ints(2, (W, k, n))
    xr = _ints(3, (W, W * m, k))
    tx, tw, txr = (torch.from_numpy(a) for a in (x, w, xr))
    J = JAlgo.XLA
    assert np.array_equal(
        tdapi.all_gather_matmul(tx, tw, overlap=True).numpy(),
        _jrun(W, jalg.build_allgather_matmul, J, True, None, x, w))
    assert np.array_equal(
        tdapi.matmul_reduce_scatter(txr, tw, overlap=True).numpy(),
        _jrun(W, jalg.build_matmul_reduce_scatter, J, True, None, xr, w))
    wt = _ints(4, (W, n // W, k))
    want = _jrun(W, jalg.build_fsdp_matmul, J, True, None, x, wt)
    for algo in (at.Algorithm.PALLAS, at.Algorithm.XLA):
        got = _trun(W, talg.build_fsdp_matmul, algo, True, None, x, wt)
        assert np.array_equal(got, want), ("fsdp", algo)
    assert np.array_equal(
        tdapi.fsdp_matmul(tx, torch.from_numpy(wt), overlap=True).numpy(),
        want)
    cot_ag, cot_rs = _ints(5, (W, W * m, n)), _ints(6, (W, m, n))
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:W]), ("accl",))

    def body(xs, xrs, ws, ca, cr):
        def loss(x_, xr_, w_):
            y = jcm.all_gather_matmul(x_, w_, "accl", None, False)
            z = jcm.matmul_reduce_scatter(xr_, w_, "accl", None, False)
            return jnp.sum(y * ca[0]) + jnp.sum(z * cr[0])
        return tuple(g[None] for g in jax.grad(loss, argnums=(0, 1, 2))(
            xs[0], xrs[0], ws[0]))

    spec = P("accl")
    want = [np.asarray(g) for g in jax.jit(shard_map(
        body, mesh=mesh, in_specs=(spec,) * 5, out_specs=(spec,) * 3,
        check_vma=False))(x, xr, w, cot_ag, cot_rs)]
    for overlap in (True, False):
        a, b, c = (torch.from_numpy(t).requires_grad_() for t in (x, xr, w))
        loss = (tdapi.all_gather_matmul(a, c, overlap=overlap)
                * torch.from_numpy(cot_ag)).sum() \
            + (tdapi.matmul_reduce_scatter(b, c, overlap=overlap)
               * torch.from_numpy(cot_rs)).sum()
        loss.backward()
        for name, got, exp in (("dx agmm", a.grad, want[0]),
                               ("dx mmrs", b.grad, want[1]),
                               ("dw", c.grad, want[2])):
            assert np.array_equal(got.numpy(), exp), (name, overlap)
    # the wire reaches the backward: dw of the all-gather x matmul is the
    # gathered wgrad of x rounded to bf16 (integers past bf16's 8 bits)
    xb = _ints(7, (W, m, k), -600, 600)
    a, c = torch.from_numpy(xb).requires_grad_(), tw.clone().requires_grad_()
    tcm.all_gather_matmul(a, c, True, True, "bf16").backward(
        torch.from_numpy(cot_ag))
    for got, exp in ((c.grad, tcm.gathered_wgrad_body(
            torch.from_numpy(xb), torch.from_numpy(cot_ag), overlap=True,
            wire_dtype="bf16")),
                     (a.grad, tcm.matmul_reduce_scatter_body(
            torch.from_numpy(cot_ag), tw.transpose(1, 2), overlap=True,
            wire_dtype="bf16"))):
        assert torch.equal(got, exp), "bf16 wire in the backward"
    assert not torch.equal(c.grad, tcm.gathered_wgrad_body(
        torch.from_numpy(xb), torch.from_numpy(cot_ag), overlap=True,
        wire_dtype="off")), "the bf16 wire rounds dw's traveller"


def test_mlp_forward_matches_jax():
    """``params_from_jax`` then ``make_forward`` with overlap True and False
    against the JAX ``make_forward`` at d 64, h 256, 16 rows, (dp, tp) in
    {(1, 2), (2, 4)}: the same engage decision in both packages, outputs
    within rtol 1e-5 / atol 1e-6; ``apply`` against the dense JAX
    ``apply``; then ``make_train_step`` against the JAX train step."""
    d, h, N = 64, 256, 16
    p = jmlp.init_params(jax.random.PRNGKey(0), d, h)
    p = p._replace(b1=jnp.asarray(_data(1, (h,))),
                   b2=jnp.asarray(_data(2, (d,))))
    x = _data(3, (N, d))
    tx = torch.from_numpy(x)
    dense = tmlp.MLPParams(*(torch.from_numpy(np.array(t)) for t in p))
    np.testing.assert_allclose(tmlp.apply(dense, tx).numpy(),
                               np.asarray(jmlp.apply(p, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    for dp, tp in ((1, 2), (2, 4)):
        mesh = jmlp.make_mesh(jax.devices(), dp, tp)
        jp = jmlp.shard_params(p, mesh)
        comm = at.Communicator(dp * tp, "cpu")
        params = tmlp.params_from_jax(p, comm, dp, tp)
        rows = N // dp
        for overlap in (True, False):
            case = (dp, tp, overlap)
            for name, args in (
                    ("agmm_engage_reason", (rows // tp, d, h // tp, tp)),
                    ("mmrs_engage_reason", (rows, h // tp, d, tp))):
                want = getattr(jcm, name)(*args, jnp.float32, overlap)
                got = getattr(tcm, name)(*args, torch.float32, overlap)
                assert got == want == (None if overlap else "off"), \
                    (name, case)
            want = np.asarray(jmlp.make_forward(mesh, overlap=overlap)(
                jp, jnp.asarray(x)))
            got = tmlp.make_forward(comm, dp, tp, overlap=overlap)(
                params, tx).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=str(case))
            _train_step_matches_jax(p, jp, params, mesh, comm, dp, tp, x,
                                    overlap)


def _train_step_matches_jax(p, jp, params, mesh, comm, dp, tp, x, overlap):
    """One SGD step (lr 1e-2, random targets) against the JAX
    ``make_train_step``: both backward wgrads engage alike in both
    packages; the loss and the new parameters within rtol 1e-5 / atol
    1e-6, every dp copy equal. The JAX step scales the gradients of w1, b1
    and w2 by tp (every tp rank's loss is summed into the backward): the
    same new parameters with those updates divided by tp must fail the
    tolerance, so the check sees a missing factor."""
    d, h = p.w1.shape
    rows = x.shape[0] // dp
    case = (dp, tp, overlap)
    for ms, ct, cl, lhs in ((rows // tp, d, h // tp, True),
                            (rows // tp, d, h // tp, False)):
        want = jcm.wgrad_engage_reason(ms, ct, cl, tp, jnp.float32, overlap,
                                       travel_lhs=lhs)
        got = tcm.wgrad_engage_reason(ms, ct, cl, tp, torch.float32, overlap,
                                      travel_lhs=lhs)
        assert got == want == (None if overlap else "off"), ("wgrad", case)
    targets = _data(4, x.shape)
    jnew, jloss = jmlp.make_train_step(mesh, overlap=overlap)(
        jp, jnp.asarray(x), jnp.asarray(targets))
    new, loss = tmlp.make_train_step(comm, dp, tp, overlap=overlap)(
        params, torch.from_numpy(x), torch.from_numpy(targets))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               err_msg=f"loss {case}")
    for name, t in zip(new._fields, new):
        t = t.view(dp, tp, *t.shape[1:])
        assert all(torch.equal(t[i], t[0]) for i in range(dp)), (name, case)
    dense = tmlp.MLPParams(
        w1=new.w1[:tp].permute(1, 0, 2).reshape(d, h),
        b1=new.b1[:tp].reshape(h), w2=new.w2[:tp].reshape(h, d),
        b2=new.b2[0])
    for name, got, want, old in zip(dense._fields, dense, jnew, p):
        got, want, old = got.numpy(), np.asarray(want), np.asarray(old)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} {case}")
        if name != "b2":
            unscaled = old - (old - got) / tp
            assert not np.allclose(unscaled, want, rtol=1e-5, atol=1e-6), \
                (f"{name}: a missing factor tp passes", case)
