"""Selection parity: the port's ``algorithms.select`` resolves the same
algorithm family as the JAX package's for allreduce, reduce-scatter,
all-gather, the rooted bcast, scatter, gather and reduce, and alltoall over
a 4 B - 1 GiB sweep (the ladder plus the synthesizer's latency tier), and
for the four collective-matmul ops around their size registers, with and
without a wire dtype and on explicit requests, on the intra-node tier, the
emulator rung and DCN; and every family AUTO resolves there builds."""
import jax
import pytest
import torch

from accl_tpu.communicator import Communicator as JComm
from accl_tpu.config import ACCLConfig as JCfg
from accl_tpu.config import Algorithm as JAlgo
from accl_tpu.config import TransportBackend as JT
from accl_tpu.constants import operation as JOp
from accl_tpu.parallel import algorithms as jalg

import accl_tpu_torch as at
from accl_tpu_torch.parallel import algorithms as talg

torch.set_num_threads(1)

OPS = ("allreduce", "reduce_scatter", "allgather", "bcast", "scatter",
       "gather", "reduce", "alltoall")
SIZES = [1 << e for e in range(2, 31)] + [3, 1000, 8191, 8192, 1048575]


def test_select_parity_sweep():
    """Every op and size at worlds 2, 3 and 8, on the intra-node tier, the
    emulator rung and DCN; then the AUTO build sweep, and the selection
    behaviour: non-default registers, the world-8 main-path families,
    explicit requests and fallbacks, unported families."""
    for world in (2, 3, 8):
        jcomm = JComm(jax.devices()[:world])
        tcomm = at.Communicator(world, "cpu")
        for transport in ("ici", "sim", "dcn"):
            jcfg = JCfg(transport=JT(transport))
            tcfg = at.ACCLConfig(transport=at.TransportBackend(transport))
            for op in OPS:
                for nbytes in SIZES:
                    j = jalg.select(JOp[op], nbytes, jcomm, jcfg,
                                    count=nbytes // 4)
                    t = talg.select(at.operation[op], nbytes, tcomm, tcfg,
                                    count=nbytes // 4)
                    assert t.value == j.value, (op, nbytes, world,
                                                transport)
    _cmatmul_select_parity()
    _auto_builds_everywhere()
    _select_parity_non_default_registers()
    _main_path_families_at_world8()
    _explicit_request_and_fallback()
    _unported_families_raise()


CMATMUL_OPS = ("allgather_matmul", "matmul_reduce_scatter",
               "alltoall_matmul", "matmul_alltoall")


def _outcome(select, *args, **kw):
    try:
        return select(*args, **kw).value
    except ValueError as e:
        return ("ValueError", str(e))


def _cmatmul_select_parity():
    """The four collective-matmul ops at worlds 1, 2 and 8 on the
    intra-node tier, the emulator rung and DCN: AUTO over a byte ladder
    around each size register (default and moved), the session wire None
    and "bf16" (the registers compare wire bytes; ``count`` gives the
    operand width, f32 without it), and explicit PALLAS, XLA and RING
    (RING raises in both packages)."""
    for world in (1, 2, 8):
        jcomm = JComm(jax.devices()[:world])
        tcomm = at.Communicator(world, "cpu")
        for transport in ("ici", "sim", "dcn"):
            for wire in (None, "bf16"):
                for th in (256 * 1024, 4096):
                    regs = {"ag_matmul_threshold": th,
                            "rs_matmul_threshold": th,
                            "a2a_matmul_threshold": th,
                            "cmatmul_wire_dtype": wire}
                    jcfg = JCfg(transport=JT(transport)).replace(**regs)
                    tcfg = at.ACCLConfig(transport=at.TransportBackend(
                        transport)).replace(**regs)
                    sizes = [4, th - 1, th, th + 1, 2 * th - 2, 2 * th,
                             2 * th + 4, 1 << 20, 64 << 20]
                    for op in CMATMUL_OPS:
                        for nbytes in sizes:
                            for count in (None, nbytes // 4, nbytes // 2):
                                for req in (None, "pallas", "xla", "ring"):
                                    case = (op, nbytes, count, req, world,
                                            transport, wire, th)
                                    j = _outcome(
                                        jalg.select, JOp[op], nbytes, jcomm,
                                        jcfg, requested=req and JAlgo(req),
                                        count=count or None)
                                    t = _outcome(
                                        talg.select, at.operation[op],
                                        nbytes, tcomm, tcfg,
                                        requested=req and at.Algorithm(req),
                                        count=count or None)
                                    assert t == j, case


def _auto_builds_everywhere():
    """No AUTO resolution of the eight ops raises at world 8: every
    power-of-4 size from 4 B to 1 GiB on SIM, ICI and DCN resolves and
    builds its program (built, not run)."""
    f32, SUM = at.dataType.float32, at.reduceFunction.SUM
    for transport in ("sim", "ici", "dcn"):
        acc = at.ACCL(world=8, device="cpu", config=at.ACCLConfig(
            transport=at.TransportBackend(transport)))
        for e in range(0, 15):
            nbytes = 4 << (2 * e)
            count = nbytes // 4
            specs = (
                acc._spec_allreduce(count, f32, SUM, None, None),
                acc._spec_reduce_scatter(max(1, count // 8), f32, SUM,
                                         None, None),
                acc._spec_allgather(count, f32, None, None),
                acc._spec_bcast(count, f32, 3, None, None),
                acc._spec_scatter(count, f32, 3, None, None),
                acc._spec_gather(count, f32, 3, None, None),
                acc._spec_reduce(count, f32, 3, SUM, None, None),
                acc._spec_alltoall(max(1, count // 8), f32, None, None))
            for key, build in specs:
                assert callable(build()), (transport, nbytes, key)


def _main_path_families_at_world8():
    """What the allreduce sweep runs on the card: flat below the latency
    tier, the one-shot program up to 1 MiB, the ring kernels from there."""
    tcomm = at.Communicator(8, "cpu")
    cfg = at.ACCLConfig(transport=at.TransportBackend.ICI)
    op = at.operation.allreduce
    assert talg.select(op, 4, tcomm, cfg) == at.Algorithm.FLAT
    assert talg.select(op, 8192, tcomm, cfg) == at.Algorithm.XLA
    assert talg.select(op, (1 << 20) - 4, tcomm, cfg) == at.Algorithm.XLA
    for nbytes in (1 << 20, 1 << 30):
        assert talg.select(op, nbytes, tcomm, cfg) == at.Algorithm.PALLAS


def _select_parity_non_default_registers():
    """A seeded threshold pins the ladder; a zero tier or synthesis off
    drops the latency tier: both packages agree on every size."""
    jcomm = JComm(jax.devices()[:8])
    tcomm = at.Communicator(8, "cpu")
    for field, value in (("pallas_threshold", 2 << 20),
                         ("latency_tier_threshold", 0),
                         ("sched_synthesis", False)):
        jcfg = JCfg(transport=JT.ICI).replace(**{field: value})
        tcfg = at.ACCLConfig(transport=at.TransportBackend.ICI).replace(
            **{field: value})
        for nbytes in SIZES:
            j = jalg.select(JOp.allreduce, nbytes, jcomm, jcfg)
            t = talg.select(at.operation.allreduce, nbytes, tcomm, tcfg)
            assert t.value == j.value, (field, nbytes)


def _explicit_request_and_fallback():
    tcomm = at.Communicator(8, "cpu")
    cfg = at.ACCLConfig(transport=at.TransportBackend.ICI)
    assert talg.select(at.operation.allreduce, 4, tcomm, cfg,
                       requested=at.Algorithm.PALLAS) == at.Algorithm.PALLAS
    with pytest.raises(ValueError):
        talg.select(at.operation.allgather, 4, tcomm, cfg,
                    requested=at.Algorithm.FLAT)
    # a session preference the op cannot honor falls back to AUTO, counted
    from accl_tpu_torch.obs import metrics
    before = metrics.snapshot()
    sess = cfg.replace(algorithm=at.Algorithm.FLAT)
    assert talg.select(at.operation.allgather, 1 << 20, tcomm, sess) == \
        at.Algorithm.PALLAS
    d = metrics.delta(before)["counters"]
    assert d['accl_algorithm_fallback_total{op="allgather",'
             'algorithm="flat"}'] == 1.0


def _unported_families_raise():
    """MULTIAXIS (the synthesizer's) is the one family of allreduce,
    reduce-scatter and all-gather still unported; the others build, the
    hierarchical one refusing DCN without a host-aligned shape as the JAX
    package does, and every family of the rooted ops and of alltoall
    builds, PALLAS only with its dtype."""
    tcomm = at.Communicator(8, "cpu")
    f32, SUM = at.dataType.float32, at.reduceFunction.SUM
    for build in (lambda a: talg.build_allreduce(tcomm, SUM, f32, a, None),
                  lambda a: talg.build_allgather(tcomm, a, None, f32),
                  lambda a: talg.build_reduce_scatter(tcomm, SUM, f32, a,
                                                      None)):
        with pytest.raises(at.ACCLError) as ei:
            build(at.Algorithm.MULTIAXIS)
        assert ei.value.code == at.errorCode.COLLECTIVE_NOT_IMPLEMENTED
        assert "ROADMAP.md" in str(ei.value)
        for algo in ("ring", "twotier", "xla", "pallas"):
            assert callable(build(at.Algorithm(algo)))
    for algo in ("tree", "hier", "flat"):
        assert callable(talg.build_allreduce(tcomm, SUM, f32,
                                             at.Algorithm(algo), None))
    with pytest.raises(ValueError, match="host-aligned"):
        talg.build_allreduce(tcomm, SUM, f32, at.Algorithm.HIERARCHICAL,
                             None, on_dcn=True)
    with pytest.raises(ValueError, match="composite"):
        talg.build_allreduce(at.Communicator(7, "cpu"), SUM, f32,
                             at.Algorithm.TWOTIER, None)
    rooted = {
        "bcast": lambda a, dt=f32: talg.build_bcast(tcomm, 3, a, None, dt),
        "scatter": lambda a, dt=f32: talg.build_scatter(tcomm, 3, a, None,
                                                        dt),
        "gather": lambda a, dt=f32: talg.build_gather(tcomm, 3, a, None, dt),
        "reduce": lambda a, dt=f32: talg.build_reduce(tcomm, 3, SUM, dt, a,
                                                      None)}
    for op, build in rooted.items():
        for algo in talg._SUPPORTED[at.operation[op]]:
            assert callable(build(algo)), (op, algo)
        if op != "reduce":
            with pytest.raises(ValueError, match="requires dt"):
                build(at.Algorithm.PALLAS, None)
    for algo in ("xla", "flat", "pallas"):
        assert callable(talg.build_alltoall(tcomm, at.Algorithm(algo), None,
                                            f32)), algo
    with pytest.raises(ValueError, match="requires dt"):
        talg.build_alltoall(tcomm, at.Algorithm.PALLAS, None)
