"""Parity of the port's VMEM-range ring programs (accl_tpu_torch/parallel/
pallas_ring.py, plain versions on the CPU) with the JAX package's Pallas
ring kernels run in TPU interpret mode, on the same numpy inputs.

Tolerance: bit-equal (``np.array_equal``). The port folds in the ring's
order (received partial ⊕ local chunk, from each chunk's own rank), casts
the wire with the same rounding, and dequantizes the int8 wire by the
float32 reciprocal of the scale exactly as XLA compiles the JAX division.

Each JAX oracle configuration runs once per module (``oracle`` fixture)
over the session ``accl`` fixture's 8 devices, at <= 4096 elements per rank.
Each test loops over its cases and names the failing one, so the port adds
few items to the tier-1 collection.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu import dataType as JdT
from accl_tpu import reduceFunction as JrF
from accl_tpu.arithconfig import ArithConfig as JArith
from accl_tpu.parallel import pallas_ring as jring
from conftest import requires_interpret_rdma

import accl_tpu_torch as at
from accl_tpu_torch.parallel import pallas_ring as tring

pytestmark = requires_interpret_rdma
torch.set_num_threads(1)

WORLD = 8
F32, I32, BF16 = "float32", "int32", "bfloat16"


def _inputs(seed: int, shape, dt: str, scale: float = 1.0):
    """(numpy array for JAX, torch tensor for the port) with equal values."""
    rng = np.random.default_rng(seed)
    if dt == I32:
        x = rng.integers(-1000, 1000, shape).astype(np.int32)
        return x, torch.from_numpy(x.copy())
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if dt == BF16:
        return x.astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return x, torch.from_numpy(x.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _same(jout: np.ndarray, tout: torch.Tensor) -> bool:
    j = np.asarray(jout)
    if j.dtype == jnp.bfloat16:
        j = j.astype(np.float32)
    return j.shape == tuple(tout.shape) and np.array_equal(j, _np(tout))


@pytest.fixture(scope="module")
def oracle(accl):
    """Runs each JAX oracle configuration once; later cases reuse it."""
    cache = {}
    comm = accl.global_comm()

    def run(name, build, x):
        if name not in cache:
            prog = build(comm)
            cache[name] = np.asarray(prog(jax.device_put(x, comm.sharding())))
        return cache[name]

    return run


@pytest.fixture(scope="module")
def tcomm():
    return at.Communicator(WORLD, "cpu")


_JD = {F32: JdT.float32, I32: JdT.int32, BF16: JdT.bfloat16}
_TD = {F32: at.dataType.float32, I32: at.dataType.int32,
       BF16: at.dataType.bfloat16}
_JF = {"sum": JrF.SUM, "max": JrF.MAX}
_TF = {"sum": at.reduceFunction.SUM, "max": at.reduceFunction.MAX}

RS_CASES = [("sum", F32, 24), ("max", F32, 24), ("sum", I32, 24),
            ("sum", BF16, 40)]


def _reduce_scatter_parity(oracle, tcomm):
    """SUM/MAX and f32/i32/bf16 payloads; for the f32 cases also the
    kernel's own output (before the program's shift), which leaves rank r
    owning chunk (r+1)%P: rolling the JAX program's result back by one
    rank gives the plain kernel's raw output."""
    for func, dt, n in RS_CASES:
        jx, tx = _inputs(10 + n, (WORLD, WORLD * n), dt)
        want = oracle(f"rs-{func}-{dt}-{n}",
                      lambda c: jring.build_pallas_ring_reduce_scatter(
                          c, _JF[func], _JD[dt]), jx)
        got = tring.build_pallas_ring_reduce_scatter(tcomm, _TF[func],
                                                     _TD[dt])(tx)
        assert _same(want, got), ("reduce_scatter", func, dt, n)
        if dt != F32:
            continue
        L = tring._pad_rows(n, torch.float32) * tring._LANES
        chunks = torch.zeros((WORLD, WORLD, L))
        chunks[:, :, :n] = tx.reshape(WORLD, WORLD, n)
        raw = tring.ring_reduce_scatter(chunks, _TF[func])[:, :n]
        assert np.array_equal(np.roll(want, -1, axis=0), _np(raw)), \
            ("reduce_scatter raw kernel output", func)


AG_CASES = [(F32, 40, None), (F32, 1000, "bf16")]


def test_allgather_parity(oracle, tcomm):
    """The all-gather cases, then the reduce-scatter ones
    (:func:`_reduce_scatter_parity`)."""
    for dt, n, wire in AG_CASES:
        jx, tx = _inputs(20 + n, (WORLD, n), dt)
        jar = tar = None
        if wire:
            jar = JArith(JdT.float32, JdT.bfloat16,
                         arith_is_compressed=False)
            tar = at.ArithConfig(at.dataType.float32, at.dataType.bfloat16,
                                 arith_is_compressed=False)
        want = oracle(f"ag-{dt}-{n}-{wire}",
                      lambda c: jring.build_pallas_ring_allgather(
                          c, _JD[dt], arith=jar), jx)
        got = tring.build_pallas_ring_allgather(tcomm, _TD[dt],
                                                arith=tar)(tx)
        assert _same(want, got), ("allgather", dt, n, wire)
    _reduce_scatter_parity(oracle, tcomm)


AR_CASES = [("sum", 1000, None), ("max", 50, None), ("sum", 4096, "bf16"),
            ("sum", 1000, "int8")]


def _arith(wire, jax_side: bool):
    if wire is None:
        return None
    if jax_side:
        comp = JdT.bfloat16 if wire == "bf16" else JdT.int8
        return JArith(JdT.float32, comp, arith_is_compressed=False,
                      quant_scale=10.0 if wire == "int8" else None)
    comp = at.dataType.bfloat16 if wire == "bf16" else at.dataType.int8
    return at.ArithConfig(at.dataType.float32, comp,
                          arith_is_compressed=False,
                          quant_scale=10.0 if wire == "int8" else None)


def test_allreduce_parity(oracle, tcomm):
    """n=1000 and 50 are ragged (not a multiple of world * 128); the int8
    wire's values reach the clip at +-127 / scale."""
    for func, n, wire in AR_CASES:
        jx, tx = _inputs(30 + n, (WORLD, n), F32,
                         6.0 if wire == "int8" else 1.0)
        want = oracle(f"ar-{func}-{n}-{wire}",
                      lambda c: jring.build_pallas_ring_allreduce(
                          c, _JF[func], JdT.float32,
                          arith=_arith(wire, True)), jx)
        got = tring.build_pallas_ring_allreduce(
            tcomm, _TF[func], at.dataType.float32,
            arith=_arith(wire, False))(tx)
        assert _same(want, got), (func, n, wire)
        if wire is None:
            # every rank holds the same all-reduced row
            assert (got == got[0]).all()
    _vmem_threshold_matches_jax()


def _vmem_threshold_matches_jax():
    assert tring.VMEM_PAYLOAD_THRESHOLD == jring.VMEM_PAYLOAD_THRESHOLD
    for n in (1, 127, 128, 129, 1000, 131072, 131073):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16),
                         (torch.int8, jnp.int8)):
            assert tring._pad_rows(n, tdt) == jring._pad_rows(n, jdt)
            assert tring._staged_bytes(WORLD, n, tdt) == \
                jring._staged_bytes(WORLD, n, jdt)
