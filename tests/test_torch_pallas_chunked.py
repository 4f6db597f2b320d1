"""Parity of the port's segmented ring bodies (accl_tpu_torch/parallel/
pallas_chunked.py, plain versions on the CPU) with the JAX package's
segmented Pallas kernels (``build_chunked_ring_*``) in TPU interpret mode.

Segments of 4096 bytes; 1 to 4 segments per chunk, so single segments,
both channels in one group, and credit chains that cross groups all run;
``bidirectional`` on and off. Tolerance: bit-equal (``np.array_equal``),
the fold order being the same. Each JAX oracle configuration runs once
per module over the ``accl`` fixture's 8 devices. Each test loops over its
cases and names the failing one, so the port adds few items to the tier-1
collection (the all-gather cases and the plain kernel's segment-wise check
run inside the reduce-scatter test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu import dataType as JdT
from accl_tpu import reduceFunction as JrF
from accl_tpu.arithconfig import ArithConfig as JArith
from accl_tpu.parallel import pallas_chunked as jchunk
from conftest import requires_interpret_rdma

import accl_tpu_torch as at
from accl_tpu_torch.parallel import pallas_chunked as tchunk

pytestmark = requires_interpret_rdma
torch.set_num_threads(1)

WORLD = 8
SEG = 4096
_J = {"float32": (JdT.float32, np.float32), "int32": (JdT.int32, np.int32),
      "bfloat16": (JdT.bfloat16, jnp.bfloat16)}
_T = {"float32": torch.float32, "int32": torch.int32,
      "bfloat16": torch.bfloat16}
_F = {"sum": (JrF.SUM, at.reduceFunction.SUM),
      "max": (JrF.MAX, at.reduceFunction.MAX)}


def _inputs(seed: int, shape, dt: str):
    rng = np.random.default_rng(seed)
    if dt == "int32":
        x = rng.integers(-1000, 1000, shape).astype(np.int32)
        return x, torch.from_numpy(x.copy())
    x = rng.standard_normal(shape).astype(np.float32)
    if dt == "bfloat16":
        return x.astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return x, torch.from_numpy(x.copy())


def _same(jout, tout: torch.Tensor) -> bool:
    j = np.asarray(jout)
    if j.dtype == jnp.bfloat16:
        j = j.astype(np.float32)
    t = (tout.float() if tout.dtype == torch.bfloat16 else tout).numpy()
    return j.shape == t.shape and np.array_equal(j, t)


@pytest.fixture(scope="module")
def oracle(accl):
    cache = {}
    comm = accl.global_comm()

    def run(name, build, x):
        if name not in cache:
            prog = build(comm)
            cache[name] = np.asarray(prog(jax.device_put(x, comm.sharding())))
        return cache[name]

    return run


def _seg_elems(dt: str) -> int:
    return tchunk._geometry(1, _T[dt], SEG)[2]


# (segments per chunk, bidirectional, dtype): 1-4 segments, both directions
RS_CASES = [(1, True, "float32"), (2, True, "int32"), (3, True, "float32"),
            (4, False, "float32")]


# the bidirectional all-gather runs inside the allreduce cases below
AG_CASES = [(3, False, "bfloat16")]


def test_chunked_reduce_scatter_parity(oracle):
    """The reduce-scatter cases, then the all-gather ones (both share the
    oracle), then the plain kernel's segment-wise check."""
    for nseg, bidir, dt in RS_CASES:
        n = _seg_elems(dt) * nseg
        jx, tx = _inputs(100 + nseg, (WORLD, WORLD * n), dt)
        want = oracle(f"rs-{nseg}-{bidir}-{dt}",
                      lambda c: jchunk.build_chunked_ring_reduce_scatter(
                          c, JrF.SUM, _J[dt][0], segment_bytes=SEG,
                          bidirectional=bidir), jx)
        got = tchunk.chunked_rs_body(tx, P=WORLD,
                                     func=at.reduceFunction.SUM,
                                     dtype=_T[dt], segment_bytes=SEG,
                                     bidirectional=bidir)
        assert tchunk._geometry(n, _T[dt], SEG)[0] == nseg
        assert _same(want, got), (nseg, bidir, dt)
    for nseg, bidir, dt in AG_CASES:
        n = _seg_elems(dt) * nseg - 7          # ragged tail segment
        jx, tx = _inputs(200 + nseg, (WORLD, n), dt)
        want = oracle(f"ag-{nseg}-{bidir}-{dt}",
                      lambda c: jchunk.build_chunked_ring_allgather(
                          c, _J[dt][0], segment_bytes=SEG,
                          bidirectional=bidir), jx)
        got = tchunk.chunked_ag_body(tx, P=WORLD, dtype=_T[dt],
                                     segment_bytes=SEG, bidirectional=bidir)
        assert _same(want, got), ("allgather", nseg, bidir, dt)
    _plain_kernel_is_segmentwise_ring()


# allreduce: chunk = ceil(n / 8) spans 2 segments; n is ragged
AR_CASES = [("max", None), ("sum", "bf16")]


def test_chunked_allreduce_parity(oracle):
    n = 2 * 1024 * WORLD - 5
    jx, tx = _inputs(300, (WORLD, n), "float32")
    for func, wire in AR_CASES:
        jar = tw = None
        if wire:
            jar = JArith(JdT.float32, JdT.bfloat16,
                         arith_is_compressed=False)
            tw = (torch.bfloat16, None)
        want = oracle(f"ar-{func}-{wire}",
                      lambda c: jchunk.build_chunked_ring_allreduce(
                          c, _F[func][0], JdT.float32, segment_bytes=SEG,
                          arith=jar, bidirectional=True), jx)
        got = tchunk.chunked_ar_body(tx, P=WORLD, func=_F[func][1],
                                     dtype=torch.float32, segment_bytes=SEG,
                                     wire=tw, ag_wire=tw, bidirectional=True)
        assert _same(want, got), (func, wire)


def _plain_kernel_is_segmentwise_ring():
    """The segmented kernel's plain version equals the VMEM-range ring run
    on each segment alone, channel 1 reversed when bidirectional; its
    geometry is the JAX package's."""
    from accl_tpu_torch.parallel import pallas_ring as tring
    for nseg in (1, 2, 3, 4):
        for bidir in (False, True):
            rng = np.random.default_rng(nseg)
            x = torch.from_numpy(rng.standard_normal(
                (WORLD, WORLD, nseg, 96)).astype(np.float32))
            got = tchunk.chunked_reduce_scatter(x, at.reduceFunction.SUM,
                                                None, bidir)
            for c in range(nseg):
                d = -1 if bidir and c % 2 else 1
                want = tring._plain_rs(x[:, :, c], at.reduceFunction.SUM,
                                       None, d)
                assert torch.equal(got[:, c], want), (nseg, bidir, c)
    _geometry_matches_jax()


def _geometry_matches_jax():
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16),
                    (torch.int8, jnp.int8)):
        for seg in (4096, 1 << 20, 4 << 20, 100):
            for chunk in (1, 1000, 1 << 17, (1 << 25) + 3):
                assert tchunk._geometry(chunk, dt, seg) == \
                    jchunk._geometry(chunk, jdt, seg)
