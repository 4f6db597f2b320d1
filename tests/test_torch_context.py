"""The port's context-parallel layers (``accl_tpu_torch.parallel.context``:
ring attention, the zigzag ring and Ulysses, each with ``use_flash`` off and
on) against the JAX package's (``accl_tpu.parallel.context``) on the same
numpy inputs, forward and the gradient of a sum of squares, at world 4.

The JAX oracles are its ``use_flash=False`` layers over ``jax.devices()[:4]``
(its flash arms run interpret-mode kernels inside ``shard_map`` and take
seconds each; one flash ring forward is kept), each run once. The port's
flash arm runs the plain versions of the flash kernels, as its wrappers do
on CPU tensors. Tolerance: every output and gradient within 1e-5 of its
largest magnitude (the arms sum the same products in other orders and the
flash arm works in the exp2 domain; measured up to 1.3e-6). One test loops
over every case and names the failing one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.communicator import Communicator as JComm
from accl_tpu.parallel import context as jctx

import accl_tpu_torch as at
from accl_tpu_torch.parallel import context as tctx

torch.set_num_threads(1)

W = 4
TOL = 1e-5


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax(build, xs):
    comm = JComm(jax.devices()[:W])
    prog = build(comm)
    put = [jax.device_put(x, comm.sharding()) for x in xs]
    out, vjp = jax.vjp(prog, *put)
    grads = vjp(2 * out)          # the gradient of sum(out ** 2)
    return [np.asarray(x) for x in (out, *grads)]


def _port(build, xs):
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = build(at.Communicator(W, "cpu"))(*ts)
    (out ** 2).sum().backward()
    return [x.detach().numpy() for x in (out, *(t.grad for t in ts))]


def _close(what, got, want):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * top, f"{what}: max|err| {err} > {TOL} x {top}"


def test_context_layers_match_jax():
    n, d, H = 256, 64, 4
    cases = [
        ("ring causal", (W, n, d),
         lambda c: jctx.build_ring_attention(c, causal=True),
         lambda c, f: tctx.build_ring_attention(c, causal=True,
                                                use_flash=f)),
        ("ring", (W, 128, d),
         lambda c: jctx.build_ring_attention(c),
         lambda c, f: tctx.build_ring_attention(c, use_flash=f)),
        ("zigzag", (W, n, d),
         lambda c: jctx.build_zigzag_ring_attention(c),
         lambda c, f: tctx.build_zigzag_ring_attention(c, use_flash=f)),
        ("ulysses causal", (W, 64, H, d),
         lambda c: jctx.build_ulysses_attention(c, H, causal=True),
         lambda c, f: tctx.build_ulysses_attention(c, H, causal=True,
                                                   use_flash=f)),
    ]
    for seed, (name, shape, jbuild, tbuild) in enumerate(cases):
        xs = _inputs(seed, shape)
        want = _jax(jbuild, xs)
        for flash in (False, True):
            got = _port(lambda c: tbuild(c, flash), xs)
            for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                _close(f"{name} use_flash={flash} {what}", a, b)
    _flash_ring_forward_matches_jax_flash()
    _layouts_and_errors()


def _flash_ring_forward_matches_jax_flash():
    """One forward of the JAX flash arm itself (interpret-mode kernels)."""
    xs = _inputs(7, (W, 128, 64))
    comm = JComm(jax.devices()[:W])
    prog = jctx.build_ring_attention(comm, causal=True, use_flash=True)
    want = np.asarray(prog(*(jax.device_put(x, comm.sharding())
                             for x in xs)))
    got = tctx.build_ring_attention(at.Communicator(W, "cpu"), causal=True,
                                    use_flash=True)(
        *(torch.from_numpy(x) for x in xs)).numpy()
    _close("ring causal use_flash=True vs the JAX flash arm", got, want)


def _layouts_and_errors():
    x = np.random.default_rng(9).standard_normal((2 * W * 6, 3)).astype(
        np.float32)
    lay = jctx.zigzag_layout(jnp.asarray(x), W)
    tlay = tctx.zigzag_layout(torch.from_numpy(x), W)
    assert np.array_equal(np.asarray(lay), tlay.numpy())
    assert np.array_equal(tctx.zigzag_unlayout(tlay, W).numpy(), x)
    comm = at.Communicator(W, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tctx.build_ulysses_attention(comm, 6)
    with pytest.raises(ValueError, match="not divisible"):
        jctx.build_ulysses_attention(JComm(jax.devices()[:W]), 6)
    with pytest.raises(ValueError, match="n_heads"):
        tctx.build_ulysses_attention(comm, 8)(
            *(torch.zeros(W, 64, 4, 8) for _ in range(3)))
    with pytest.raises(ValueError, match="even"):
        tctx.build_zigzag_ring_attention(comm)(
            *(torch.zeros(W, 5, 8) for _ in range(3)))
    # the flash arm needs n to fill its 128-row blocks, as in JAX
    with pytest.raises(ValueError, match="S %"):
        tctx.build_ring_attention(comm, use_flash=True)(
            *(torch.zeros(W, 96, 8) for _ in range(3)))
