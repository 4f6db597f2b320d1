"""Slices 4 and 6 of the port against the JAX package: ``ACCL.alltoall``
in its three families, and the expert-parallel MoE layer with its fused
dispatch, combine and a2a-wgrad, forward and backward
(``accl_tpu_torch.ops.collective_alltoall``, ``accl_tpu_torch.models.moe``),
on the same numpy inputs.

The JAX side runs its Pallas kernels in TPU interpret mode over
``jax.devices()[:W]`` (W <= 8), and ``jax.grad`` through its
``custom_vjp``s and its MoE layer; the port runs its kernels' plain
versions on the CPU and autograd. Tolerances: the all-to-all is transport,
so bit-equal; the fused bodies and the Functions' gradients are bit-equal
on integer-valued operands (every product and partial sum exact in f32)
and within rtol 1e-5 on random ones (the f32 products summed in another
order); the MoE layer within rtol 1e-5 / atol 1e-6, its routing indices
equal, and its gradients within rtol 1e-5 and an atol of 1e-6 of each
tensor's largest magnitude (each element sums the f32 products of a whole
batch of tokens, whose partial sums reach that magnitude). Each JAX oracle
runs once; cases loop inside the two test functions and every assert names
its case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import accl_tpu
from accl_tpu.communicator import Communicator as JComm
from accl_tpu.compat import shard_map
from accl_tpu.config import ACCLConfig as JCfg
from accl_tpu.config import Algorithm as JAlgo
from accl_tpu.config import TransportBackend as JT
from accl_tpu.constants import dataType as JdT
from accl_tpu.models import moe as jmoe
from accl_tpu.ops import collective_alltoall as jca
from accl_tpu.ops import collective_matmul as jcm
from accl_tpu.parallel import algorithms as jalg
from conftest import requires_interpret_rdma

import accl_tpu_torch as at
from accl_tpu_torch.models import moe as tmoe
from accl_tpu_torch.obs import metrics
from accl_tpu_torch.ops import collective_alltoall as tca
from accl_tpu_torch.ops import collective_matmul as tcm
from accl_tpu_torch.parallel import algorithms as talg

pytestmark = requires_interpret_rdma
torch.set_num_threads(1)

SEG = 1024


def _data(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ints(seed: int, shape, lo=-4, hi=5) -> np.ndarray:
    """Integer-valued f32: exact under any summation order."""
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


def _alltoall(acc, x, n, dt, algo, comp):
    s = acc.create_buffer(x.shape[1], dt, host_data=x)
    r = acc.create_buffer(x.shape[1], dt)
    acc.alltoall(s, r, n, algorithm=algo, compress_dtype=comp)
    return np.asarray(r.host)


def test_alltoall_matches_jax():
    """Host API at worlds 8 and 3 (ragged n; one and two segments of the
    1024-byte geometry), XLA, FLAT and PALLAS against the JAX package's same
    family, f32 bit-equal; at world 3 a bf16 wire through each family with
    its own-chunk rule: XLA sends the rank's own chunk through the wire too,
    FLAT and PALLAS keep it exact."""
    for world, n in ((8, 1000), (3, 1500)):
        jacc = accl_tpu.ACCL(devices=jax.devices()[:world], config=JCfg(
            transport=JT.ICI, segment_size=SEG))
        tacc = at.ACCL(world=world, device="cpu", config=at.ACCLConfig(
            transport=at.TransportBackend.ICI, segment_size=SEG))
        x = _data(world * n, (world, world * n))
        moved = x.reshape(world, world, n).transpose(1, 0, 2)
        cases = [(a, None) for a in ("xla", "flat", "pallas")]
        if world == 3:
            cases += [(a, "bf16") for a in ("xla", "flat", "pallas")]
        for algo, wire in cases:
            want = _alltoall(jacc, x, n, JdT.float32, JAlgo(algo),
                             JdT.bfloat16 if wire else None)
            got = _alltoall(tacc, x, n, at.dataType.float32,
                            at.Algorithm(algo),
                            at.dataType.bfloat16 if wire else None)
            case = (world, n, algo, wire)
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
                case
            exp = moved.copy()
            if wire:
                exp = torch.from_numpy(exp).to(torch.bfloat16).float() \
                    .numpy()
                if algo != "xla":
                    ranks = np.arange(world)
                    exp[ranks, ranks] = moved[ranks, ranks]
            assert np.array_equal(got, exp.reshape(world, -1)), case
        jacc.deinit()
        tacc.deinit()


def _jrun(comm, builder, algo, bidir, wire, a, b):
    prog = builder(comm, algo, bidirectional=bidir, wire_dtype=wire)
    put = (lambda v: jax.device_put(v, comm.sharding()))
    return np.asarray(prog(put(a), put(b)))


def _trun(comm, builder, algo, bidir, wire, a, b):
    prog = builder(comm, algo, bidirectional=bidir, wire_dtype=wire)
    return prog(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def test_moe_dispatch_combine_match_jax(monkeypatch):
    """The fused dispatch and combine bodies (the kernels' plain versions)
    against the JAX package's Pallas kernels and its XLA pair, integer
    operands: W 4 unidirectional on the aligned and the uneven shape, W 8
    bidirectional on the uneven one; a random case against the XLA pair and
    a bf16 wire case against the kernels; the a2a-wgrad body and the
    Functions' gradients; then ``build_moe_forward`` and its gradients at
    the JAX package's test shape with weights carried by
    ``params_from_jax``, and the engage-reason vocabulary."""
    J, T = JAlgo.PALLAS, at.Algorithm.PALLAS
    for W, bidir, shapes in ((4, False, ((2, 8, 128, 128), (2, 5, 72, 40))),
                             (8, True, ((2, 5, 72, 40),))):
        jcomm, tcomm = JComm(jax.devices()[:W]), at.Communicator(W, "cpu")
        for el, C, d, h in shapes:
            case = (W, bidir, el, C, d, h)
            x = _ints(W + C, (W, W * el, C, d))
            w_in = _ints(W + d, (W, el, d, h))
            hx = _ints(W + h, (W, el, W * C, h), -3, 4)
            w_out = _ints(W + el, (W, el, h, d), -3, 4)
            for name, jb, tb, a, b in (
                    ("dispatch", jalg.build_alltoall_matmul,
                     talg.build_alltoall_matmul, x, w_in),
                    ("combine", jalg.build_matmul_alltoall,
                     talg.build_matmul_alltoall, hx, w_out)):
                fused = _jrun(jcomm, jb, J, bidir, None, a, b)
                ref = _jrun(jcomm, jb, JAlgo.XLA, bidir, None, a, b)
                got = _trun(tcomm, tb, T, bidir, None, a, b)
                assert np.array_equal(got, fused), (name, case)
                assert np.array_equal(got, ref), (name, case)
    _random_and_wire_cases()
    _wgrad_and_functions_match()
    _moe_forward_cases()
    _engage_vocabulary(monkeypatch)


def _random_and_wire_cases():
    """Random f32 at rtol 1e-5 (against the XLA pair, which sums the same
    products); a bf16 wire: dispatch rounds the token
    payload once (integers: exact, while the f32 sums pass bf16's exact
    range), combine rounds each y block once (integer y past 256: the
    rounding is the same on both sides)."""
    W, el, C, d, h = 4, 2, 5, 72, 40
    jcomm, tcomm = JComm(jax.devices()[:W]), at.Communicator(W, "cpu")
    J, T = JAlgo.PALLAS, at.Algorithm.PALLAS
    x, w_in = _data(1, (W, W * el, C, d)), _data(2, (W, el, d, h))
    hx, w_out = _data(3, (W, el, W * C, h)), _data(4, (W, el, h, d))
    for name, jb, tb, a, b in (
            ("dispatch", jalg.build_alltoall_matmul,
             talg.build_alltoall_matmul, x, w_in),
            ("combine", jalg.build_matmul_alltoall,
             talg.build_matmul_alltoall, hx, w_out)):
        want = _jrun(jcomm, jb, JAlgo.XLA, True, None, a, b)
        got = _trun(tcomm, tb, T, True, None, a, b)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"random {name}")
    x = _ints(5, (W, W * el, C, 512), -3, 4)
    w = _ints(6, (W, el, 512, h), -3, 4)
    want = _jrun(jcomm, jalg.build_alltoall_matmul, J, False, "bf16", x, w)
    got = _trun(tcomm, talg.build_alltoall_matmul, T, False, "bf16", x, w)
    assert np.abs(want).max() > 256
    assert np.array_equal(got, want), "bf16 wire dispatch"
    hx = _ints(7, (W, el, W * C, 64), -5, 6)
    w = _ints(8, (W, el, 64, d), -5, 6)
    want = _jrun(jcomm, jalg.build_matmul_alltoall, J, False, "bf16", hx, w)
    got = _trun(tcomm, talg.build_matmul_alltoall, T, False, "bf16", hx, w)
    exact = _trun(tcomm, talg.build_matmul_alltoall, T, False, "off", hx, w)
    assert not np.array_equal(got, exact), "bf16 wire combine rounds"
    assert np.array_equal(got, want), "bf16 wire combine"


def _jax_a2a_wgrad(W, trav, loc, lhs, bidir, wire):
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:W]), ("accl",))

    def body(ts, ls):
        return jca.a2a_gathered_wgrad_body(
            ts[0], ls[0], axis="accl", overlap=True, bidirectional=bidir,
            wire_dtype=wire, travel_lhs=lhs)[None]
    return np.asarray(jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P("accl"), P("accl")),
        out_specs=P("accl"), check_vma=False))(trav, loc))


def _wgrad_and_functions_match():
    """``a2a_gathered_wgrad_body`` against the JAX body running
    ``_a2a_wgrad_kernel`` in interpret mode at W 4 (el 2, C 5, ct 72, cl
    40), integer operands bit-equal: dispatch's dw unidirectional, and
    combine's mirror bidirectional (the exchange's two channels order the
    sum) with a bf16 wire on the traveller (past bf16's 8 bits, rounded
    once); random f32 against the JAX unfused pair within rtol 1e-5. Then
    the gradients of both Functions (x, h and both w, integer operands and
    cotangents), overlap True and False, against ``jax.grad`` through the
    JAX ``custom_vjp``s (their unfused duals): bit-equal."""
    W, el, C, ct, cl = 4, 2, 5, 72, 40
    for lhs, bidir, wire, (lo, hi) in ((True, False, None, (-4, 5)),
                                       (False, True, "bf16", (-600, 600))):
        trav = _ints(ct + hi, (W, W * el, C, ct), lo, hi)
        loc = _ints(cl, (W, el, W * C, cl))
        want = _jax_a2a_wgrad(W, trav, loc, lhs, bidir, wire)
        got = tca.a2a_gathered_wgrad_body(
            torch.from_numpy(trav), torch.from_numpy(loc), overlap=True,
            bidirectional=bidir, wire_dtype=wire, travel_lhs=lhs).numpy()
        assert np.array_equal(got, want), ("a2a wgrad", lhs, bidir, wire)
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:W]), ("accl",))
    trav, loc = _data(31, (W, W * el, C, ct)), _data(32, (W, el, W * C, cl))

    def xla_body(ts, ls):
        return jca.a2a_gathered_wgrad_body(ts[0], ls[0], axis="accl",
                                           overlap=False)[None]
    want = np.asarray(jax.jit(shard_map(
        xla_body, mesh=mesh, in_specs=(P("accl"), P("accl")),
        out_specs=P("accl"), check_vma=False))(trav, loc))
    got = tca.a2a_gathered_wgrad_body(torch.from_numpy(trav),
                                      torch.from_numpy(loc), overlap=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                               err_msg="a2a wgrad random f32")
    d, h = 64, 32
    x, w_in = _ints(41, (W, W * el, C, d)), _ints(42, (W, el, d, h))
    hx, w_out = _ints(43, (W, el, W * C, h)), _ints(44, (W, el, h, d))
    cot_d, cot_c = _ints(45, (W, el, W * C, h)), _ints(46, (W, W * el, C, d))

    def body(xs, ws, hs, wos, cd, cc):
        def loss(x_, w_, h_, wo_):
            y = jca.alltoall_matmul(x_, w_, "accl", None, False)
            z = jca.matmul_alltoall(h_, wo_, "accl", None, False)
            return jnp.sum(y * cd[0]) + jnp.sum(z * cc[0])
        return tuple(g[None] for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
            xs[0], ws[0], hs[0], wos[0]))

    spec = P("accl")
    want = [np.asarray(g) for g in jax.jit(shard_map(
        body, mesh=mesh, in_specs=(spec,) * 6, out_specs=(spec,) * 4,
        check_vma=False))(x, w_in, hx, w_out, cot_d, cot_c)]
    for overlap in (True, False):
        ts = [torch.from_numpy(a).requires_grad_()
              for a in (x, w_in, hx, w_out)]
        loss = (tca.alltoall_matmul(ts[0], ts[1], overlap=overlap)
                * torch.from_numpy(cot_d)).sum() \
            + (tca.matmul_alltoall(ts[2], ts[3], overlap=overlap)
               * torch.from_numpy(cot_c)).sum()
        loss.backward()
        for name, t, exp in zip(("dx", "dw_in", "dh", "dw_out"), ts, want):
            assert np.array_equal(t.grad.numpy(), exp), (name, overlap)


def _close_grads(got, want, what):
    """rtol 1e-5 and an atol of 1e-6 of the tensor's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


def _moe_forward_cases():
    """build_moe_forward at W 4, n 16, d 128, h 128, E 8: top_k 1 and 2,
    capacity 8 and 2 (tokens drop), return_aux, overlap True and False in
    the port against the JAX layer (its fused path once, its baseline
    otherwise); routing indices equal; then the gradients of the router,
    w_in, w_out and the tokens at top_k 1 (C 8) and 2 (C 3, tokens drop)
    against ``jax.grad``."""
    W, n, d, h, E = 4, 16, 128, 128, 8
    jcomm, tcomm = JComm(jax.devices()[:W]), at.Communicator(W, "cpu")
    gp = jmoe.init_params(jax.random.PRNGKey(0), jcomm, d, h, E)
    jparams = jmoe.shard_params(gp, jcomm)
    tparams = tmoe.shard_params(tmoe.params_from_jax(gp, "cpu"), tcomm)
    x = _data(11, (W, n, d))
    xj = jax.device_put(x, jcomm.sharding())
    xt = torch.from_numpy(x)
    for top_k, C, aux, j_overlap in ((1, 8, False, True),
                                     (2, 8, False, False),
                                     (1, 2, True, False),
                                     (2, 3, True, False)):
        case = (top_k, C, aux)
        want = jmoe.build_moe_forward(jcomm, E, C, top_k=top_k,
                                      return_aux=aux,
                                      overlap=j_overlap)(jparams, xj)
        probs = jax.nn.softmax(jnp.asarray(x) @ gp.router, axis=-1)
        jtop = np.asarray(jax.lax.top_k(probs, top_k)[1])
        ttop = tmoe._route(xt, tparams.router, E, C, top_k)[1].numpy()
        assert np.array_equal(ttop, jtop), case
        for overlap in (True, False):
            got = tmoe.build_moe_forward(tcomm, E, C, top_k=top_k,
                                         return_aux=aux,
                                         overlap=overlap)(tparams, xt)
            if aux:
                np.testing.assert_allclose(
                    got[1].numpy(), np.asarray(want[1]), rtol=1e-5,
                    atol=1e-6, err_msg=f"aux {case} {overlap}")
                got, want_y = got[0], want[0]
            else:
                want_y = want
            np.testing.assert_allclose(got.numpy(), np.asarray(want_y),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{case} overlap={overlap}")
    ref = tmoe.reference_moe(tparams, x, E, 2, top_k=1)
    got = tmoe.build_moe_forward(tcomm, E, 2, overlap=True)(tparams, xt)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5,
                               err_msg="float64 reference")
    np.testing.assert_allclose(
        ref, jmoe.reference_moe(gp, x, E, 2), rtol=1e-12, atol=1e-12,
        err_msg="the two float64 references")
    # the gradients of sum(out * cot) in the router, w_in, w_out and the
    # tokens: jax.grad through the JAX layer (its fused custom_vjps once,
    # its baseline once) against autograd through both port datapaths
    cot = _data(12, (W, n, d))
    for top_k, C, j_overlap in ((1, 8, True), (2, 3, False)):
        prog = jmoe.build_moe_forward(jcomm, E, C, top_k=top_k,
                                      overlap=j_overlap)
        jg, jgx = jax.grad(lambda p_, x_: jnp.sum(prog(p_, x_) * cot),
                           argnums=(0, 1))(jparams, xj)
        for overlap in (True, False):
            case = (top_k, C, overlap)
            tp_ = tmoe.MoEParams(*(t.clone().requires_grad_()
                                   for t in tparams))
            x_ = xt.clone().requires_grad_()
            out = tmoe.build_moe_forward(tcomm, E, C, top_k=top_k,
                                         overlap=overlap)(tp_, x_)
            (out * torch.from_numpy(cot)).sum().backward()
            for name, t, want in zip(tp_._fields, tp_, jg):
                _close_grads(t.grad.numpy(), want, f"d{name} {case}")
            _close_grads(x_.grad.numpy(), jgx, f"dx {case}")


def _engage_vocabulary(monkeypatch):
    """At the JAX package's engage-resolution shapes both packages answer
    the same reason for every register setting, the a2a-wgrad's too (with
    ``moe_dw_overlap`` off as well); at a shape past the TPU's 12 MiB VMEM
    plan the port engages (a kept divergence), the Switch-Base-8 dw shape
    included. A requested ``off`` is never counted, a declined threshold
    is, the dw's under ``moe_a2a_dw``."""
    monkeypatch.setattr(jcm, "_kernels_available", lambda: True)
    el, C, d, h = 2, 8, 64, 64
    block = el * C * d * 4
    saved = [(m.get_overlap_enabled(), m.get_overlap_threshold())
             for m in (jca, tca)] + [jcm.get_wire_dtype(),
                                     tcm.get_wire_dtype()]
    try:
        for enabled, threshold, wire, overlap in (
                (False, 0, None, None), (True, 0, None, None),
                (True, 0, None, False), (True, block + 1, None, None),
                (True, block + 1, None, True), (True, block, None, None),
                (True, block, "bf16", None)):
            got = []
            for m, cm in ((jca, jcm), (tca, tcm)):
                m.set_overlap_enabled(enabled)
                m.set_overlap_threshold(threshold)
                cm.set_wire_dtype(wire)
                dt = jnp.float32 if m is jca else torch.float32
                got.append(m.a2a_engage_reason(el, C, d, h, 4, dt, overlap))
            assert got[0] == got[1], (enabled, threshold, wire, overlap, got)
            for dw in (True, False):
                got = []
                for m in (jca, tca):
                    m.set_dw_overlap_enabled(dw)
                    dt = jnp.float32 if m is jca else torch.float32
                    got.append(m.a2a_wgrad_engage_reason(el, C, d, h, 4, dt,
                                                         overlap))
                assert got[0] == got[1], ("dw", dw, enabled, threshold, wire,
                                          overlap, got)
        for m in (jca, tca):
            m.set_dw_overlap_enabled(True)
        for m in (jca, tca):
            m.set_overlap_threshold(0)
        for cm in (jcm, tcm):
            cm.set_wire_dtype(None)
        assert jca.a2a_engage_reason(8, 1024, 4096, 4096, 8, jnp.float32,
                                     True) == "vmem_miss"
        assert tca.a2a_matmul_engages(8, 1024, 4096, 4096, 8, torch.float32,
                                      True)
        # Switch-Base-8's dw (e_local 1, C 320, ct 768, cl 3072, world 8):
        # past the TPU plan, on the card's
        assert jca.a2a_wgrad_engage_reason(1, 320, 768, 3072, 8, jnp.float32,
                                           True) == "vmem_miss"
        assert tca.a2a_wgrad_engage_reason(1, 320, 768, 3072, 8,
                                           torch.float32, True) is None
        jplan = jca.a2a_wgrad_plan(2, 8, 32, 64, 4, jnp.float32, True)
        tplan = tca.a2a_wgrad_plan(2, 8, 32, 64, 4, torch.float32, True)
        assert tplan.keys() == jplan.keys(), (tplan, jplan)
        assert (tplan["nchan"], tca.a2a_wgrad_plan(
            2, 8, 32, 64, 2, torch.float32, True)["nchan"]) == (2, 1)
        x = torch.ones((4, 8, C, d))
        w = torch.ones((4, el, d, h))
        tca.set_overlap_threshold(block + 1)
        before = metrics.snapshot()
        tca.alltoall_matmul_body(x, w, overlap=False)
        tca.alltoall_matmul_body(x, w)
        counted = metrics.delta(before)["counters"]
        assert counted == {'accl_cmatmul_fallback_total{op="alltoall_matmul"'
                           ',reason="threshold"}': 1.0}, counted
        loc = torch.ones((4, el, 4 * C, h))
        before = metrics.snapshot()
        tca.a2a_gathered_wgrad_body(x, loc, overlap=False)
        tca.set_dw_overlap_enabled(False)
        tca.a2a_gathered_wgrad_body(x, loc)
        tca.set_dw_overlap_enabled(True)
        tca.a2a_gathered_wgrad_body(x, loc)
        counted = metrics.delta(before)["counters"]
        assert counted == {'accl_cmatmul_fallback_total{op="moe_a2a_dw"'
                           ',reason="threshold"}': 1.0}, counted
    finally:
        for m, (enabled, threshold) in zip((jca, tca), saved[:2]):
            m.set_overlap_enabled(enabled)
            m.set_overlap_threshold(threshold)
            m.set_dw_overlap_enabled(True)
        jcm.set_wire_dtype(saved[2])
        tcm.set_wire_dtype(saved[3])
