"""The port's pipeline-parallel path (``accl_tpu_torch.models.pipeline``,
``ops.pipeline_relay``, the block bodies of ``models.zero``) against the JAX
package's on the same numpy inputs.

* Schedules: ``schedule_table`` array for array at the JAX suite's
  geometries, ``resolve_pp_schedule``'s decision and source for "auto",
  "1f1b" and "gpipe" at several payloads, ``ValueError`` for M < world in
  both packages.
* The relay: ``pp_relay``, ``device_api.pp_relay`` and
  ``build_pipeline_relay`` (PALLAS and XLA) ``torch.equal`` to the JAX XLA
  program at worlds 3 and 8 (f32, bf16 and int32), and to one JAX PALLAS
  relay in interpret mode at world 4, (4, 8); the port's autograd gradients
  equal to ``jax.grad``'s through the relay; ``pp_plan`` and
  ``relay_engage_reason`` equal to JAX's; the counters.
* Simple steps: 1F1B at world 4, M 4 and at world 2, M 4, V 2, and GPipe at
  world 2, against the JAX steps (``overlap=False``) on weights carried
  across: loss and new parameters within 1e-5 of each tensor's largest
  magnitude (f32 sums in another order), the loss within 1e-5 of the JAX
  package's float64 ``reference_train_loss``, ``stash_slots <= world``; the
  relay-kernel arm bit-equal to the roll arm.
* The composed step at (pp 2, dp 2, tp 1) and (2, 1, 2), d 8, h 16, 2 heads,
  M 4, b 4: both schedules against JAX's ``overlap=False`` steps within
  1e-5 of scale; the port's engaged arm at dp 2 (bucket gather, all-gather
  x matmul duals, gathered wgrads: their plain versions here) against its
  flat arm; the whole-step demotion to GPipe at a declining geometry,
  counted under ``op="pp_pipeline"``.
* The ``config`` write-through of the pipeline registers.

One test loops over every case and names the failing one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from accl_tpu import Algorithm as JAlgo
from accl_tpu.communicator import Communicator as JComm
from accl_tpu.models import pipeline as jpp
from accl_tpu.ops import pipeline_relay as jrelay
from accl_tpu.parallel import algorithms as jalg

import accl_tpu_torch as at
from accl_tpu_torch import device_api as tdapi
from accl_tpu_torch.models import pipeline as tpp
from accl_tpu_torch.obs import metrics as tmetrics
from accl_tpu_torch.ops import collective_matmul as tcm
from accl_tpu_torch.ops import pipeline_relay as trelay
from accl_tpu_torch.parallel import algorithms as talg

torch.set_num_threads(1)

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i32": jnp.int32}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}
_ORACLES: dict = {}


def _oracle(key, fn):
    """Each JAX oracle once per module."""
    if key not in _ORACLES:
        _ORACLES[key] = fn()
    return _ORACLES[key]


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _close(what, got, want, rel=1e-5):
    got = got.detach().double().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, f"{what}: max|err| {err} > {rel} x {top}"


def _counter(name, **labels):
    """The sum of the port's counter ``name`` over the series carrying
    ``labels``."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(v for k, v in tmetrics.snapshot()["counters"].items()
               if k.split("{")[0] == name and all(w in k for w in want))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

TABLES = [(2, 2, 1), (2, 4, 1), (4, 4, 1), (4, 8, 1), (8, 16, 1),
          (2, 4, 2), (4, 8, 2), (3, 6, 2)]
FIELDS = ("f_mb", "f_chunk", "f_slot", "dy_slot", "b_mb", "b_chunk",
          "b_slot", "b_in_slot", "arr_f_slot", "arr_b_slot")


def _schedules(monkeypatch):
    # schedule=None reads the session register: the default in both
    for mod in (jpp, tpp):
        monkeypatch.setattr(mod, "_SCHEDULE_DEFAULT", "auto")
    for geo in TABLES:
        jt, tt = jpp.schedule_table(*geo), tpp.schedule_table(*geo)
        for f in ("steps", "stash_slots", "grad_slots", "max_live"):
            assert getattr(jt, f) == getattr(tt, f), (geo, f)
        for f in FIELDS:
            assert np.array_equal(getattr(jt, f), getattr(tt, f)), (geo, f)
        assert jt.bubble_fraction == tt.bubble_fraction, geo
        assert jpp.gpipe_bubble_fraction(*geo) == \
            tpp.gpipe_bubble_fraction(*geo), geo
    before = _counter("accl_sched_plan_total", op="pipeline")
    n = 0
    for sched in ("auto", "1f1b", "gpipe", None):
        for world, M, V in ((4, 8, 1), (4, 2, 1), (2, 4, 2), (8, 8, 1)):
            for payload, tp, tp_bytes in ((4, 1, 0), (1 << 20, 1, 0),
                                          (1 << 26, 1, 0),
                                          (1 << 20, 4, 1 << 26),
                                          (1 << 16, 2, 1 << 16)):
                args = (sched, world, M, payload, V, tp, tp_bytes)
                assert jpp.resolve_pp_schedule(*args) == \
                    tpp.resolve_pp_schedule(*args), args
                n += 1
    assert _counter("accl_sched_plan_total", op="pipeline") - before == n
    for mod in (jpp, tpp):
        with pytest.raises(ValueError, match="n_micro >= world"):
            mod.schedule_table(4, 2, 1)
    comm = at.Communicator(4, "cpu")
    with pytest.raises(ValueError, match="n_micro >= world"):
        tpp.build_pp_train_step(comm, 2, 8, schedule="1f1b")
    step = tpp.build_pp_train_step(comm, 2, 8, schedule=None)
    assert (step.schedule, step.decision_source) == ("gpipe", "degenerate")


# ---------------------------------------------------------------------------
# the relay
# ---------------------------------------------------------------------------

def _jax_relay(world, algo, f, b):
    comm = JComm(jax.devices()[:world])
    sh = comm.sharding(P(jpp.AXIS, None, None))
    prog = jalg.build_pipeline_relay(comm, algo)
    fo, bo = prog(jax.device_put(f, sh), jax.device_put(b, sh))
    return _np(fo), _np(bo)


def _relay(rng):
    for world, n, d in ((3, 5, 7), (8, 4, 8)):
        for dt in ("f32", "bf16", "i32"):
            if dt == "i32":
                f = rng.integers(-1000, 1000, (world, n, d)).astype(np.int32)
                b = rng.integers(-1000, 1000, (world, n, d)).astype(np.int32)
            else:
                f = rng.standard_normal((world, n, d)).astype(np.float32)
                b = rng.standard_normal((world, n, d)).astype(np.float32)
                f[0, 0, :2] = [np.nan, -0.0]
            jf_, jb_ = (a.astype(_JDT[dt]) for a in (f, b))
            want = _oracle(("relay", world, dt), lambda: _jax_relay(
                world, JAlgo.XLA, jf_, jb_))
            tf_, tb_ = (torch.from_numpy(a).to(_TDT[dt]) for a in (f, b))
            progs = {
                "pp_relay": lambda a, c: trelay.pp_relay(a, c),
                "device_api": lambda a, c: tdapi.pp_relay(a, c),
                "PALLAS": talg.build_pipeline_relay(
                    at.Communicator(world, "cpu"), at.Algorithm.PALLAS),
                "XLA": talg.build_pipeline_relay(
                    at.Communicator(world, "cpu"), at.Algorithm.XLA)}
            for name, prog in progs.items():
                got = prog(tf_, tb_)
                for g, w, ch in zip(got, want, "fb"):
                    g = g.float() if g.dtype == torch.bfloat16 else g
                    assert np.array_equal(g.numpy(), w, equal_nan=True), \
                        (world, dt, name, ch)
    # one relay through the JAX kernel in interpret mode
    f = rng.standard_normal((4, 4, 8)).astype(np.float32)
    b = rng.standard_normal((4, 4, 8)).astype(np.float32)
    assert jrelay.relay_engages(4, 8, np.float32, 4, overlap=True)
    want = _oracle("relay-pallas", lambda: _jax_relay(4, JAlgo.PALLAS, f, b))
    launches = trelay.relay.launches
    got = trelay.pp_relay(torch.from_numpy(f), torch.from_numpy(b), True)
    assert trelay.relay.launches == launches       # CPU: the plain version
    for g, w, ch in zip(got, want, "fb"):
        assert torch.equal(g, torch.from_numpy(np.array(w))), ("pallas", ch)
    # plain version: segment by segment, lanes apart
    x = torch.randn(3, 2, 5, 300, dtype=torch.float64)
    plan = trelay.pp_plan(5, 300, torch.float64, 3)
    y = trelay.pp_plan(5, 300, torch.float64, 3)
    fo, bo = trelay.plain_relay(x, x + 1, 2, 1024)
    assert plan == y and torch.equal(fo, torch.roll(x, 1, 0)) \
        and torch.equal(bo, torch.roll(x + 1, -1, 0)), "plain relay"
    _relay_vjp(rng)
    _relay_policy()


def _relay_vjp(rng):
    """Gradients through the relay equal jax.grad's through the JAX relay
    (its custom VJP, overlap=False)."""
    from accl_tpu.compat import shard_map
    W, n, d = 4, 4, 8
    f = rng.standard_normal((W, n, d)).astype(np.float32)
    b = rng.standard_normal((W, n, d)).astype(np.float32)

    def jax_grads():
        comm = JComm(jax.devices()[:W])
        sh = comm.sharding(P(jpp.AXIS, None, None))

        def loss(fl, bl):
            fo, bo = jrelay.pp_relay(fl[0], bl[0], jpp.AXIS, (jpp.AXIS,),
                                     False)
            return jnp.sum(fo * fo * fo) + jnp.sum(bo * bo * 2.0)

        prog = jax.jit(shard_map(
            lambda fl, bl: jax.grad(loss, argnums=(0, 1))(fl, bl),
            mesh=comm.mesh, in_specs=(P(jpp.AXIS), P(jpp.AXIS)),
            out_specs=(P(jpp.AXIS), P(jpp.AXIS)), check_vma=False))
        return [np.asarray(g) for g in prog(jax.device_put(f, sh),
                                            jax.device_put(b, sh))]

    want = _oracle("relay-vjp", jax_grads)
    for overlap in (None, False):
        tf_ = torch.from_numpy(f).requires_grad_()
        tb_ = torch.from_numpy(b).requires_grad_()
        fo, bo = trelay.pp_relay(tf_, tb_, overlap)
        (torch.sum(fo * fo * fo) + torch.sum(bo * bo * 2.0)).backward()
        for g, w, ch in zip((tf_.grad, tb_.grad), want, "fb"):
            assert torch.equal(g, torch.from_numpy(np.array(w))), \
                ("vjp", overlap, ch)


def _relay_policy():
    for n, d, P_ in ((512, 3072, 8), (4, 8, 4), (1, 1, 2), (3, 640, 3),
                     (1000, 1000, 2), (64, 256, 4), (4, 8, 1)):
        for jdt, tdt in ((np.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16),
                         (np.int8, torch.int8)):
            assert jrelay.pp_plan(n, d, jdt, P_) == \
                trelay.pp_plan(n, d, tdt, P_), (n, d, P_, tdt)
            for ov in (None, True, False):
                assert jrelay.relay_engage_reason(n, d, jdt, P_, ov) == \
                    trelay.relay_engage_reason(n, d, tdt, P_, ov), \
                    (n, d, P_, tdt, ov)
    plan = trelay.pp_plan(512, 3072, torch.float32, 8)
    assert (plan["C"], plan["sr"], plan["vmem_bytes"]) == (6, 2048, 8 << 20)
    x = torch.zeros(2, 4, 8)
    fused = _counter("accl_pp_relay_total", path="fused")
    rolled = _counter("accl_pp_relay_total", path="ppermute")
    declined = _counter("accl_cmatmul_fallback_total", op="pp_relay")
    trelay.pp_relay(x, x, True)
    trelay.pp_relay(x, x, False)
    trelay.pp_relay(x[:1], x[:1], True)            # one stage: geometry
    assert _counter("accl_pp_relay_total", path="fused") == fused + 1
    assert _counter("accl_pp_relay_total", path="ppermute") == rolled + 2
    assert _counter("accl_cmatmul_fallback_total", op="pp_relay",
                    reason="geometry") >= 1
    assert _counter("accl_cmatmul_fallback_total", op="pp_relay") == \
        declined + 1
    with pytest.raises(ValueError):
        trelay.pp_relay(x, x[:, :2])


# ---------------------------------------------------------------------------
# the simple steps
# ---------------------------------------------------------------------------

def _pp_io(world, M, n, d, rng):
    xm = rng.standard_normal((M, n, d)).astype(np.float32)
    ym = rng.standard_normal((M, n, d)).astype(np.float32)
    x = np.zeros((world, M, n, d), np.float32)
    y = np.zeros((world, M, n, d), np.float32)
    x[0], y[-1] = xm, ym
    return xm, ym, x, y


def _jax_simple(world, M, d, V, sched, gp, x, y):
    comm = JComm(jax.devices()[:world])
    step = jpp.build_pp_train_step(comm, M, d, lr=1e-2, schedule=sched,
                                   interleave=V, overlap=False)
    sh = comm.sharding(P(jpp.AXIS, None, None, None))
    p, loss = step(jpp.shard_stage_params(gp, comm), jax.device_put(x, sh),
                   jax.device_put(y, sh))
    return np.asarray(p.w), np.asarray(p.b), float(loss), step.stash_slots


SIMPLE = [(4, 4, 1, "1f1b"), (2, 4, 2, "1f1b"), (2, 4, 1, "gpipe")]


def _simple_steps(rng):
    d, n = 8, 3
    for world, M, V, sched in SIMPLE:
        case = (world, M, V, sched)
        # numpy weights (jax.random would compile per shape)
        gp = jpp.PPStageParams(
            jnp.asarray(rng.standard_normal((world, V, d, d)) / d ** 0.5,
                        jnp.float32),
            jnp.asarray(rng.standard_normal((world, V, d)) * 0.05,
                        jnp.float32))
        xm, ym, x, y = _pp_io(world, M, n, d, rng)
        jw, jb, jloss, jslots = _oracle(
            ("simple",) + case,
            lambda: _jax_simple(world, M, d, V, sched, gp, x, y))
        ref = jpp.reference_train_loss(
            jpp.PPStageParams(np.asarray(gp.w), np.asarray(gp.b)), xm, ym)
        comm = at.Communicator(world, "cpu")
        tp_ = tpp.params_from_jax(gp, comm)
        step = tpp.build_pp_train_step(comm, M, d, lr=1e-2, schedule=sched,
                                       interleave=V)
        assert step.schedule == sched, case
        assert step.stash_slots == jslots, case
        if sched == "1f1b":
            assert step.stash_slots <= (world if V == 1 else 2 * world * V)
        new, loss = step(tp_, _t(x), _t(y))
        assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss), (case, "loss")
        assert abs(loss.item() - ref) <= 1e-5 * abs(ref), (case, "f64")
        assert abs(tpp.reference_train_loss(tp_, xm, ym) - ref) <= \
            1e-12 * abs(ref), case
        _close(f"{case} w", new.w, jw)
        _close(f"{case} b", new.b, jb)
        if sched == "1f1b":
            # the roll arm runs the same math: bit-equal
            base = tpp.build_pp_train_step(comm, M, d, lr=1e-2,
                                           schedule=sched, interleave=V,
                                           overlap=False)
            bnew, bloss = base(tp_, _t(x), _t(y))
            assert torch.equal(bloss, loss) and torch.equal(bnew.w, new.w) \
                and torch.equal(bnew.b, new.b), (case, "overlap=False")
    # the GPipe demo forward against its float64 reference
    world, M, n, d = 3, 4, 2, 8
    comm = at.Communicator(world, "cpu")
    g = torch.Generator().manual_seed(0)
    sp = tpp.init_params(g, comm, d)
    sp = sp._replace(b=torch.randn(sp.b.shape, generator=g) * 0.1)
    x = torch.zeros(world, M, n, d)
    x[0] = torch.randn(M, n, d, generator=g)
    out = tpp.build_pipeline_forward(comm, M)(sp, x)
    _close("gpipe forward", out[world - 1],
           tpp.reference_pipeline(sp, x[0].numpy()))
    assert not out[:world - 1].any(), "gpipe forward: other rows"


# ---------------------------------------------------------------------------
# the composed step
# ---------------------------------------------------------------------------

D, H, HEADS, M_C, B_C = 8, 16, 2, 4, 4


def _jax_composed(ppsz, dp, tp, sched, params, x, y):
    mesh = jpp.make_pp_mesh(jax.devices()[:ppsz * dp * tp], ppsz, dp, tp)
    params = jpp.PPTransformerParams(*(
        jax.device_put(a, NamedSharding(mesh, spec))
        for a, spec in zip(params, jpp.pp_transformer_specs())))
    sh = NamedSharding(mesh, P(None, "dp", None))
    step = jpp.build_pp_transformer_train_step(
        mesh, D, H, HEADS, M_C, lr=1e-2, schedule=sched, overlap=False)
    new, loss = step(params, jax.device_put(x, sh), jax.device_put(y, sh))
    return [np.asarray(a) for a in new], float(loss), step.stash_slots


def _transformer_weights(rng, ppsz, tp):
    """Global per-stage weights in the JAX layout, from numpy (the JAX
    package's init draws through jax.random, which compiles per shape)."""
    return (
        (rng.standard_normal((ppsz, tp, 4 * D * D // tp)) * D ** -0.5)
        .astype(np.float32),
        (rng.standard_normal((ppsz, H, D)) * (2.0 / D) ** 0.5)
        .astype(np.float32),
        (rng.standard_normal((ppsz, D, H)) * (2.0 / H) ** 0.5)
        .astype(np.float32))


def _composed(rng, monkeypatch):
    for ppsz, dp, tp in ((2, 2, 1), (2, 1, 2)):
        B = dp * B_C
        x = (rng.standard_normal((M_C, B, D)) * .3).astype(np.float32)
        y = (rng.standard_normal((M_C, B, D)) * .3).astype(np.float32)
        mesh = tpp.make_pp_mesh("cpu", ppsz, dp, tp)
        jp = _transformer_weights(rng, ppsz, tp)
        params = tpp.params_from_jax(tpp.PPTransformerParams(*jp), mesh)
        for sched in ("1f1b", "gpipe"):
            case = (ppsz, dp, tp, sched)
            jnew, jloss, jslots = _oracle(
                ("composed",) + case,
                lambda: _jax_composed(ppsz, dp, tp, sched, jp, x, y))
            step = tpp.build_pp_transformer_train_step(
                mesh, D, H, HEADS, M_C, lr=1e-2, schedule=sched,
                overlap=False)
            new, loss = step(params, _t(x), _t(y))
            assert (step.schedule, step.engage_reason) == (sched, "off")
            assert step.stash_slots == jslots, case
            assert sched == "gpipe" or jslots <= ppsz, case
            assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss), case
            want = tpp.params_from_jax(tpp.PPTransformerParams(*jnew), mesh)
            for f, a, b in zip(want._fields, new, want):
                _close(f"{case} {f}", a, b)
            if dp > 1:
                _engaged_arm(mesh, params, _t(x), _t(y), sched, new, loss)
    _demotion(monkeypatch)


def _engaged_arm(mesh, params, x, y, sched, flat, flat_loss):
    """The fused datapath (the port's plain kernels here) against the flat
    one: the same math in another order."""
    before = {k: v.launches for k, v in (("agmm", tcm.agmm),
                                         ("mmrs", tcm.mmrs),
                                         ("wgrad", tcm.wgrad))}
    step = tpp.build_pp_transformer_train_step(
        mesh, D, H, HEADS, M_C, lr=1e-2, schedule=sched, overlap=True,
        wire_dtype="off")
    new, loss = step(params, x, y)
    assert step.fused and step.engage_reason is None, sched
    assert step.schedule == sched, sched
    assert abs(loss.item() - flat_loss.item()) <= 1e-5 * abs(flat_loss), \
        sched
    for f, a, b in zip(new._fields, new, flat):
        _close(f"fused {sched} {f}", a, b)
    # CPU tensors: the wrappers ran their plain versions, no launch
    assert before == {"agmm": tcm.agmm.launches, "mmrs": tcm.mmrs.launches,
                      "wgrad": tcm.wgrad.launches}


def _demotion(monkeypatch):
    """A declining per-stage plan demotes the whole step to GPipe + flat,
    counted under op="pp_pipeline"; the reason is the JAX package's."""
    from accl_tpu.ops import collective_matmul as jcm
    for mod in (tcm, jcm, trelay, jrelay):
        monkeypatch.setattr(mod, "_OVERLAP_DEFAULT", True)
    monkeypatch.setattr(tcm, "_AG_THRESHOLD", 256 << 10)
    monkeypatch.setattr(tcm, "_RS_THRESHOLD", 256 << 10)
    mesh = tpp.make_pp_mesh("cpu", 2, 2, 1)
    g = torch.Generator().manual_seed(3)
    params = tpp.init_pp_transformer(g, mesh, D, H, HEADS)
    x = torch.randn(M_C, 2 * B_C, D, generator=g) * .3
    before = _counter("accl_cmatmul_fallback_total", op="pp_pipeline",
                      reason="threshold")
    step = tpp.build_pp_transformer_train_step(mesh, D, H, HEADS, M_C,
                                               schedule="1f1b")
    step(params, x, x)
    assert (step.schedule, step.fused, step.engage_reason,
            step.decision_source) == ("gpipe", False, "threshold",
                                      "fallback")
    assert _counter("accl_cmatmul_fallback_total", op="pp_pipeline",
                    reason="threshold") == before + 1
    monkeypatch.setattr(jcm, "_AG_THRESHOLD", 256 << 10)
    monkeypatch.setattr(jcm, "_RS_THRESHOLD", 256 << 10)
    assert jpp.pp_transformer_engage_reason(D, H, B_C, 2, 2, 1) == \
        tpp.pp_transformer_engage_reason(D, H, B_C, 2, 2, 1) == "threshold"
    monkeypatch.setattr(jcm, "_AG_THRESHOLD", 0)
    monkeypatch.setattr(jcm, "_RS_THRESHOLD", 0)
    monkeypatch.setattr(tcm, "_AG_THRESHOLD", 0)
    monkeypatch.setattr(tcm, "_RS_THRESHOLD", 0)
    for geo in ((3072, 12288, 512, 4, 2, 1), (3072, 12288, 512, 2, 4, 1),
                (3072, 12288, 512, 8, 1, 1), (D, H, B_C, 1, 2, 1)):
        assert jpp.pp_transformer_engage_reason(*geo) == \
            tpp.pp_transformer_engage_reason(*geo), geo


# ---------------------------------------------------------------------------
# the config write-through
# ---------------------------------------------------------------------------

def _config_write_through(accl):
    """A bad pipeline register raises in both packages and the port keeps
    its config (the JAX setter stores first: ROADMAP.md section 3); good
    values reach the registers."""
    tacc = at.ACCL(world=2, device="cpu")
    good_t, good_j = tacc.config, accl.config
    for field, bad in (("pp_schedule", "bogus"), ("pp_interleave", 0)):
        for acc, good in ((tacc, good_t), (accl, good_j)):
            with pytest.raises(ValueError, match=field):
                acc.config = good.replace(**{field: bad})
        assert tacc.config is good_t, field
        accl.config = good_j
    for acc, good in ((tacc, good_t), (accl, good_j)):
        acc.config = good.replace(pp_schedule="gpipe", pp_interleave=2,
                                  pp_overlap=False)
    for mod, rel in ((tpp, trelay), (jpp, jrelay)):
        assert (mod.get_schedule(), mod.get_interleave(),
                rel.get_overlap_enabled()) == ("gpipe", 2, False), mod
    assert tpp._COST_CFG is tacc.config
    tacc.config = good_t
    accl.config = good_j
    assert (tpp.get_schedule(), tpp.get_interleave(),
            trelay.get_overlap_enabled()) == ("auto", 1, True)
    tacc.deinit()


def test_pipeline_matches_jax(accl, monkeypatch):
    rng = np.random.default_rng(13)
    _schedules(monkeypatch)
    _relay(rng)
    _simple_steps(rng)
    _composed(rng, monkeypatch)
    _config_write_through(accl)
    assert trelay.relay.launches == 0
