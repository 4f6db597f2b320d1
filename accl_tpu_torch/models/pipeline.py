"""Pipeline parallelism (pp): 1F1B scheduling over the relay kernel, composed
with the fused tp/dp datapaths (counterpart: ``accl_tpu/models/pipeline.py``).

Every stage is a row of leading axes on one device: a (world, ...) tensor
for the simple stage family, (pp, dp, tp, ...) for the composed step, rank
``(p * dp + i) * tp + j`` at ``[p, i, j]``. Two generations, as in the JAX
package:

* the **GPipe** demo (:func:`build_pipeline_forward`) and train step
  (:func:`build_gpipe_train_step`): all M forwards, then autograd through
  the whole forward sweep. Bubble ranks are skipped, never run on zeros. It
  is the parity oracle and the committed fallback of the composed step;
* the **1F1B** step (:func:`build_pp_train_step`): the host-side lockstep
  simulator :func:`schedule_table` emits per-tick work tables and the step
  walks them tick by tick. A tick runs the forward work of every rank that
  has some as one batched call of the stage, then the backward work
  (recomputed from the stashed input) as another, then one relay of all
  ranks' payloads, both channels (:func:`..ops.pipeline_relay.pp_relay`:
  the relay kernel when its plan engages, the counted roll pair
  otherwise). The stash holds ``tab.stash_slots`` inputs per rank, never
  M.

**Composition** (:func:`build_pp_transformer_train_step`): one transformer
block per stage (:mod:`.zero`'s block bodies: flash attention, the MLP on
the all-gather x matmul over dp with ZeRO travel-layout shards, the bucket-
gathered attention), scheduled 1F1B along pp. The fused datapath runs only
when every per-stage plan engages (:func:`pp_transformer_engage_reason`);
a decline other than a requested ``overlap=False`` demotes the whole step
to GPipe with the flat datapath, counted under
``accl_cmatmul_fallback_total{op="pp_pipeline"}``. ``pp_schedule="auto"``
arbitrates through the α-β cost model (:func:`resolve_pp_schedule`),
counted under ``accl_sched_plan_total{op="pipeline"}``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..communicator import Communicator
from ..obs import metrics as _metrics

PP_AXIS = "pp"

#: the fallback-counter op label of the composed step's committed baseline
#: (accl_cmatmul_fallback_total{op="pp_pipeline"})
PP_STEP_OP = "pp_pipeline"


# ---------------------------------------------------------------------------
# session registers (ACCLConfig.pp_schedule / pp_interleave write-through);
# per-call override on every builder. The relay's pp_overlap register lives
# with its kernel (ops/pipeline_relay.py).
# ---------------------------------------------------------------------------

_SCHEDULE_DEFAULT = "auto"
_INTERLEAVE_DEFAULT = 1
_COST_CFG = None  # ACCLConfig the "auto" arbiter prices with (None=defaults)


def set_schedule(schedule: str) -> None:
    """Module-default schedule (``ACCLConfig.pp_schedule`` lands here on
    every config assignment): "auto" (cost-model arbitration), "1f1b", or
    "gpipe". Per-call override: the builders' ``schedule`` argument."""
    if schedule not in ("auto", "1f1b", "gpipe"):
        raise ValueError(f"pp_schedule must be auto|1f1b|gpipe, "
                         f"got {schedule!r}")
    global _SCHEDULE_DEFAULT
    _SCHEDULE_DEFAULT = schedule


def get_schedule() -> str:
    return _SCHEDULE_DEFAULT


def set_interleave(v: int) -> None:
    """Module-default virtual-stage count (``ACCLConfig.pp_interleave``
    write-through)."""
    if int(v) < 1:
        raise ValueError(f"pp_interleave must be >= 1, got {v}")
    global _INTERLEAVE_DEFAULT
    _INTERLEAVE_DEFAULT = int(v)


def get_interleave() -> int:
    return _INTERLEAVE_DEFAULT


def set_cost_config(cfg) -> None:
    """Give the "auto" arbiter the session's cost registers (α/β); ACCL's
    config write-through calls this with every assignment."""
    global _COST_CFG
    _COST_CFG = cfg


# ===========================================================================
# the 1F1B schedule table: a host-side lockstep simulator
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class PPSchedule:
    """Static per-tick work tables, each (steps, world) int32 with -1 for
    "none". At tick ``t`` rank ``r``:

    * banks the forward payload that arrived on the wire into activation
      stash slot ``arr_f_slot[t, r]`` and the gradient payload into
      grad-landing slot ``arr_b_slot[t, r]``;
    * forwards microbatch ``f_mb[t, r]`` of virtual chunk ``f_chunk``,
      stashing its input at ``f_slot`` (injections at stage 0 allocate it
      here); the last stage also writes the loss gradient into
      ``dy_slot``;
    * backwards ``b_mb``/``b_chunk``, consuming activation slot ``b_slot``
      and gradient slot ``b_in_slot`` (both freed).

    ``stash_slots`` bounds the live activations per rank: ``world`` for the
    plain schedule, ``world`` per virtual chunk when interleaved.
    ``max_live`` is the simulator's measured high-water mark."""

    world: int
    n_micro: int
    interleave: int
    steps: int
    stash_slots: int
    grad_slots: int
    f_mb: np.ndarray
    f_chunk: np.ndarray
    f_slot: np.ndarray
    dy_slot: np.ndarray
    b_mb: np.ndarray
    b_chunk: np.ndarray
    b_slot: np.ndarray
    b_in_slot: np.ndarray
    arr_f_slot: np.ndarray
    arr_b_slot: np.ndarray
    max_live: int

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the schedule: every rank does ``2*M*V`` work
        units in ``steps`` lockstep ticks."""
        busy = 2 * self.n_micro * self.interleave
        return 1.0 - busy / self.steps


def gpipe_bubble_fraction(world: int, n_micro: int,
                          interleave: int = 1) -> float:
    """The GPipe baseline's bubble fraction at the same geometry: each phase
    is ``M + N - 1`` ticks for ``M`` busy ones (N = world * interleave
    stages)."""
    N = world * interleave
    return 1.0 - n_micro / (n_micro + N - 1)


def validate_pp_geometry(world: int, n_micro: int,
                         interleave: int = 1) -> None:
    """The 1F1B schedule needs at least ``world`` microbatches: with ``M <
    world`` some stages never reach steady state. Fail loud."""
    if n_micro < world:
        raise ValueError(
            f"1F1B needs n_micro >= world: got n_micro={n_micro} for "
            f"world={world}. Use more microbatches or "
            f"schedule=\"gpipe\" (the baseline handles any M >= 1).")
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")


@functools.lru_cache(maxsize=64)
def schedule_table(world: int, n_micro: int,
                   interleave: int = 1) -> PPSchedule:
    """Simulate the 1F1B lockstep schedule and emit its static tables
    (memoized per geometry; callers must not mutate the arrays).

    Rank-local policy per tick (PipeDream-flush): backward first whenever
    one is ready, else the lowest (microbatch, chunk) forward whose input
    has arrived, with stage-0 injections gated on the global in-flight count
    staying <= ``world`` (that gate is the O(world) activation bound).
    Payloads relay one ring hop per tick (+1 forward, -1 backward) and land
    the next tick. Raises on ``M < world``."""
    validate_pp_geometry(world, n_micro, interleave)
    S, V, M = world, interleave, n_micro
    N = S * V
    # simulate with a buffer that cannot overflow (total in-flight <= M*V)
    # and size the stash to the measured high-water mark afterwards: the
    # lowest-free allocation keeps every index below the occupancy peak
    sim_slots = M * V
    free_act = [list(range(sim_slots)) for _ in range(S)]
    free_inb = [list(range(sim_slots)) for _ in range(S)]
    act_slot_of = [dict() for _ in range(S)]   # (m, c) -> stash slot
    inb_slot_of = [dict() for _ in range(S)]   # (m, c) -> grad slot
    ready_f = [[] for _ in range(S)]           # (m, c) input present
    ready_b = [[] for _ in range(S)]           # [(ready_tick, m, c)]
    arrivals: list = []                        # (tick, kind, rank, m, c)
    for m in range(M):
        ready_f[0].append((m, 0))
    injected = drained = 0
    done_b = 0
    max_live = max_live_inb = 0
    rows: list = []
    hard_cap = 6 * (M * V + N) + 32
    t = 0
    while done_b < M * N:
        if t >= hard_cap:
            raise RuntimeError(
                f"1F1B simulator did not converge (world={S}, M={M}, "
                f"V={V}): internal scheduling bug")
        row = {k: [-1] * S for k in
               ("f_mb", "f_chunk", "f_slot", "dy_slot", "b_mb",
                "b_chunk", "b_slot", "b_in_slot", "arr_f_slot",
                "arr_b_slot")}
        # 1) land this tick's wire arrivals (at most one per direction per
        #    rank: each neighbour produced at most one payload)
        frees: list = []
        for ev in [e for e in arrivals if e[0] == t]:
            _, kind, r, m, c = ev
            if kind == "f":
                if not free_act[r]:
                    raise RuntimeError("activation stash overflow: "
                                       "injection gate bug")
                s = free_act[r].pop(0)
                act_slot_of[r][(m, c)] = s
                row["arr_f_slot"][r] = s
                ready_f[r].append((m, c))
            else:
                if not free_inb[r]:
                    raise RuntimeError("gradient landing overflow")
                s = free_inb[r].pop(0)
                inb_slot_of[r][(m, c)] = s
                row["arr_b_slot"][r] = s
                ready_b[r].append((t, m, c))
        arrivals = [e for e in arrivals if e[0] > t]

        # 2) one work unit per rank: backward first (1F1B), else the
        #    lowest-(mb, chunk) available forward
        for r in range(S):
            bs = sorted((e for e in ready_b[r] if e[0] <= t),
                        key=lambda e: (e[1], e[2]))
            if bs:
                _, m, c = bs[0]
                ready_b[r].remove(next(e for e in ready_b[r]
                                       if e[1:] == (m, c)))
                sig = c * S + r
                a_slot = act_slot_of[r].pop((m, c))
                g_slot = inb_slot_of[r].pop((m, c))
                row["b_mb"][r], row["b_chunk"][r] = m, c
                row["b_slot"][r], row["b_in_slot"][r] = a_slot, g_slot
                frees.append((free_act[r], a_slot))
                frees.append((free_inb[r], g_slot))
                if sig > 0:
                    pr, pc = (r - 1, c) if r > 0 else (S - 1, c - 1)
                    arrivals.append((t + 1, "b", pr, m, pc))
                else:
                    drained += 1
                done_b += 1
                continue
            fs = sorted(ready_f[r])
            for m, c in fs:
                sig = c * S + r
                if sig == 0:
                    # injection allocates a stash slot: gate on the global
                    # in-flight bound
                    if injected - drained >= N or not free_act[r]:
                        continue
                    s = free_act[r].pop(0)
                    act_slot_of[r][(m, c)] = s
                    injected += 1
                else:
                    s = act_slot_of[r][(m, c)]
                ready_f[r].remove((m, c))
                row["f_mb"][r], row["f_chunk"][r] = m, c
                row["f_slot"][r] = s
                if sig == N - 1:
                    # the last stage turns the microbatch around: the loss
                    # gradient lands locally like a wire arrival
                    if not free_inb[r]:
                        raise RuntimeError("gradient landing overflow")
                    g = free_inb[r].pop(0)
                    inb_slot_of[r][(m, c)] = g
                    row["dy_slot"][r] = g
                    ready_b[r].append((t + 1, m, c))
                else:
                    nr, nc = (r + 1, c) if r < S - 1 else (0, c + 1)
                    arrivals.append((t + 1, "f", nr, m, nc))
                break
        # 3) the within-tick occupancy peak (before frees land), then
        #    release: a slot freed by B is reusable by the next tick
        max_live = max(max_live,
                       *(sim_slots - len(free_act[r]) for r in range(S)))
        max_live_inb = max(max_live_inb,
                           *(sim_slots - len(free_inb[r])
                             for r in range(S)))
        for lst, s in frees:
            lst.append(s)
            lst.sort()
        rows.append(row)
        t += 1

    T = len(rows)
    tab = {k: np.array([row[k] for row in rows], np.int32)
           for k in rows[0]}
    slots = max(max_live, 1)
    if V == 1:
        # the 1F1B memory claim: the stash is (world, ...) slots, never M
        assert slots <= S, (slots, S)
    return PPSchedule(world=S, n_micro=M, interleave=V, steps=T,
                      stash_slots=slots, grad_slots=max(max_live_inb, 1),
                      max_live=max_live,
                      f_mb=tab["f_mb"], f_chunk=tab["f_chunk"],
                      f_slot=tab["f_slot"], dy_slot=tab["dy_slot"],
                      b_mb=tab["b_mb"], b_chunk=tab["b_chunk"],
                      b_slot=tab["b_slot"], b_in_slot=tab["b_in_slot"],
                      arr_f_slot=tab["arr_f_slot"],
                      arr_b_slot=tab["arr_b_slot"])


# ---------------------------------------------------------------------------
# schedule arbitration: the α-β cost model prices pp against GPipe
# ---------------------------------------------------------------------------


def resolve_pp_schedule(schedule: Optional[str], world: int, n_micro: int,
                        payload_bytes: int, interleave: int = 1,
                        tp: int = 1, tp_bytes: int = 0,
                        transport: str = "ici") -> Tuple[str, str]:
    """The schedule decision for one pipeline build: ``(schedule,
    source)`` with source in {"register", "cost_model", "degenerate"},
    counted under ``accl_sched_plan_total{op="pipeline"}``.

    ``schedule=None`` follows the session ``ACCLConfig.pp_schedule``; an
    explicit "1f1b"/"gpipe" pins the decision (source "register"). "auto"
    prices per-tick link occupancy, the relay and the stage's tp collective
    jointly (:func:`..parallel.synth.link_cost_us`): a 1F1B tick pays
    ``max(relay, tp)``, a GPipe tick their sum, times each schedule's tick
    count. ``M < world`` resolves "gpipe" with source "degenerate"."""
    req = schedule if schedule is not None else _SCHEDULE_DEFAULT
    if req not in ("auto", "1f1b", "gpipe"):
        raise ValueError(
            f"schedule must be auto|1f1b|gpipe, got {req!r}")
    if req in ("1f1b", "gpipe"):
        decision, source = req, "register"
    elif n_micro < world:
        decision, source = "gpipe", "degenerate"
    else:
        from ..parallel import synth
        cfg = _COST_CFG
        if cfg is None:
            from ..config import ACCLConfig
            cfg = ACCLConfig()
        # one fused 1F1B tick moves a full payload in each direction of the
        # link at once, so its wire time is one direction's full-payload
        # time; a GPipe tick moves one payload on one direction
        relay_us = synth.link_cost_us(cfg, transport, payload_bytes)
        tp_us = (synth.link_cost_us(cfg, transport, tp_bytes,
                                    hops=max(tp - 1, 1))
                 if tp > 1 and tp_bytes else 0.0)
        N = world * interleave
        t_1f1b = schedule_table(world, n_micro, interleave).steps \
            * max(relay_us, tp_us)
        t_gpipe = 2 * (n_micro + N - 1) * (relay_us + tp_us)
        decision = "1f1b" if t_1f1b <= t_gpipe else "gpipe"
        source = "cost_model"
    _metrics.inc("accl_sched_plan_total",
                 labels=(("op", "pipeline"), ("shape", decision),
                         ("source", source)))
    return decision, source


# ---------------------------------------------------------------------------
# row selection: a tick's active ranks as a strided view where they form
# one (no copy), else an index tensor
# ---------------------------------------------------------------------------


def _rows(ranks, device, cache: dict):
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) == 1:
        return slice(ranks[0], ranks[0] + 1)
    step = ranks[1] - ranks[0]
    if step > 0 and all(b - a == step for a, b in zip(ranks, ranks[1:])):
        return slice(ranks[0], ranks[-1] + 1, step)
    key = (ranks, str(device))
    if key not in cache:
        cache[key] = torch.tensor(ranks, dtype=torch.long, device=device)
    return cache[key]


def _index(values, device, cache: dict) -> torch.Tensor:
    key = (tuple(int(v) for v in values), str(device))
    if key not in cache:
        cache[key] = torch.tensor(key[0], dtype=torch.long, device=device)
    return cache[key]


def _active(row: np.ndarray):
    """The ranks of one table row that have work (entry >= 0)."""
    return [int(r) for r in np.nonzero(row >= 0)[0]]


# ===========================================================================
# the GPipe demo (kept: parity oracle)
# ===========================================================================


class StageParams(NamedTuple):
    w: torch.Tensor  # (world, d, d), stage r's weights at row r
    b: torch.Tensor  # (world, d)


def init_params(gen: torch.Generator, comm: Communicator,
                d_model: int) -> StageParams:
    """Random stage weights from ``gen`` on the communicator's device,
    scaled as the JAX package scales them (zero biases)."""
    dev = comm.device
    return StageParams(
        w=torch.randn((comm.world_size, d_model, d_model), generator=gen,
                      device=dev) * (1.0 / d_model) ** 0.5,
        b=torch.zeros((comm.world_size, d_model), device=dev))


def _stage(w, b, h):
    """relu(h @ w + b), batched over leading axes."""
    return torch.relu(torch.matmul(h, w) + b.unsqueeze(-2))


def build_pipeline_forward(comm: Communicator, n_micro: int) -> Callable:
    """The GPipe forward over the communicator's ranks as stages: ``fwd(
    params, x)`` with x (world, M, n, d), rank 0's row carrying the
    microbatches (the other rows ignored); returns (world, M, n, d) with the
    results in rank world-1's row, the other rows zero. Bubble steps skip
    the stage compute; activations hop one rank per step."""
    world = comm.world_size
    steps = n_micro + world - 1

    def fwd(params: StageParams, x: torch.Tensor) -> torch.Tensor:
        M = x.shape[1]
        if M != n_micro:
            raise ValueError(
                f"input has {M} microbatches but the pipeline was compiled "
                f"for n_micro={n_micro}")
        n, d = x.shape[2:]
        out = torch.zeros_like(x)
        h = torch.zeros((world, n, d), dtype=x.dtype, device=x.device)
        cache: dict = {}
        for s in range(steps):
            if s < M:
                h[0] = x[0, s]
            else:
                h[0] = 0
            live = [r for r in range(world) if 0 <= s - r < M]
            y = torch.zeros_like(h)
            sel = _rows(live, x.device, cache)
            y[sel] = _stage(params.w[sel], params.b[sel], h[sel])
            if world - 1 in live:
                out[world - 1, s - (world - 1)] = y[world - 1]
            h = torch.roll(y, 1, 0)
        return out

    return fwd


def reference_pipeline(params: StageParams, x: np.ndarray) -> np.ndarray:
    """Host reference: the stages applied in order to each microbatch, in
    float64."""
    w, b = _f64(params.w), _f64(params.b)
    h = np.asarray(x, np.float64)                  # (M, n, d)
    for s in range(w.shape[0]):
        h = np.maximum(h @ w[s] + b[s], 0.0)
    return h


def _f64(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.detach().cpu().double().numpy()
    return np.asarray(t, np.float64)


# ===========================================================================
# stage parameters for the train steps (V virtual chunks per rank)
# ===========================================================================


class PPStageParams(NamedTuple):
    """Per-rank virtual-chunk stacks: rank r owns stages r, r+S, ...
    (chunk-major stage order sigma = chunk * world + rank)."""

    w: torch.Tensor  # (world, V, d, d)
    b: torch.Tensor  # (world, V, d)


def init_stage_params(gen: torch.Generator, comm: Communicator,
                      d_model: int, interleave: int = 1) -> PPStageParams:
    dev = comm.device
    return PPStageParams(
        w=torch.randn((comm.world_size, interleave, d_model, d_model),
                      generator=gen, device=dev) * (1.0 / d_model) ** 0.5,
        b=torch.zeros((comm.world_size, interleave, d_model), device=dev))


def reference_train_loss(params: PPStageParams, x: np.ndarray,
                         y: np.ndarray) -> float:
    """Host oracle for one train-step loss in float64: stages applied in
    chunk-major order (sigma = c*S + r), the mean over microbatches of the
    per-microbatch MSE."""
    w, b = _f64(params.w), _f64(params.b)  # (S, V, d, d)
    S, V = w.shape[0], w.shape[1]
    h = np.asarray(x, np.float64)          # (M, n, d)
    for c in range(V):
        for r in range(S):
            h = np.maximum(h @ w[r, c] + b[r, c], 0.0)
    return float(np.mean((h - np.asarray(y, np.float64)) ** 2))


# ---------------------------------------------------------------------------
# the slot discipline of the 1F1B walks: one copy shared by the simple and
# composed steps
# ---------------------------------------------------------------------------


def _slot_update(buf, val, ranks, slots, cache: dict) -> None:
    """``buf[r, slot] = val[k]`` for each (r, slot) of ``ranks``/``slots``
    (in place; the port's stash buffers are mutable)."""
    if ranks:
        dev = buf.device
        buf[_index(ranks, dev, cache), _index(slots, dev, cache)] = val


def _slot_read(buf, ranks, slots, cache: dict):
    """``stack(buf[r, slot])`` over ``ranks``/``slots`` (a copy)."""
    dev = buf.device
    return buf[_index(ranks, dev, cache), _index(slots, dev, cache)]


def _land(buf, wire, slot_row, cache: dict) -> None:
    """Bank this tick's wire arrivals into their slots."""
    ranks = _active(slot_row)
    if ranks:
        _slot_update(buf, wire[_rows(ranks, buf.device, cache)], ranks,
                     [slot_row[r] for r in ranks], cache)


# ===========================================================================
# the 1F1B train step (the simple stage family)
# ===========================================================================


def build_pp_train_step(comm: Communicator, n_micro: int, d_model: int,
                        lr: float = 1e-2, *,
                        schedule: Optional[str] = None,
                        interleave: Optional[int] = None,
                        overlap: Optional[bool] = None) -> Callable:
    """``step(params, x, y) -> (params, loss)``: one pipeline train step
    over the communicator's ranks as stages.

    ``x``/``y``: (world, M, n, d); rank 0's row carries the microbatches,
    rank world-1's the targets (other rows ignored). ``params``:
    :class:`PPStageParams`. Loss = mean over microbatches of the
    per-microbatch MSE; SGD update.

    ``schedule=None`` follows ``ACCLConfig.pp_schedule`` (through
    :func:`resolve_pp_schedule` when "auto"); "1f1b" requires ``n_micro >=
    world``. The 1F1B arm walks the schedule table with the per-tick relay
    on :func:`..ops.pipeline_relay.pp_relay` (``overlap`` as there) and a
    manual backward recomputed from the stash; "gpipe" builds
    :func:`build_gpipe_train_step`. The step carries ``.schedule``,
    ``.decision_source``, ``.table`` (None for gpipe) and
    ``.stash_slots``."""
    world = comm.world_size
    V = _INTERLEAVE_DEFAULT if interleave is None else int(interleave)
    decision, source = resolve_pp_schedule(
        schedule, world, n_micro, payload_bytes=4 * d_model,
        interleave=V)
    if decision == "gpipe":
        step = build_gpipe_train_step(comm, n_micro, d_model, lr,
                                      interleave=V)
        step.schedule, step.decision_source = "gpipe", source
        step.table, step.stash_slots = None, n_micro
        return step
    validate_pp_geometry(world, n_micro, V)
    tab = schedule_table(world, n_micro, V)
    M = n_micro

    from ..ops import pipeline_relay as _relay

    def step(params: PPStageParams, x: torch.Tensor, y: torch.Tensor):
        w, bb = params.w, params.b               # (S, V, d, d), (S, V, d)
        _, _, n, d = x.shape
        dev, dtype = x.device, x.dtype
        cache: dict = {}
        acts = torch.zeros((world, tab.stash_slots, n, d), dtype=dtype,
                           device=dev)           # the stash: O(world)
        inb = torch.zeros((world, tab.grad_slots, n, d), dtype=dtype,
                          device=dev)
        f_wire = torch.zeros((world, n, d), dtype=dtype, device=dev)
        b_wire = torch.zeros_like(f_wire)
        gw = torch.zeros(w.shape, dtype=torch.float32, device=dev)
        gb = torch.zeros(bb.shape, dtype=torch.float32, device=dev)
        loss_vec = torch.zeros((world, M), dtype=torch.float32, device=dev)
        for t in range(tab.steps):
            # 1) land the payloads relayed in during the previous tick
            _land(acts, f_wire, tab.arr_f_slot[t], cache)
            _land(inb, b_wire, tab.arr_b_slot[t], cache)
            f_send = torch.zeros_like(f_wire)
            b_send = torch.zeros_like(b_wire)

            # 2) forward work of every rank that has some, one batched call
            #    (bubble ranks are skipped)
            rf = _active(tab.f_mb[t])
            if rf:
                mbs = [int(tab.f_mb[t, r]) for r in rf]
                chunks = [int(tab.f_chunk[t, r]) for r in rf]
                slots = [int(tab.f_slot[t, r]) for r in rf]
                h_in = _slot_read(acts, rf, slots, cache)
                if rf[0] == 0 and chunks[0] == 0:
                    h_in[0] = x[0, mbs[0]]       # stage 0 injects
                _slot_update(acts, h_in, rf, slots, cache)
                ci = _index(chunks, dev, cache)
                ri = _index(rf, dev, cache)
                h_out = _stage(w[ri, ci], bb[ri, ci], h_in)
                send = []
                for k, r in enumerate(rf):
                    ds = int(tab.dy_slot[t, r])
                    if ds < 0:
                        send.append(k)
                        continue
                    # the last stage banks the loss and turns the gradient
                    diff = (h_out[k] - y[r, mbs[k]]).float()
                    loss_vec[r, mbs[k]] = torch.mean(diff * diff)
                    inb[r, ds] = ((2.0 / (n * d * M)) * diff).to(dtype)
                if send:
                    f_send[_index([rf[k] for k in send], dev, cache)] = \
                        h_out[_index(send, dev, cache)]

            # 3) backward work, recomputed from the stashed input
            rb = _active(tab.b_mb[t])
            if rb:
                chunks = [int(tab.b_chunk[t, r]) for r in rb]
                h_in = _slot_read(acts, rb, [tab.b_slot[t, r] for r in rb],
                                  cache)
                dy = _slot_read(inb, rb, [tab.b_in_slot[t, r] for r in rb],
                                cache).float()
                ri, ci = _index(rb, dev, cache), _index(chunks, dev, cache)
                wc, bc = w[ri, ci], bb[ri, ci]
                pre = torch.matmul(h_in, wc) + bc.unsqueeze(-2)
                dpre = dy * (pre > 0)
                gw[ri, ci] += torch.matmul(h_in.float().transpose(-2, -1),
                                           dpre)
                gb[ri, ci] += dpre.sum(-2)
                dh = torch.matmul(dpre, wc.transpose(-2, -1))
                if rb[0] == 0 and chunks[0] == 0:
                    dh[0] = 0                    # nothing before stage 0
                b_send[ri] = dh.to(dtype)

            # 4) the relay: every rank's forward activation and gradient in
            #    one launch (roll pair when the plan declines)
            f_wire, b_wire = _relay.pp_relay(f_send, b_send, overlap)
        loss = loss_vec.sum() / M
        return PPStageParams(w - lr * gw.to(w.dtype),
                             bb - lr * gb.to(bb.dtype)), loss

    step.schedule, step.decision_source = "1f1b", source
    step.table, step.stash_slots = tab, tab.stash_slots
    return step


# ---------------------------------------------------------------------------
# the GPipe train step: the parity oracle and committed fallback
# ---------------------------------------------------------------------------


def build_gpipe_train_step(comm: Communicator, n_micro: int, d_model: int,
                           lr: float = 1e-2, *,
                           interleave: int = 1) -> Callable:
    """``step(params, x, y) -> (params, loss)``, the GPipe baseline: all
    forwards, then autograd through the bubble-skipping forward sweep,
    which keeps all ``M`` microbatches' activations (the memory the 1F1B
    stash is measured against). Handles any ``n_micro >= 1``."""
    world = comm.world_size
    V = int(interleave)
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    N = world * V
    M = n_micro
    steps = M + N - 1

    def step(params: PPStageParams, x: torch.Tensor, y: torch.Tensor):
        dev = x.device
        cache: dict = {}
        with torch.enable_grad():
            w = params.w.detach().requires_grad_()
            bb = params.b.detach().requires_grad_()
            zero = torch.zeros(x.shape[2:], dtype=x.dtype, device=dev)
            recv = [[zero] * V for _ in range(world)]
            outs = [None] * M
            for s in range(steps):
                live, inps = [], []
                for r in range(world):
                    for v in range(V):
                        if not 0 <= s - (v * world + r) < M:
                            continue
                        if v == 0:
                            inp = x[0, min(s, M - 1)] if r == 0 \
                                else recv[r][0]
                        else:
                            inp = recv[r][v - 1] if r == 0 else recv[r][v]
                        live.append((r, v))
                        inps.append(inp)
                new = [[zero] * V for _ in range(world)]
                if live:
                    ri = _index([r for r, _ in live], dev, cache)
                    vi = _index([v for _, v in live], dev, cache)
                    ys = _stage(w[ri, vi], bb[ri, vi], torch.stack(inps))
                    for k, (r, v) in enumerate(live):
                        new[r][v] = ys[k]
                last_mb = s - (N - 1)
                if 0 <= last_mb < M:
                    outs[last_mb] = new[world - 1][V - 1]
                recv = [new[(r - 1) % world] for r in range(world)]
            diff = (torch.stack(outs) - y[world - 1]).float()
            loss = torch.mean(diff * diff, dim=(1, 2)).sum() / M
            gw, gb = torch.autograd.grad(loss, (w, bb))
        return PPStageParams(params.w - lr * gw.to(params.w.dtype),
                             params.b - lr * gb.to(params.b.dtype)), \
            loss.detach()

    step.schedule, step.decision_source = "gpipe", "register"
    step.table, step.stash_slots = None, M
    return step


# ---------------------------------------------------------------------------
# carrying weights across from the JAX package
# ---------------------------------------------------------------------------


def params_from_jax(params, where):
    """A JAX ``StageParams`` or ``PPStageParams`` (``where``: a device or
    a communicator), or a ``PPTransformerParams`` (``where``: a
    :class:`PPMesh`), as numpy, laid out in the port's rank rows."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32, copy=True))

    if hasattr(params, "attn"):
        return _transformer_layout(*(t(a) for a in params), where)
    dev = where.device if hasattr(where, "device") else torch.device(where)
    w, b = t(params.w).to(dev), t(params.b).to(dev)
    return StageParams(w, b) if w.dim() == 3 else PPStageParams(w, b)


# ===========================================================================
# the composed (pp, dp, tp) transformer train step
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class PPMesh:
    """A (pp, dp, tp) layout of ``pp * dp * tp`` ranks on one device: rank
    ``(p * dp + i) * tp + j`` is pipeline stage p, dp rank i, tp rank j, the
    order ``devices.reshape(pp, dp, tp)`` gives the JAX mesh."""

    device: torch.device
    pp: int
    dp: int = 1
    tp: int = 1


def make_pp_mesh(device, pp: int, dp: int = 1, tp: int = 1) -> PPMesh:
    """A (pp, dp, tp) mesh of ranks on ``device`` (size-1 axes kept)."""
    return PPMesh(torch.device(device), int(pp), int(dp), int(tp))


class PPTransformerParams(NamedTuple):
    """One transformer block per pipeline stage, ZeRO-sharded over dp in the
    travel layout, each rank's shard at ``[p, i, j]``:

    * ``attn``: (pp, dp, tp, n_attn_pad/dp), block i of tp rank j's flat
      attention bucket (Wqkv columns, Wo rows of its heads);
    * ``w1t``: (pp, dp, tp, d_hidden/tp/dp, d_model), W1-transposed rows,
      block j*dp + i;
    * ``w2t``: (pp, dp, tp, d_model/dp, d_hidden/tp), W2-transposed rows
      block i, columns block j.
    """

    attn: torch.Tensor
    w1t: torch.Tensor
    w2t: torch.Tensor


def _transformer_layout(attn: torch.Tensor, w1t: torch.Tensor,
                        w2t: torch.Tensor,
                        mesh: PPMesh) -> PPTransformerParams:
    """Global per-stage weights, as the JAX package holds them (attn (pp,
    tp, n_attn_pad), w1t (pp, d_hidden, d_model), w2t (pp, d_model,
    d_hidden)), -> each rank's shard on the mesh's device."""
    pp, dp, tp = mesh.pp, mesh.dp, mesh.tp
    na = attn.shape[2] // dp
    h, d = w1t.shape[1:]
    a = attn.reshape(pp, tp, dp, na).permute(0, 2, 1, 3)
    w1 = w1t.reshape(pp, tp, dp, h // tp // dp, d).permute(0, 2, 1, 3, 4)
    w2 = w2t.reshape(pp, dp, d // dp, tp, h // tp).permute(0, 1, 3, 2, 4)
    return PPTransformerParams(*(z.to(mesh.device).contiguous()
                                 for z in (a, w1, w2)))


def init_pp_transformer(gen: torch.Generator, mesh: PPMesh, d_model: int,
                        d_hidden: int, n_heads: int) -> PPTransformerParams:
    """One random transformer block per stage from ``gen``, scaled as the
    JAX package scales it (attention d^-1/2, W1 (2/d)^1/2, W2 (2/h)^1/2, no
    biases), sharded over the mesh."""
    from . import zero
    pp, dp, tp = mesh.pp, mesh.dp, mesh.tp
    zero._validate_geometry(dp, tp, d_model, d_hidden, n_heads)
    dtp, n_attn = zero._attn_sizes(d_model, tp)
    n_attn_pad = n_attn + (-n_attn) % dp
    dev = gen.device

    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    attn = torch.zeros((pp, tp, n_attn_pad), device=dev)
    w1t = torch.empty((pp, d_hidden, d_model), device=dev)
    w2t = torch.empty((pp, d_model, d_hidden), device=dev)
    s_attn = d_model ** -0.5
    for p in range(pp):
        wq, wk, wv, wo = (rnd((d_model, d_model), s_attn) for _ in range(4))
        for s in range(tp):
            cols = slice(s * dtp, (s + 1) * dtp)
            wqkv = torch.cat([wq[:, cols], wk[:, cols], wv[:, cols]], 1)
            attn[p, s, :n_attn] = torch.cat([wqkv.reshape(-1),
                                             wo[cols].reshape(-1)])
        w1t[p] = rnd((d_model, d_hidden), (2.0 / d_model) ** 0.5).T
        w2t[p] = rnd((d_hidden, d_model), (2.0 / d_hidden) ** 0.5).T
    return _transformer_layout(attn, w1t, w2t, mesh)


def pp_transformer_engage_reason(d_model: int, d_hidden: int,
                                 batch_per_dp: int, pp: int, dp: int,
                                 tp: int,
                                 overlap: Optional[bool] = None,
                                 bidirectional: bool = True,
                                 wire_dtype=None) -> Optional[str]:
    """None when the composed fused datapath would run: the relay plan
    engages for the (batch, d_model) payload and (dp > 1) every per-stage
    fused leg resolves (:func:`.zero.fsdp_engage_reason`; at dp == 1 the
    stage's gathers are identities, so only the relay gates). Otherwise the
    first decline reason."""
    from ..ops import pipeline_relay as _relay

    reason = _relay.relay_engage_reason(batch_per_dp, d_model,
                                        torch.float32, pp, overlap)
    if reason is not None:
        return reason
    if dp > 1:
        from . import zero
        return zero.fsdp_engage_reason(d_model, d_hidden, batch_per_dp,
                                       dp, tp, overlap, bidirectional,
                                       wire_dtype)
    return None


def build_pp_transformer_train_step(mesh: PPMesh, d_model: int,
                                    d_hidden: int, n_heads: int,
                                    n_micro: int, lr: float = 1e-2, *,
                                    schedule: Optional[str] = None,
                                    overlap: Optional[bool] = None,
                                    wire_dtype=None,
                                    bidirectional: bool = True) -> Callable:
    """``step(params, x, y) -> (params, loss)``: one train step over the
    (pp, dp, tp) mesh, a transformer block per stage (flash attention and
    the MLP, over dp on the all-gather x matmul with ZeRO travel-layout
    shards, Megatron heads and hidden over tp), scheduled 1F1B along pp on
    the per-tick relay.

    ``x``/``y``: (M, B, d_model), microbatches leading, dp rank i taking
    rows ``i*B/dp..`` (stage 0 injects, the last stage holds targets). SGD;
    loss = mean over microbatches of the per-microbatch global MSE.

    Resolution: ``schedule`` as on :func:`build_pp_train_step`; the fused
    datapath runs only when :func:`pp_transformer_engage_reason` resolves
    None at the call's batch shape. A decline other than a requested
    ``overlap=False`` falls back whole to GPipe with the flat datapath,
    counted under ``accl_cmatmul_fallback_total{op="pp_pipeline"}``; an
    explicit ``overlap=False`` runs the resolved schedule on the flat
    datapath, uncounted.

    The 1F1B backward recomputes each stage from its stashed (b, d) input
    under ``torch.autograd.grad``, so the flash and collective-matmul
    autograd Functions run there; GPipe differentiates the whole forward
    sweep. The step carries ``.schedule``, ``.decision_source``,
    ``.fused``, ``.engage_reason``, ``.table`` and ``.stash_slots``
    (resolved at the first call)."""
    from ..ops import collective_matmul as cm
    from ..ops import pipeline_relay as _relay
    from . import zero

    pp, dp, tp = mesh.pp, mesh.dp, mesh.tp
    zero._validate_geometry(dp, tp, d_model, d_hidden, n_heads)
    cm._resolve_wire(wire_dtype, torch.float32)   # a bad name raises here
    M = n_micro
    h_tp = d_hidden // tp

    def _resolved_overlap():
        if overlap is None:
            return None if _relay.get_overlap_enabled() else False
        return overlap

    def build(batch_per_dp: int):
        ov = _resolved_overlap()
        payload = 4 * batch_per_dp * d_model
        decision, source = resolve_pp_schedule(
            schedule, pp, M, payload_bytes=payload, tp=tp,
            tp_bytes=payload)
        reason = pp_transformer_engage_reason(
            d_model, d_hidden, batch_per_dp, pp, dp, tp, ov,
            bidirectional, wire_dtype)
        fused = reason is None
        if not fused and reason != "off":
            # commit honesty: a declining per-stage plan demotes the whole
            # step to the GPipe baseline, counted
            cm._note_fallback(PP_STEP_OP, reason)
            decision, source = "gpipe", "fallback"
        tab = None
        if decision == "1f1b":
            validate_pp_geometry(pp, M, 1)
            tab = schedule_table(pp, M, 1)
        return decision, source, fused, reason, tab, ov

    def stage_fused(sp: PPTransformerParams, h, ov):
        """The fused block: bucket-gathered attention (its gradient rides
        the wire-staged reduce-scatter), then the MLP on the all-gather x
        matmul over dp in travel layout. sp fields (F, dp, tp, ...), h (F,
        dp, tp, b, d)."""
        F_, _, _, b, d = h.shape
        G = F_ * dp
        bucket = zero._bucket_gather(sp.attn, wire_dtype, dim=1) \
            if dp > 1 else sp.attn
        x = zero._attn_sublayer(h.reshape(G, tp, b, d),
                                bucket.reshape(G, tp, -1), d, tp, n_heads)
        if dp == 1:
            w1 = sp.w1t.reshape(G, tp, h_tp, d)
            w2 = sp.w2t.reshape(G, tp, d, h_tp)
            y = zero._mlp_sublayer(x, lambda xt: torch.matmul(w1, xt),
                                   lambda u: torch.matmul(w2, u), tp)
            return y.reshape(h.shape)

        def agmm(trav):
            def mm(panel):
                k, n = panel.shape[-2:]
                pv = panel.reshape(F_, dp, tp, k, n)
                out = [torch.stack([cm.all_gather_matmul(
                    trav[f, :, j], pv[f, :, j], ov, bidirectional,
                    wire_dtype) for j in range(tp)], 1)
                    for f in range(F_)]
                return torch.stack(out).reshape(G, tp, -1, n)
            return mm

        y = zero._mlp_sublayer(x, agmm(sp.w1t), agmm(sp.w2t), tp)
        return y.reshape(h.shape)

    def stage_flat(sp: PPTransformerParams, h):
        """The baseline block: whole dp gathers (identities at dp == 1;
        gradients reduce-scatter through the bucket gather), plain
        products, the tp sum."""
        F_, _, _, b, d = h.shape
        G = F_ * dp
        if dp > 1:
            bucket = zero._bucket_gather(sp.attn, "off", dim=1)
            w1 = zero._bucket_gather(sp.w1t.reshape(F_, dp, tp, -1), "off",
                                     dim=1)
            w2 = zero._bucket_gather(sp.w2t.reshape(F_, dp, tp, -1), "off",
                                     dim=1)
        else:
            bucket, w1, w2 = sp.attn, sp.w1t, sp.w2t
        w1 = w1.reshape(G, tp, h_tp, d)
        w2 = w2.reshape(G, tp, d, h_tp)
        x = zero._attn_sublayer(h.reshape(G, tp, b, d),
                                bucket.reshape(G, tp, -1), d, tp, n_heads)
        y = zero._mlp_sublayer(x, lambda xt: torch.matmul(w1, xt),
                               lambda u: torch.matmul(w2, u), tp)
        return y.reshape(h.shape)

    built = {}

    def step(params: PPTransformerParams, x: torch.Tensor, y: torch.Tensor):
        B = x.shape[1]
        if B % dp:
            raise ValueError(f"rows {B} not divisible by dp {dp}")
        b = B // dp
        if b not in built:
            built[b] = build(b)
            decision, source, fused, reason, tab, _ = built[b]
            step.schedule, step.decision_source = decision, source
            step.fused, step.engage_reason = fused, reason
            step.table = tab
            step.stash_slots = tab.stash_slots if tab is not None else M
        decision, _, fused, _, tab, ov = built[b]

        def stage(sp, h):
            return stage_fused(sp, h, ov) if fused else stage_flat(sp, h)

        # each rank's own rows: (M, dp, tp, b, d)
        xr = x.reshape(M, dp, 1, b, -1).expand(M, dp, tp, b, x.shape[2])
        yr = y.reshape(M, dp, 1, b, -1).expand(M, dp, tp, b, y.shape[2])
        if decision == "1f1b":
            return _pp_1f1b_generic(stage, params, xr, yr, tab, M, dp, lr,
                                    ov)
        return _pp_gpipe_generic(stage, params, xr, yr, pp, M, dp, lr)

    step.schedule = step.decision_source = None
    step.fused = step.engage_reason = None
    step.table = step.stash_slots = None
    return step


def _select(sp: PPTransformerParams, sel, grad: bool = False):
    """The shards of the stages ``sel`` (leaves for autograd when
    ``grad``)."""
    if grad:
        return PPTransformerParams(
            *(t[sel].detach().requires_grad_() for t in sp))
    return PPTransformerParams(*(t[sel] for t in sp))


def _pp_1f1b_generic(stage, sp: PPTransformerParams, xr, yr,
                     tab: PPSchedule, M: int, dp: int, lr: float, ov):
    """The 1F1B walk over an arbitrary per-stage block (V = 1): forward
    ticks run ``stage`` on every forward rank at once and stash only its
    (b, d) input; backward ticks recompute it under
    ``torch.autograd.grad``; one relay per tick. xr/yr (M, dp, tp, b, d)."""
    from ..ops import pipeline_relay as _relay

    pp = tab.world
    _, _, tp, b, d = xr.shape
    dev = xr.device
    f32 = torch.float32
    cache: dict = {}
    lane = (dp, tp, b, d)
    acts = torch.zeros((pp, tab.stash_slots, *lane), dtype=f32, device=dev)
    inb = torch.zeros((pp, tab.grad_slots, *lane), dtype=f32, device=dev)
    f_wire = torch.zeros((pp, *lane), dtype=f32, device=dev)
    b_wire = torch.zeros_like(f_wire)
    grads = [torch.zeros(t.shape, dtype=f32, device=dev) for t in sp]
    loss_vec = torch.zeros((pp, dp, tp, M), dtype=f32, device=dev)
    for t in range(tab.steps):
        _land(acts, f_wire, tab.arr_f_slot[t], cache)
        _land(inb, b_wire, tab.arr_b_slot[t], cache)
        f_send = torch.zeros_like(f_wire)
        b_send = torch.zeros_like(b_wire)

        rf = _active(tab.f_mb[t])
        if rf:
            mbs = [int(tab.f_mb[t, r]) for r in rf]
            slots = [int(tab.f_slot[t, r]) for r in rf]
            h_in = _slot_read(acts, rf, slots, cache)
            if rf[0] == 0:
                h_in[0] = xr[mbs[0]]             # stage 0 injects
            _slot_update(acts, h_in, rf, slots, cache)
            sel = _rows(rf, dev, cache)
            with torch.no_grad():
                h_out = stage(_select(sp, sel), h_in).float()
            send = []
            for k, r in enumerate(rf):
                ds = int(tab.dy_slot[t, r])
                if ds < 0:
                    send.append(k)
                    continue
                diff = h_out[k] - yr[mbs[k]]
                loss_vec[r, :, :, mbs[k]] = torch.mean(diff * diff,
                                                       dim=(-2, -1))
                inb[r, ds] = (2.0 / (b * d * M * dp)) * diff
            if send:
                f_send[_index([rf[k] for k in send], dev, cache)] = \
                    h_out[_index(send, dev, cache)]

        rb = _active(tab.b_mb[t])
        if rb:
            h_in = _slot_read(acts, rb, [tab.b_slot[t, r] for r in rb],
                              cache).requires_grad_()
            dy = _slot_read(inb, rb, [tab.b_in_slot[t, r] for r in rb],
                            cache)
            sel = _rows(rb, dev, cache)
            with torch.enable_grad():
                leaves = _select(sp, sel, grad=True)
                out = stage(leaves, h_in).float()
                *dsp, dh = torch.autograd.grad(out, (*leaves, h_in), dy)
            for g, dg in zip(grads, dsp):
                g[sel] += dg.float()
            if rb[0] == 0:
                dh[0] = 0                        # nothing before stage 0
            b_send[sel] = dh.float()

        f_wire, b_wire = (w.reshape(pp, *lane) for w in _relay.pp_relay(
            f_send.reshape(pp, dp * tp, b, d),
            b_send.reshape(pp, dp * tp, b, d), ov))
    loss = loss_vec[:, :, 0].sum() / M / dp
    new = PPTransformerParams(*(w - lr * g.to(w.dtype)
                                for w, g in zip(sp, grads)))
    return new, loss


def _pp_gpipe_generic(stage, sp: PPTransformerParams, xr, yr, pp: int,
                      M: int, dp: int, lr: float):
    """The GPipe baseline over an arbitrary per-stage block: autograd
    through the bubble-skipping forward sweep (every microbatch's
    activations kept). The objective is every rank's local loss summed, as
    each JAX device differentiates its own."""
    dev = xr.device
    cache: dict = {}
    with torch.enable_grad():
        leaves = PPTransformerParams(
            *(t.detach().requires_grad_() for t in sp))
        zero = torch.zeros(xr.shape[1:], dtype=torch.float32, device=dev)
        h = [zero] * pp
        outs = [None] * M
        for s in range(M + pp - 1):
            live = [r for r in range(pp) if 0 <= s - r < M]
            inps = [xr[min(s, M - 1)].float() if r == 0 else h[r]
                    for r in live]
            sel = _rows(live, dev, cache)
            ys = stage(_select(leaves, sel), torch.stack(inps)).float()
            new = [zero] * pp
            for k, r in enumerate(live):
                new[r] = ys[k]
            if pp - 1 in live:
                outs[s - (pp - 1)] = new[pp - 1]
            h = [new[(r - 1) % pp] for r in range(pp)]
        diff = torch.stack(outs) - yr                # (M, dp, tp, b, d)
        local = torch.mean(diff * diff, dim=(-2, -1))  # (M, dp, tp)
        grads = torch.autograd.grad(local.sum() / M / dp, tuple(leaves))
    loss = local.detach()[:, :, 0].sum() / M / dp
    new = PPTransformerParams(*(w - lr * g.to(w.dtype)
                                for w, g in zip(sp, grads)))
    return new, loss


# ---------------------------------------------------------------------------
# plan inspection CLI
# ---------------------------------------------------------------------------


def _explain(world: int, n_micro: int, interleave: int = 1) -> str:
    lines = [f"pipeline schedule for world={world} n_micro={n_micro} "
             f"interleave={interleave}:"]
    try:
        tab = schedule_table(world, n_micro, interleave)
        lines += [
            f"  1f1b:  {tab.steps} ticks, stash={tab.stash_slots} "
            f"slots (max live {tab.max_live}), "
            f"bubble={tab.bubble_fraction:.3f}",
        ]
    except ValueError as e:
        lines += [f"  1f1b:  DEGENERATE: {e}"]
    gp = gpipe_bubble_fraction(world, n_micro, interleave)
    N = world * interleave
    lines += [f"  gpipe: {2 * (n_micro + N - 1)} ticks, stash="
              f"{n_micro} microbatches, bubble={gp:.3f}"]
    decision, source = resolve_pp_schedule(
        None, world, n_micro, payload_bytes=1 << 20,
        interleave=interleave)
    lines += [f"  resolve_pp_schedule(): {decision} (source={source})"]
    return "\n".join(lines)


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Inspect pipeline-schedule decisions without a live "
                    "session")
    ap.add_argument("--explain", nargs="+", type=int, metavar="N",
                    help="world n_micro [interleave]")
    args = ap.parse_args(argv)
    if not args.explain or len(args.explain) < 2:
        ap.print_help()
        return 2
    print(_explain(*args.explain[:3]))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
