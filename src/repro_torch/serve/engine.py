"""Serving engine: chunked prefill + paged KV cache + continuous batching —
the port of ``repro.serve.engine``.

The engine owns ``batch_slots`` decode rows and one shared physical block
pool (``models/lm.lm_paged_cache_defs``), allocated once on the model's
device. A request's life:

1. **admit** — reserve ``ceil((prompt + max_tokens) / page)`` physical
   blocks through the :class:`~repro_torch.serve.paged.BlockAllocator`
   (the whole budget up front, so generation can never run out of cache)
   and take a free slot;
2. **chunked prefill** — the prompt runs ``chunk`` tokens at a time
   through ONE program (``model.prefill_chunk``), each chunk writing its
   KV rows into the pool through the slot's block table;
3. **decode** — all in-flight slots advance together through the second
   program (``model.paged_decode``), each slot at its OWN position (no
   shared engine clock): slot b writes position ``pos[b]`` and attends
   its logical cache ``0..pos[b]``;
4. **retire** — blocks go back to the free list, the slot is recycled.

Long and short requests coexist without per-slot ``max_len`` padding:
``max_len`` only caps a request's logical budget (it sizes the block
*table*, not the cache). ``sparse=True`` applies the TorchGT
cluster-sparse (window + global sink) mask.

The reference's two jitted programs are two entry points here, each
called with one signature for the engine's life: ``(1, chunk)`` tokens
and a ``(1, nmax)`` table for prefill, ``(B, 1)`` tokens, ``(B,)``
positions and a ``(B, nmax)`` table for decode, offsets and lengths as
host ints. Each entry point records the signatures (shapes, dtypes,
devices) of the tensors it is called with, :meth:`ServeEngine.
traced_programs` counts them, and every ``run()`` audits the budget: a
cold engine may end at two, a warm one may add none. The reference
donates the pool to its programs; here they write it in place, under
``torch.inference_mode()``, so the pool's storage never moves.

Graceful degradation (``repro_torch.resilience``): ``max_queue`` bounds
the admission queue — ``submit`` past capacity returns a typed
:class:`Rejected` ("overloaded") instead of buffering unboundedly; a
per-request ``deadline`` (seconds after ``run()`` starts, like
``arrival``) sheds past-due work both at admission and mid-flight
(partial output lands in ``self.shed``); watchdog counters
(``rejected_overload`` / ``shed_deadline`` / ``queue_peak``) surface in
the run stats. All of it is host-side scheduling — a warm engine keeps
its budget of 0 new signatures under overload and shedding.
``inject_burst`` is the deterministic arrival-burst fault hook.

On a mesh (``mesh_model=P`` > 1, in each of the P ranks of an
initialised process group, ``launch/mesh.spawn`` or torchrun) both
entry points run under the reference's "decode" recipe
(``parallel.axes.axis_rules``): each rank's pool holds KV/P kv heads,
its layers attend over its own heads and sum the output projection
over the ranks (where the heads do not split P ways, every rank holds
and computes every head: the reference's ``fit_spec`` rule), and the
MoE FFN is expert-parallel with the
reference's capacity (``models/lm.py``, ``models/moe.py``). The
reference has one scheduler; here every rank runs one, and they must
agree: every scheduling decision (sheds, admissions, retirements) is a
function of the engine's state and its clock, and the clock each loop
reads is rank 0's, broadcast, as is every sampled token. So every rank
runs rank 0's schedule, whatever its own clock says.

Not ported: the reference's ``ir_audit`` (its IR analysis is owed no
port).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kops
from repro_torch.models.lm import heads_split
from repro_torch.parallel import axes as pax
from repro_torch.parallel import collectives as C
from repro_torch.serve.paged import BlockAllocator


@dataclasses.dataclass(frozen=True)
class Admitted:
    """Typed ``submit`` result: the request was queued."""
    rid: object
    queued: int              # queue depth right after enqueue


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Typed ``submit``/shed result: the engine refused or dropped the
    request. ``reason`` is ``"overloaded"`` (admission queue at
    ``max_queue``) or ``"deadline"`` (past-due, shed at admission or
    mid-flight)."""
    rid: object
    reason: str
    detail: str = ""


@dataclasses.dataclass
class _Request:
    rid: object
    prompt: list
    max_tokens: int
    arrival: float           # seconds after run() starts (offered load)
    deadline: float | None = None  # same clock as arrival; None = none
    t_submit: float = 0.0
    t_admit: float = -1.0
    t_first: float = -1.0    # first generated token (TTFT)
    t_done: float = -1.0
    blocks: list = dataclasses.field(default_factory=list)
    filled: int = 0          # prompt tokens already prefilled
    cache_len: int = 0       # tokens written into the pool (per-slot pos)
    pending: int = -1        # sampled token not yet fed back
    out: list = dataclasses.field(default_factory=list)

    @property
    def prefilling(self) -> bool:
        return self.filled < len(self.prompt)


def _signature(args) -> tuple:
    """The shapes, dtypes and devices of the tensors in ``args`` (dicts
    walked in key order), and the type of every other argument."""
    sig = []
    for a in args:
        if isinstance(a, dict):
            sig.append(_signature([a[k] for k in sorted(a)]))
        elif torch.is_tensor(a):
            sig.append((tuple(a.shape), a.dtype, a.device.type))
        else:
            sig.append(type(a).__name__)
    return tuple(sig)


class _Program:
    """One serving entry point: runs ``fn`` without grad, inside
    ``context()`` (the mesh's axis rules), and records the signature of
    every call."""

    def __init__(self, fn, context=contextlib.nullcontext):
        self.fn = fn
        self.context = context
        self.signatures: set = set()

    def __call__(self, *args, **kw):
        self.signatures.add(_signature(args))
        with torch.inference_mode(), self.context():
            return self.fn(*args, **kw)


class ServeEngine:
    """Continuous-batching engine over the paged-KV serving path of a
    dense, MoE or VLM token LM (``models/lm.LMModel``; a VLM is served
    text-only, as the reference serves it); graph archs are served
    by :class:`repro_torch.serve.graph_serve.GraphServe` instead."""

    def __init__(self, model, *, batch_slots: int = 4, page: int = 16,
                 max_len: int = 256, chunk: int | None = None,
                 num_blocks: int | None = None, sparse: bool = False,
                 mesh_model: int = 1, eos: int | None = None,
                 max_queue: int | None = None):
        if getattr(model, "paged_decode", None) is None or \
                getattr(model, "prefill_chunk", None) is None:
            raise ValueError(
                f"family {model.cfg.family!r} has no paged serving path "
                f"(servable: dense/moe/vlm token LMs; graph archs go "
                f"through GraphServe)")
        self.mesh = self.recipe = None
        if mesh_model > 1:
            self._join_mesh(model.cfg, int(mesh_model), int(batch_slots),
                            int(max_len))
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.B = int(batch_slots)
        self.page = int(page)
        self.max_len = int(max_len)
        if chunk is None:
            # prefill chunking is a tuned schedule ("paged_attention"
            # winner-table entries; DEFAULT_SCHEDULES backstop) — an
            # explicit chunk argument always wins
            sched = kops.resolve_schedule(
                "paged_attention", seq_len=self.max_len,
                heads=self.cfg.n_heads, d_head=self.cfg.head_dim,
                device_type=self.device.type)
            chunk = kops._sched_field(sched, "chunk")
        self.chunk = int(chunk)
        self.sparse = bool(sparse)
        self.eos = eos
        self.nmax = -(-self.max_len // self.page)  # block-table width
        if num_blocks is None:
            # enough for every slot at full budget, + the scratch block
            num_blocks = self.B * self.nmax + 1
        self.allocator = BlockAllocator(num_blocks, self.page)
        kv_parts = mesh_model if heads_split(self.cfg, mesh_model) else 1
        self.pool = model.paged_cache_defs(
            num_blocks, self.page, kv_heads=self.cfg.kv_heads // kv_parts)
        context = contextlib.nullcontext if self.mesh is None else (
            lambda: pax.axis_rules(self.recipe, self.mesh))
        self._prefill = _Program(model.prefill_chunk, context)
        self._decode = _Program(model.paged_decode, context)
        self._programs = {"prefill": self._prefill, "decode": self._decode}

        # host scheduling state
        self._queue: deque[_Request] = deque()
        self._slots: list[_Request | None] = [None] * self.B
        self._bt = np.zeros((self.B, self.nmax), np.int64)
        self.done: dict = {}
        self.request_stats: list[dict] = []
        self.prefill_calls = 0
        self.decode_calls = 0
        # graceful degradation (host-side, never touches the programs)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.rejected: list[Rejected] = []
        self.shed: dict = {}         # rid -> partial output at shed time
        self.rejected_overload = 0   # watchdog counters (run stats)
        self.shed_deadline = 0
        self.queue_peak = 0

    def _join_mesh(self, cfg, p: int, slots: int, max_len: int) -> None:
        """The (1, p) mesh over the initialised process group's p ranks and
        the reference's "decode" recipe for it; raises for a group of
        another size and for experts that do not split p ways. Heads that
        do not split stay whole on every rank (``lm.heads_split``)."""
        from repro_torch.configs import ShapeConfig
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.parallel.sharding import recipe_for

        if not dist.is_initialized() or dist.get_world_size() != p:
            raise RuntimeError(
                f"mesh_model={p} needs an initialised process group of {p} "
                f"ranks (launch/mesh.spawn or torchrun), one engine a rank")
        if (cfg.moe_experts or p) % p:
            raise ValueError(f"{cfg.name}: {cfg.moe_experts} experts do not "
                             f"split over a {p}-way model axis")
        self.mesh = make_host_mesh(model=p)
        self.recipe = recipe_for(ShapeConfig("serve", "decode", max_len,
                                             slots), self.mesh)

    def _clock(self) -> float:
        """Seconds since ``run()`` started: rank 0's on a mesh (every
        rank schedules by the same clock)."""
        now = time.perf_counter() - self._t0
        if self.mesh is None:
            return now
        t = torch.tensor([now], dtype=torch.float64,
                         device=C.control_device())
        return C.broadcast_(t, 0).item()

    # ------------------------------------------------------------ metrics

    def traced_programs(self) -> int:
        """Distinct signatures seen so far across the engine's two entry
        points (the reference's traced programs)."""
        return sum(len(p.signatures) for p in self._programs.values())

    def pool_bytes(self) -> int:
        """Device bytes of the paged KV pool."""
        return sum(t.numel() * t.element_size()
                   for kv in self.pool.values() for t in kv.values())

    # ---------------------------------------------------------- admission

    def submit(self, rid, prompt_tokens, max_tokens: int,
               arrival: float = 0.0, deadline: float | None = None):
        """Queue a request. ``arrival`` (seconds after ``run()`` starts)
        models offered load — the scheduler will not admit the request
        before its arrival time. ``deadline`` (same clock) marks the
        request past-due: shed at admission or mid-flight once exceeded.

        Returns :class:`Admitted`, or :class:`Rejected("overloaded")
        <Rejected>` when the admission queue already holds ``max_queue``
        requests — the caller sees backpressure instead of the queue
        silently growing p99. Malformed requests still raise."""
        prompt = [int(t) for t in prompt_tokens]
        if not prompt:
            raise ValueError(f"request {rid!r}: empty prompt")
        if max_tokens < 1:
            raise ValueError(f"request {rid!r}: max_tokens must be >= 1")
        budget = len(prompt) + int(max_tokens)
        if budget > self.max_len:
            raise ValueError(
                f"request {rid!r}: prompt {len(prompt)} + max_tokens "
                f"{max_tokens} exceeds max_len {self.max_len}")
        need = self.allocator.blocks_for(budget)
        if need > self.allocator.num_blocks - 1:
            raise ValueError(
                f"request {rid!r}: needs {need} blocks, pool has "
                f"{self.allocator.num_blocks - 1} usable")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            rej = Rejected(rid, "overloaded",
                           f"admission queue at max_queue={self.max_queue}")
            self.rejected.append(rej)
            self.rejected_overload += 1
            return rej
        self._queue.append(_Request(
            rid, prompt, int(max_tokens), float(arrival),
            deadline=None if deadline is None else float(deadline),
            t_submit=float(arrival)))
        self.queue_peak = max(self.queue_peak, len(self._queue))
        return Admitted(rid, len(self._queue))

    def inject_burst(self, n: int, *, arrival: float = 0.0,
                     prompt_len: int = 6, max_tokens: int = 4,
                     deadline: float | None = None, seed: int = 0):
        """Deterministic fault-injection hook (``repro_torch.resilience``):
        submit a seeded burst of ``n`` requests at one arrival instant —
        the overload trigger for the bounded-queue / shedding paths.
        Returns the list of typed ``submit`` results."""
        rng = np.random.default_rng(seed)
        hi = max(2, min(64, self.cfg.vocab_size))
        return [self.submit(f"burst-{seed}-{i}",
                            rng.integers(1, hi, prompt_len).tolist(),
                            max_tokens, arrival=arrival, deadline=deadline)
                for i in range(n)]

    def _admit(self, now: float):
        """FIFO admission: the queue head is admitted once it has
        arrived, a slot is free, and its whole block budget fits.
        Past-due heads are shed here instead of admitted."""
        for s in range(self.B):
            if self._slots[s] is not None:
                continue
            while self._queue and \
                    self._queue[0].deadline is not None and \
                    now > self._queue[0].deadline:
                self._shed(self._queue.popleft(), now, "admission")
            if not self._queue:
                break
            req = self._queue[0]
            if req.arrival > now:
                break
            need = self.allocator.blocks_for(
                len(req.prompt) + req.max_tokens)
            if not self.allocator.can_alloc(need):
                break  # head-of-line waits for retirements (FIFO, no
                       # starvation; its reservation always fits the pool)
            self._queue.popleft()
            req.blocks = self.allocator.alloc(need)
            req.t_admit = now
            self._slots[s] = req
            self._bt[s] = 0
            self._bt[s, :len(req.blocks)] = req.blocks

    # ------------------------------------------------------------- phases

    def _tensor(self, arr) -> torch.Tensor:
        """A host int64 array as a tensor on the model's device (a copy)."""
        return torch.tensor(arr, dtype=torch.int64, device=self.device)

    def _sample(self, logits) -> list[int]:
        """Greedy tokens of logits ``(n, V_padded)``: the first index of
        the max of the fp32 logits over ``[:vocab_size]``, one host sync
        for the rows together; on a mesh rank 0's, broadcast."""
        tok = logits[:, :self.cfg.vocab_size].float().argmax(-1)
        if self.mesh is not None:
            tok = C.broadcast_(tok.to(C.control_device()), 0)
        return tok.tolist()

    def _retire(self, s: int, now: float):
        req = self._slots[s]
        req.t_done = now
        self.done[req.rid] = list(req.out)
        self.request_stats.append(self._stats_row(req, now, shed=False))
        self.allocator.free(req.blocks)
        self._slots[s] = None
        self._bt[s] = 0

    def _stats_row(self, req: _Request, now: float, *, shed: bool) -> dict:
        return {
            "rid": req.rid, "prompt_len": len(req.prompt),
            "new_tokens": len(req.out), "t_submit": req.t_submit,
            "t_admit": req.t_admit, "t_first": req.t_first,
            "t_done": now, "latency_s": now - req.t_submit,
            "ttft_s": req.t_first - req.t_submit, "shed": shed,
        }

    def _shed(self, req: _Request, now: float, where: str):
        """Deadline shed: drop past-due work (queued or in-flight) and
        surface it as a typed rejection; any tokens generated before the
        deadline land in ``self.shed[rid]``."""
        req.t_done = now
        self.shed[req.rid] = list(req.out)
        self.rejected.append(Rejected(
            req.rid, "deadline",
            f"past deadline {req.deadline:.3f}s at {where} ({now:.3f}s)"))
        self.shed_deadline += 1
        self.request_stats.append(self._stats_row(req, now, shed=True))
        if req.blocks:
            self.allocator.free(req.blocks)
            req.blocks = []

    def _shed_slots(self, now: float):
        """Mid-flight deadline scan: an admitted request past its
        deadline stops consuming prefill/decode work immediately."""
        for s in range(self.B):
            req = self._slots[s]
            if req is not None and req.deadline is not None and \
                    now > req.deadline:
                self._shed(req, now, "mid-flight")
                self._slots[s] = None
                self._bt[s] = 0

    def _finished(self, req: _Request) -> bool:
        return len(req.out) >= req.max_tokens or (
            self.eos is not None and req.out and req.out[-1] == self.eos)

    def _prefill_step(self, now: float) -> bool:
        """One prompt chunk for every slot still prefilling. A slot whose
        prompt completes samples its first token from the chunk logits."""
        ran = False
        for s in range(self.B):
            req = self._slots[s]
            if req is None or not req.prefilling:
                continue
            ran = True
            n = min(self.chunk, len(req.prompt) - req.filled)
            tokens = np.zeros((1, self.chunk), np.int64)
            tokens[0, :n] = req.prompt[req.filled:req.filled + n]
            logits, self.pool = self._prefill(
                self.pool, self._tensor(tokens), req.filled, n,
                self._tensor(self._bt[s:s + 1]), sparse=self.sparse)
            self.prefill_calls += 1
            req.filled += n
            req.cache_len = req.filled
            if not req.prefilling:
                tok = self._sample(logits[:, 0])[0]
                req.t_first = time.perf_counter() - self._t0
                req.out.append(tok)
                req.pending = tok
                if self._finished(req):
                    self._retire(s, time.perf_counter() - self._t0)
        return ran

    def _decode_step(self) -> bool:
        """One batched decode step for every slot holding a pending
        token. Idle and still-prefilling rows run as scratch no-ops:
        token 0 at position 0 through an all-zeros block table, so their
        writes land in the reserved scratch block."""
        active = [s for s in range(self.B)
                  if self._slots[s] is not None
                  and not self._slots[s].prefilling]
        if not active:
            return False
        tokens = np.zeros((self.B, 1), np.int64)
        pos = np.zeros(self.B, np.int64)
        bt = np.zeros_like(self._bt)
        for s in active:
            req = self._slots[s]
            tokens[s, 0] = req.pending
            pos[s] = req.cache_len
            bt[s] = self._bt[s]
        logits, self.pool = self._decode(
            self.pool, self._tensor(tokens), self._tensor(pos),
            self._tensor(bt), sparse=self.sparse)
        self.decode_calls += 1
        toks = self._sample(logits[:, 0])
        now = time.perf_counter() - self._t0
        for s in active:
            req = self._slots[s]
            req.cache_len += 1
            tok = toks[s]
            req.out.append(tok)
            req.pending = tok
            if self._finished(req):
                self._retire(s, now)
        return True

    # ---------------------------------------------------------- main loop

    def run(self) -> dict:
        """Drive until the queue and all slots drain. Audits the
        two-program budget on every call: a cold engine may end with two
        signatures, a warm one must add none (raises otherwise)."""
        self._t0 = time.perf_counter()
        before = self.traced_programs()
        budget = 2 if before == 0 else 0
        self._run_loop()
        grew = self.traced_programs() - before
        if grew > budget:
            detail = ", ".join(f"{name}: {len(p.signatures)}"
                               for name, p in self._programs.items())
            raise AssertionError(
                f"serve engine (prefill + decode): {grew} new signatures "
                f"inside run() (budget {budget}) — {detail}. A shape or "
                f"dtype leaked into a program's signature (pad to one "
                f"shape budget).")
        dt = time.perf_counter() - self._t0
        total = sum(len(v) for v in self.done.values())
        return {
            "requests": len(self.done), "tokens": total, "seconds": dt,
            "tok_per_s": total / max(dt, 1e-9),
            "prefill_calls": self.prefill_calls,
            "decode_calls": self.decode_calls,
            "traced_programs": self.traced_programs(),
            # degradation watchdog: nonzero means the engine shed load
            # instead of buffering it
            "rejected_overload": self.rejected_overload,
            "shed_deadline": self.shed_deadline,
            "queue_peak": self.queue_peak,
        }

    def _run_loop(self):
        while self._queue or any(r is not None for r in self._slots):
            now = self._clock()
            self._shed_slots(now)
            self._admit(now)
            ran = self._prefill_step(now)
            ran = self._decode_step() or ran
            if not ran and self._queue:
                # nothing in flight: sleep until the next arrival
                wait = self._queue[0].arrival - (
                    time.perf_counter() - self._t0)
                if wait > 0:
                    time.sleep(min(wait, 0.05))
