"""Mixture-of-Experts FFN on the port: the port of ``repro.models.moe``
(``moe_defs``, ``_route``, ``_expert_ffn``, ``moe_tokens``, ``_ep_local``,
``moe_apply``).

Routing is the reference's: fp32 router logits and softmax, top-k, the
top-k probabilities renormalised (floor 1e-9), and the switch load-balance
term ``E * sum_e mean_t(p_e) * f_e`` with ``f_e`` counted from the chosen
indices (no gradient). Top-k ties break to the lower expert index, as
``lax.top_k`` does: a stable descending sort, then the first k columns.

Dispatch is dropless: the (token, slot) pairs are sorted by expert
(stably), the tokens gathered into contiguous per-expert rows, and each
non-empty expert runs its SwiGLU over its rows with plain products on its
own slices of the stacked weights (the reference's ``ragged_dot``, which
is no Pallas kernel). The per-expert row counts are read on the host
once per call. The combine inverts the sort, gathers each token's k
output rows and sums them in slot order, weighted by the renormalised
probabilities cast to the activations' dtype: deterministic, without
atomics (the reference scatter-adds in pair order, which in bf16 rounds
in another order).

Under recomputation (``cfg.remat`` "block") a layer's forward records
its routing and the backward's recomputation takes it back
(``routing_contexts``): where a layer's ops do not repeat bit for bit
(on the card, the plain cluster attention's ``index_add_`` accumulates
with atomics), a recomputed router logit near a top-k tie would route a
token elsewhere than the forward did.

Expert parallelism (``_ep_local``, the mesh branch of ``moe_apply``):
under a mesh context whose "model" axis has P > 1 ranks, rank m owns
experts ``[m E/P, (m+1) E/P)``: the whole stacks (it uses its slice) or
only its own (``MoE(cfg, experts=(m, P))``, the parameters' storage on a
mesh). Every rank routes every token of its model group; an expert
takes ``c_e = ceil(T k cf / E)`` pairs (T the group's tokens, ``cf``
the capacity factor, 1.25 by default), filled in the stable expert
sort of the (token, slot) pairs, and the pairs past it **drop** (the
reference's GShard dispatch; only the single-rank path is dropless).
The local experts run as one batched product over (E/P, c_e, D)
buffers, and each token sums its slots' weighted outputs in slot order
(gathers, no atomics). Under the training recipes the tokens arrive
sequence-sharded over "model" (the reference's "scatter" mode): they
are all-gathered in (``GatherSeq``) and the partial outputs
reduce-scattered over the sequence (``ScatterSeq``); under the serving
recipes they arrive whole on every rank and the partial outputs are
summed. The balance term is the mean over every rank of the mesh, as
the reference's ``pmean``; on a mesh without a model axis the dropless
path's term is computed from the statistics of every rank's tokens, as
the reference's one program computes it over the global batch.

Under a fake mode (``repro_torch.fake``, the sweep's traced step) no
count can be read: the counts are scattered into fixed bins instead of
``bincount``'s data-dependent length, the dropless path takes the
reference's static shapes (the T k rows split evenly over the experts),
and the expert-parallel combine writes
through a padded index instead of a boolean mask. Real tensors never
take these branches.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import fake
from repro_torch.models import layers as L
from repro_torch.parallel import axes as pax
from repro_torch.parallel import collectives as C

F32 = torch.float32

# the routing record of the recomputed region running on this thread
_local = threading.local()
# the pairs this process's last expert-parallel call dropped on its own
# experts (a device tensor, read when wanted)
LAST_CALL = {"dropped": None}


def _bincount(idx, n: int):
    """The counts of ``idx`` (values below ``n``) in ``n`` bins; on a fake
    tensor scattered into the bins, whose number is known."""
    if fake.is_fake(idx):
        return torch.zeros(n, dtype=torch.int64, device=idx.device) \
            .scatter_add_(0, idx, torch.ones_like(idx))
    return torch.bincount(idx, minlength=n)


def _host_counts(idx, n: int) -> list:
    """The counts of ``idx`` in ``n`` bins on the host; a fake tensor has
    none, and its ``len(idx)`` rows are split evenly (the reference's
    static shapes)."""
    if fake.is_fake(idx):
        q, r = divmod(idx.numel(), n)
        return [q + (e < r) for e in range(n)]
    return torch.bincount(idx, minlength=n).tolist()


def moe_defs(cfg) -> dict:
    """``{name: (shape, init)}`` of one MoE FFN: the reference's
    ``moe_defs`` names, shapes and init families. ``fan_in`` scales by
    the first axis, which for the (E, D, F) stacks is ``E ** -0.5``, as
    in the reference."""
    E, D, FF = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    defs = {
        "router": ((D, E), "fan_in"),
        "w_gate": ((E, D, FF), "fan_in"),
        "w_up": ((E, D, FF), "fan_in"),
        "w_down": ((E, FF, D), "fan_in"),
    }
    if cfg.moe_shared_experts:
        defs.update(L.mlp_defs(cfg, "shared.",
                               FF * cfg.moe_shared_experts))
    return defs


class MoE(nn.Module):
    """The parameters of :func:`moe_defs`, under the same names (the
    shared experts as an :class:`layers.MLP` named ``shared``).
    ``experts=(m, P)`` holds only expert part m of P of the stacks
    (``E / P`` experts from ``m E / P``; each stack carries the part as
    ``expert_part``), the storage of rank m of a P-way model axis."""

    def __init__(self, cfg, *, device=None, experts=None):
        super().__init__()
        E, D, FF = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
        n = E
        if experts is not None:
            m, parts = experts
            if E % parts or not 0 <= m < parts:
                raise ValueError(f"expert part {m} of {parts} of {E} "
                                 f"experts")
            n = E // parts
        self.router = nn.Parameter(torch.empty(D, E, device=device))
        self.w_gate = nn.Parameter(torch.empty(n, D, FF, device=device))
        self.w_up = nn.Parameter(torch.empty(n, D, FF, device=device))
        self.w_down = nn.Parameter(torch.empty(n, FF, D, device=device))
        if experts is not None:
            for w in (self.w_gate, self.w_up, self.w_down):
                w.expert_part = tuple(experts)
        if cfg.moe_shared_experts:
            self.shared = L.MLP(cfg, FF * cfg.moe_shared_experts,
                                device=device)


@contextlib.contextmanager
def _routing(routes: list, replay: bool):
    """This thread's MoE calls record into ``routes``, or replay it."""
    saved = getattr(_local, "routes", None), getattr(_local, "replay", None)
    _local.routes, _local.replay = routes, (iter(routes) if replay else None)
    try:
        yield
    finally:
        _local.routes, _local.replay = saved


def routing_contexts():
    """The ``context_fn`` of a checkpoint whose function calls the MoE
    (``layers.maybe_remat``'s ``contexts``): the forward records every
    routing decision (each call's top-k expert indices, in call order),
    and the recomputation, in the backward, takes the forward's back in
    the same order instead of choosing again. The router's probabilities
    are recomputed for the gradient; only the choice is kept. Without
    it, a recomputed logit that rounds otherwise than the first time (an
    op that accumulates with atomics on the card) routes a token near a
    top-k tie to another expert, and the experts' row counts no longer
    match the forward's."""
    routes = []
    return _routing(routes, False), _routing(routes, True)


def _top_k(probs, k: int):
    """(T, E) -> the top-k expert indices (T, k) in ``lax.top_k``'s order
    (descending, ties to the lower index: a stable descending sort); the
    forward's own inside a recomputation (``routing_contexts``). The sort
    runs without grad, so both passes save the same tensors."""
    replay = getattr(_local, "replay", None)
    if replay is not None:
        return next(replay)
    topi = torch.argsort(probs.detach(), dim=-1, descending=True,
                         stable=True)[:, :k]
    routes = getattr(_local, "routes", None)
    if routes is not None:
        routes.append(topi)
    return topi


def _route(router_w, xt, k: int, *, group=None):
    """xt (T, D) -> (renormalised top-k probabilities (T, k) fp32, expert
    indices (T, k) int64, aux loss () fp32). With ``group`` the aux
    term's statistics (the mean probabilities, the choice counts) are
    those of every rank's tokens in the group (equal token counts), the
    same term on every rank; each rank's backward carries its own
    tokens' share."""
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    topi = _top_k(probs, k)
    topv = probs.gather(-1, topi)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    E = probs.shape[-1]
    pe = probs.mean(0)
    fe = _bincount(topi.reshape(-1), E).to(F32)
    if group is not None:
        pe = C.SumAcross.apply(pe / C.size(group), group)
        fe = C.all_reduce_(fe, group)
    fe = fe / torch.clamp(fe.sum(), min=1.0)
    aux = E * torch.sum(pe * fe)
    return topv, topi, aux


def _expert_ffn(xg, sizes: list, w_gate, w_up, w_down):
    """Each expert's SwiGLU over its contiguous rows of ``xg`` (T*k, D),
    ``sizes[e]`` rows for expert e (host ints): the reference's
    ``_expert_ffn`` over ``ragged_dot``. The stacks are cast to the
    activations' dtype once and unbound once, so the backward assembles
    each stack's gradient in one piece."""
    dt = xg.dtype
    wg, wu, wd = (w.to(dt).unbind(0) for w in (w_gate, w_up, w_down))
    live = [e for e, n in enumerate(sizes) if n]
    rows = [r for r in xg.split(sizes) if r.shape[0]]
    g = torch.cat([r @ wg[e] for e, r in zip(live, rows)])
    u = torch.cat([r @ wu[e] for e, r in zip(live, rows)])
    h = F.silu(g.float()).to(dt) * u
    hs = h.split([sizes[e] for e in live])
    return torch.cat([r @ wd[e] for e, r in zip(live, hs)])


def moe_tokens(p: MoE, cfg, xt, group=None):
    """Dropless single-device MoE over flat tokens xt (T, D): ``(y (T, D)
    in xt's dtype, aux)``. One host read of the per-expert row counts.
    ``group``: the ranks whose tokens the aux term's statistics span
    (:func:`_route`)."""
    T, D = xt.shape
    k, E = cfg.moe_top_k, cfg.moe_experts
    if p.w_gate.shape[0] != E:
        raise ValueError(f"the dropless path needs all {E} experts, this "
                         f"module holds {p.w_gate.shape[0]}")
    topv, topi, aux = _route(p.router, xt, k, group=group)
    fe = topi.reshape(-1)                                       # (T*k,)
    order = torch.sort(fe, stable=True).indices
    sizes = _host_counts(fe, E)
    # pair j is (token j // k, slot j % k); gathering through the
    # permutation keeps every gradient row a single write
    xg = xt.unsqueeze(1).expand(T, k, D).reshape(T * k, D)[order]
    yo = _expert_ffn(xg, sizes, p.w_gate, p.w_up, p.w_down)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=order.device)
    yp = (yo[inv] * topv.reshape(-1, 1).to(yo.dtype)).view(T, k, D)
    y = yp[:, 0]
    for j in range(1, k):                      # slot order, no atomics
        y = y + yp[:, j]
    return y, aux


def capacity(T: int, cfg, cf: float) -> int:
    """Pairs an expert takes on the expert-parallel path: the reference's
    ``max(1, ceil(T k cf / E))``, T the model group's tokens."""
    return int(max(1, -(-T * cfg.moe_top_k * cf // max(cfg.moe_experts,
                                                        1))))


def _local_stacks(p: MoE, cfg, m: int, ep: int):
    """Rank m's expert stacks (E/P, ...) of ``p``: its slice of the whole
    stacks, or the stacks themselves when ``p`` holds part m of P."""
    E = cfg.moe_experts
    e_loc = E // ep
    stacks = (p.w_gate, p.w_up, p.w_down)
    if p.w_gate.shape[0] == E:
        return tuple(w[m * e_loc:(m + 1) * e_loc] for w in stacks)
    part = getattr(p.w_gate, "expert_part", None)
    if part != (m, ep):
        raise ValueError(f"rank {m} of a {ep}-way model axis needs its "
                         f"{e_loc} experts, the module holds part {part} "
                         f"({p.w_gate.shape[0]} experts)")
    return stacks


def _ep_local(p: MoE, cfg, xt, *, m: int, ep: int, cf: float):
    """Rank m's part of the expert-parallel MoE over the model group's
    tokens xt (T, D): ``(partial y (T, D) from its E/P experts, aux)``.
    The reference's ``_ep_local``: slot-indexed dispatch into (E/P, c_e,
    D) buffers, capacity ``c_e`` a local expert, over-capacity pairs
    dropped in the stable expert sort of the pairs."""
    T, D = xt.shape
    k = cfg.moe_top_k
    e_loc = cfg.moe_experts // ep
    c_e = capacity(T, cfg, cf)
    dev = xt.device
    topv, topi, aux = _route(p.router, xt, k)
    mine = topi // e_loc == m
    fe = torch.where(mine, topi - m * e_loc, e_loc).reshape(-1)  # (T*k,)
    order = torch.sort(fe, stable=True).indices     # the pairs by expert
    gs = _bincount(fe, e_loc + 1)[:e_loc]
    LAST_CALL["dropped"] = (gs - c_e).clamp(min=0).sum()
    starts = torch.cumsum(gs, 0) - gs
    ar = torch.arange(c_e, device=dev)
    valid = ar[None, :] < gs[:, None]                          # (E/P, c_e)
    pair = order[(starts[:, None] + ar[None, :]).clamp(max=T * k - 1)]
    slot_tok = torch.where(valid, pair // k, 0)
    buf = xt[slot_tok.reshape(-1)].view(e_loc, c_e, D) \
        * valid[..., None].to(xt.dtype)
    dt = xt.dtype
    wg, wu, wd = (w.to(dt) for w in _local_stacks(p, cfg, m, ep))
    h = F.silu(torch.bmm(buf, wg).float()).to(dt) * torch.bmm(buf, wu)
    out = torch.bmm(h, wd).reshape(e_loc * c_e, D)
    # combine: each pair reads the slot it filled (a zero row when it
    # dropped or belongs to another rank), weighted, summed in slot order
    where = torch.full((T * k,), e_loc * c_e, dtype=torch.long, device=dev)
    slots = torch.arange(e_loc * c_e, device=dev)
    if fake.is_fake(valid):
        # a mask's selection has a data-dependent length: the empty
        # slots write to a padding row past the pairs instead
        where = torch.cat([where, where.new_zeros(1)])
        where[torch.where(valid, pair, T * k).reshape(-1)] = slots
        where = where[:T * k]
    else:
        where[pair[valid]] = slots[valid.reshape(-1)]
    out = torch.cat([out, out.new_zeros(1, D)])
    w = torch.where(mine, topv, 0.0).to(dt)
    yp = out[where].view(T, k, D) * w[..., None]
    y = yp[:, 0]
    for j in range(1, k):                      # slot order, no atomics
        y = y + yp[:, j]
    return y, aux


def dropped_pairs(p: MoE, cfg, xt, ep: int, cf: float) -> int:
    """The (token, slot) pairs the expert-parallel path drops over tokens
    xt (T, D) on a ``ep``-way model axis: a host recount from the
    routing (each expert's pairs past its capacity)."""
    with torch.no_grad():
        _, topi, _ = _route(p.router, xt, cfg.moe_top_k)
    counts = _host_counts(topi.reshape(-1), cfg.moe_experts)
    c_e = capacity(xt.shape[0], cfg, cf)
    return sum(max(0, n - c_e) for n in counts)


def moe_apply(p: MoE, cfg, x, *, capacity_factor: float = 1.25):
    """x (B, S, D) -> ``(y (B, S, D), aux)``, plus the shared experts'
    MLP when the config has them. Outside a mesh context, or on a mesh
    without a model axis, the dropless path; under one with a P-way
    model axis the expert-parallel path at ``capacity_factor`` (P must
    divide the experts; anything else raises)."""
    ep = pax.mesh_axis_size("experts")
    B, S, D = x.shape
    if ep == 1:
        y, aux = moe_tokens(p, cfg, x.reshape(-1, D), pax.mesh_group())
        y = y.reshape(B, S, D)
    else:
        E = cfg.moe_experts
        if E % ep:
            raise ValueError(f"{cfg.name}: {E} experts do not split over a "
                             f"{ep}-way model axis")
        group = pax.model_group()
        recipe = pax.current()[0]
        # "scatter" mode: the tokens are sequence-sharded over the group
        scatter = recipe.acts.get("seq_outer") == "model"
        xx = C.GatherSeq.apply(x, group) if scatter else x
        y, aux = _ep_local(p, cfg, xx.reshape(-1, D), m=C.rank(group),
                           ep=ep, cf=capacity_factor)
        y = y.view(xx.shape)
        y = C.ScatterSeq.apply(y, group) if scatter else \
            C.SumAcross.apply(y, group)
        world = pax.mesh_group()
        aux = C.SumAcross.apply(aux / C.size(world), world)
    if cfg.moe_shared_experts:
        y = y + L.mlp(p.shared, x)
    return y, aux
