"""Mixture-of-Experts FFN on the port: the port of ``repro.models.moe``'s
single-device path (``moe_defs``, ``_route``, ``_expert_ffn``,
``moe_tokens``, ``moe_apply``).

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

The expert-parallel path of the reference (``_ep_local`` and the mesh
branch of ``moe_apply``) needs a mesh: ``moe_apply`` raises under one
(ROADMAP.md A8 part 2).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L

F32 = torch.float32

# the routing record of the recomputed region running on this thread
_local = threading.local()


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
    shared experts as an :class:`layers.MLP` named ``shared``)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        E, D, FF = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
        self.router = nn.Parameter(torch.empty(D, E, device=device))
        self.w_gate = nn.Parameter(torch.empty(E, D, FF, device=device))
        self.w_up = nn.Parameter(torch.empty(E, D, FF, device=device))
        self.w_down = nn.Parameter(torch.empty(E, FF, D, device=device))
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


def _route(router_w, xt, k: int):
    """xt (T, D) -> (renormalised top-k probabilities (T, k) fp32, expert
    indices (T, k) int64, aux loss () fp32)."""
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    topi = _top_k(probs, k)
    topv = probs.gather(-1, topi)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    E = probs.shape[-1]
    fe = torch.bincount(topi.reshape(-1), minlength=E).to(F32)
    fe = fe / torch.clamp(fe.sum(), min=1.0)
    aux = E * torch.sum(probs.mean(0) * fe)
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


def moe_tokens(p: MoE, cfg, xt):
    """Dropless single-device MoE over flat tokens xt (T, D): ``(y (T, D)
    in xt's dtype, aux)``. One host read of the per-expert row counts."""
    T, D = xt.shape
    k, E = cfg.moe_top_k, cfg.moe_experts
    topv, topi, aux = _route(p.router, xt, k)
    fe = topi.reshape(-1)                                       # (T*k,)
    order = torch.sort(fe, stable=True).indices
    sizes = torch.bincount(fe, minlength=E).tolist()
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


def moe_apply(p: MoE, cfg, x, *, mesh_model: int = 1):
    """x (B, S, D) -> ``(y (B, S, D), aux)``: the dropless single-device
    path, plus the shared experts' MLP when the config has them.
    ``mesh_model`` > 1 (experts sharded over a model axis) is the
    reference's expert-parallel path, which needs a mesh and raises."""
    if mesh_model > 1:
        raise NotImplementedError(
            f"moe_apply with mesh_model={mesh_model}: the expert-parallel "
            f"path is not ported yet (ROADMAP.md A8 part 2)")
    B, S, D = x.shape
    y, aux = moe_tokens(p, cfg, x.reshape(-1, D))
    y = y.reshape(B, S, D)
    if cfg.moe_shared_experts:
        y = y + L.mlp(p.shared, x)
    return y, aux
