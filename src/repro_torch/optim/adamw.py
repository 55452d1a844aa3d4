"""AdamW with decoupled weight decay, optional reduced-precision moments
and a warmup-cosine schedule — the port of ``repro.optim.adamw``.

The update is the reference's, leaf by leaf: ``b1 = 0.9``, ``b2 = 0.95``,
``eps = 1e-8``, bias-corrected moments, decay applied to every parameter
(``delta = m_hat / (sqrt(v_hat) + eps) + wd * p``), and the learning rate
read at ``lr(step + 1)``. Parameters are updated in place.

``state_dtype`` is the reference's (``float32 | bfloat16 | int8``).
Moments are read into fp32, updated in fp32 and written back:

* ``float32``: one fp32 moment per parameter, updated in place;
* ``bfloat16``: one bf16 moment per parameter, written back by
  round-to-nearest-even;
* ``int8``: blockwise symmetric quantization (the 8-bit-Adam trick): the
  flattened moment in blocks of ``Q_BLOCK`` = 256, each block's scale
  ``max|x| / 127`` in fp32, ``q = clip(round(x / max(scale, 1e-12)),
  -127, 127)`` rounded half to even, the last block zero-padded; a
  moment is ``{"q": int8 (n_blocks, 256), "s": fp32 (n_blocks, 1)}``.

The reference quantizes each leaf of its parameter tree, and a stacked
leaf (``layers``, ``periods``: ``(L, ...)``) is ONE leaf, so a block may
straddle two layers. ``groups`` (lists of parameter indices, each one
reference leaf with its layers in order; ``convert.leaf_groups``) says
which of the port's per-layer parameters make one leaf: an int8 moment
quantizes the concatenation of its group's flattened parameters, the
C-order flatten of the stacked array. Without ``groups`` every parameter
is a leaf of its own.

The reduced-precision update works through a group in slices of
``SLICE`` elements (whole blocks): the blocks are independent, so the
result is the same as in one go, and its fp32 temporaries stay a few
slices whatever the leaf's size (a 1e9-parameter embedding would need
4 GB for each otherwise).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Q_BLOCK = 256
STATE_DTYPES = ("float32", "bfloat16", "int8")
SLICE = 1 << 24     # elements of one slice of the reduced-precision update


def quantize8(x):
    """Blockwise symmetric int8 quantization of a flat fp32 ``x``,
    zero-padded to whole blocks: ``(q int8 (n_blocks, Q_BLOCK), s fp32
    (n_blocks, 1))`` (the reference's ``_quantize8``)."""
    fp = F.pad(x, (0, (-x.numel()) % Q_BLOCK)).view(-1, Q_BLOCK)
    scale = fp.abs().amax(1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(fp / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def dequantize8(q, s, n: int):
    """The first ``n`` values of a quantized moment's blocks, flat fp32
    (the reference's ``_deq_static``)."""
    return (q.float() * s).view(-1)[:n]


def _pieces(sizes, a: int, b: int):
    """``(j, lo, hi)``: the part ``[lo, hi)`` of flat tensor ``j`` that
    the window ``[a, b)`` of the tensors' concatenation covers."""
    off = 0
    for j, n in enumerate(sizes):
        lo, hi = max(a, off), min(b, off + n)
        if lo < hi:
            yield j, lo - off, hi - off
        off += n


def _gather(flats, pieces):
    parts = [flats[j][lo:hi] for j, lo, hi in pieces]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _scatter(flats, pieces, x) -> None:
    """Write ``x`` back over the pieces of ``flats`` it was gathered
    from, cast to their dtype."""
    at = 0
    for j, lo, hi in pieces:
        flats[j][lo:hi].copy_(x[at:at + hi - lo])
        at += hi - lo


class AdamW:
    def __init__(self, params, lr, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 state_dtype: str = "float32", groups=None):
        if state_dtype not in STATE_DTYPES:
            raise ValueError(f"state_dtype {state_dtype!r} not in "
                             f"{STATE_DTYPES}")
        self.params = list(params)
        self.lr = lr            # float or callable(step) -> float
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.state_dtype = state_dtype
        self.groups = ([[i] for i in range(len(self.params))]
                       if groups is None else [list(g) for g in groups])
        if sorted(i for g in self.groups for i in g) != \
                list(range(len(self.params))):
            raise ValueError("groups must hold every parameter once")
        # groups run in the order of their first parameter
        self.groups.sort(key=lambda g: g[0])
        # m and v: one tensor per parameter (float32, bfloat16), or one
        # {"q", "s"} per group (int8)
        self.m = self._zeros()
        self.v = self._zeros()
        self.step = 0

    def _zeros(self) -> list:
        if self.state_dtype != "int8":
            dt = getattr(torch, self.state_dtype)
            return [torch.zeros_like(p, dtype=dt) for p in self.params]
        out = []
        for g in self.groups:
            n = sum(self.params[i].numel() for i in g)
            dev = self.params[g[0]].device
            nb = -(-n // Q_BLOCK)
            out.append({"q": torch.zeros((nb, Q_BLOCK), dtype=torch.int8,
                                         device=dev),
                        "s": torch.zeros((nb, 1), device=dev)})
        return out

    @torch.no_grad()
    def update(self, grads, *, midway=None) -> None:
        """One step with ``grads`` (one tensor per parameter, in order),
        group by group. ``midway``, when given, is called once just
        before the group that holds parameter ``len(params) // 2`` is
        written (with one parameter a group: after the first half of the
        parameters and their moments): the fault plan's ``preempt`` hook
        point, where the state is torn."""
        self.step += 1
        lr = self.lr(self.step) if callable(self.lr) else self.lr
        c1 = 1.0 - self.b1 ** self.step
        c2 = 1.0 - self.b2 ** self.step
        half = len(self.params) // 2
        for k, g in enumerate(self.groups):
            if midway is not None and half in g:
                midway()
            if self.state_dtype == "float32":
                for i in g:
                    self._update_fp32(self.params[i], grads[i], self.m[i],
                                      self.v[i], lr, c1, c2)
            else:
                self._update_sliced(k, g, grads, lr, c1, c2)

    def _update_fp32(self, p, g, m, v, lr, c1, c2) -> None:
        g = g.float()
        m.mul_(self.b1).add_(g, alpha=1 - self.b1)
        v.mul_(self.b2).add_((1 - self.b2) * g * g)
        delta = (m / c1) / ((v / c2).sqrt() + self.eps) \
            + self.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    def _update_sliced(self, k: int, group, grads, lr, c1, c2) -> None:
        """The reduced-precision update of group ``k`` (parameters
        ``group``), in slices of whole blocks of the group's flattened
        concatenation, with the reference's arithmetic in fp32."""
        ps = [self.params[i].view(-1) for i in group]
        gs = [grads[i].reshape(-1) for i in group]
        sizes = [p.numel() for p in ps]
        n = sum(sizes)
        for a in range(0, n, SLICE):
            b = min(a + SLICE, n)
            pieces = list(_pieces(sizes, a, b))
            g = _gather(gs, pieces).float()
            p = _gather(ps, pieces).float()
            m = self.b1 * self._read(self.m, k, group, pieces, a, b) \
                + (1 - self.b1) * g
            v = self.b2 * self._read(self.v, k, group, pieces, a, b) \
                + (1 - self.b2) * g * g
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps) \
                + self.weight_decay * p
            _scatter(ps, pieces, p - lr * delta)
            self._write(self.m, k, group, pieces, a, m)
            self._write(self.v, k, group, pieces, a, v)

    def _read(self, moments, k, group, pieces, a, b):
        if self.state_dtype == "int8":
            s = moments[k]
            lo, hi = a // Q_BLOCK, -(-b // Q_BLOCK)
            return dequantize8(s["q"][lo:hi], s["s"][lo:hi], b - a)
        return _gather([moments[i].view(-1) for i in group],
                       pieces).float()

    def _write(self, moments, k, group, pieces, a, x) -> None:
        if self.state_dtype == "int8":
            q, s = quantize8(x)
            lo = a // Q_BLOCK
            moments[k]["q"][lo:lo + q.shape[0]] = q
            moments[k]["s"][lo:lo + q.shape[0]] = s
        else:
            _scatter([moments[i].view(-1) for i in group], pieces, x)

    def state_tensors(self) -> list:
        """Every moment tensor (``q`` and ``s`` of an int8 one), m's then
        v's."""
        out = []
        for t in (*self.m, *self.v):
            out.extend((t["q"], t["s"]) if isinstance(t, dict) else (t,))
        return out

    def state_dict(self) -> dict:
        """``{"m": [...], "v": [...], "step": int}``: the live moments, one
        tensor per parameter in order (float32, bfloat16) or one ``{"q",
        "s"}`` per group in ``groups`` order (int8): the reference's
        ``{"m", "v", "step"}`` state; the trainer names and stacks them
        into its tree."""
        return {"m": list(self.m), "v": list(self.v), "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        """Copy ``d``'s moments (as :meth:`state_dict` gives them) into the
        existing tensors (references to them stay valid) and take its
        step. Shapes and dtypes must be this optimizer's; every moment is
        checked before any is copied."""
        pairs = []
        for name in ("m", "v"):
            mine, theirs = getattr(self, name), d[name]
            if len(theirs) != len(mine):
                what = "groups" if self.state_dtype == "int8" else \
                    "parameters"
                raise ValueError(f"{len(theirs)} {name} moments for "
                                 f"{len(mine)} {what}")
            for a, b in zip(mine, theirs):
                both = [(a[k], b[k]) for k in ("q", "s")] \
                    if isinstance(a, dict) else [(a, b)]
                for x, y in both:
                    if x.shape != y.shape:
                        raise ValueError(f"{name} moment of shape "
                                         f"{tuple(y.shape)} for one of "
                                         f"shape {tuple(x.shape)}")
                    if x.dtype != y.dtype:
                        raise ValueError(f"{name} moment in {y.dtype} for "
                                         f"state_dtype {self.state_dtype}")
                pairs.extend(both)
        for a, b in pairs:
            a.copy_(b)
        self.step = int(d["step"])

    @torch.no_grad()
    def zero_(self) -> None:
        """Zero moments in their layout (an int8 zero is ``q = 0``, ``s =
        0``, as the reference's ``init`` gives it)."""
        for t in self.state_tensors():
            t.zero_()


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor * peak`` at ``total``."""
    def sched(step):
        step = float(step)
        if step < warmup:
            return peak * step / max(warmup, 1)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return floor * peak + (1 - floor) * peak * 0.5 * (
            1 + math.cos(math.pi * frac))
    return sched
