"""AdamW with decoupled weight decay and a warmup-cosine schedule — the
port of ``repro.optim.adamw`` with fp32 moments.

The update is the reference's, leaf by leaf: ``b1 = 0.9``, ``b2 = 0.95``,
``eps = 1e-8``, bias-corrected moments, decay applied to every parameter
(``delta = m_hat / (sqrt(v_hat) + eps) + wd * p``), and the learning rate
read at ``lr(step + 1)``. Parameters are updated in place. The reference's
``bfloat16`` and blockwise-``int8`` moments are not ported yet.
"""

from __future__ import annotations

import math

import torch


class AdamW:
    def __init__(self, params, lr, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 state_dtype: str = "float32"):
        if state_dtype != "float32":
            raise NotImplementedError(
                f"AdamW moments in {state_dtype} are not ported yet "
                f"(ROADMAP.md); use float32")
        self.params = list(params)
        self.lr = lr            # float or callable(step) -> float
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.m = [torch.zeros_like(p, dtype=torch.float32)
                  for p in self.params]
        self.v = [torch.zeros_like(p, dtype=torch.float32)
                  for p in self.params]
        self.step = 0

    @torch.no_grad()
    def update(self, grads, *, midway=None) -> None:
        """One step with ``grads`` (one tensor per parameter, in order).
        ``midway``, when given, is called once after the first half of the
        parameters (and their moments) has been written: the fault plan's
        ``preempt`` hook point, where the state is torn."""
        self.step += 1
        lr = self.lr(self.step) if callable(self.lr) else self.lr
        c1 = 1.0 - self.b1 ** self.step
        c2 = 1.0 - self.b2 ** self.step
        half = len(self.params) // 2
        for i, (p, g, m, v) in enumerate(zip(self.params, grads, self.m,
                                             self.v)):
            if i == half and midway is not None:
                midway()
            g = g.float()
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            delta = (m / c1) / ((v / c2).sqrt() + self.eps) \
                + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)

    def state_dict(self) -> dict:
        """``{"m": [...], "v": [...], "step": int}``: the live moment
        tensors, one per parameter in order (the reference's
        ``{"m", "v", "step"}`` state; the trainer names and stacks them
        into its tree)."""
        return {"m": list(self.m), "v": list(self.v), "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        """Copy ``d``'s moments into the existing tensors (references to
        them stay valid) and take its step."""
        for name in ("m", "v"):
            mine, theirs = getattr(self, name), d[name]
            if len(theirs) != len(mine):
                raise ValueError(f"{len(theirs)} {name} moments for "
                                 f"{len(mine)} parameters")
            for a, b in zip(mine, theirs):
                if a.shape != b.shape:
                    raise ValueError(f"{name} moment of shape "
                                     f"{tuple(b.shape)} for a parameter of "
                                     f"shape {tuple(a.shape)}")
                a.copy_(b)
        self.step = int(d["step"])


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
