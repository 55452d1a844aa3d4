"""Error-feedback gradient compression for the data-parallel all-reduce:
the port of ``repro.optim.compress`` on a ``torch.distributed`` group
over "data" (one process a rank).

Two codecs, each with an error-feedback residual (what the codec lost is
added back to the next step's gradient):

* int8: each 256-block of the gradient quantised to int8 against its
  own scale (``max |x| / 127``, round half to even as ``jnp.round``);
  the ranks' dequantised blocks are summed and divided by the group's
  size. The reference widens the int8 payload to int32 and multiplies
  it by its fp32 scale before its ``psum``, so its wire carries fp32,
  and so does the port's: one fp32 all-reduce of the dequantised
  blocks. Summing int8 codes on the wire would need per-rank scales
  summed in integers, another function that neither package has.
* topk: the ``frac`` largest-magnitude entries of each tensor kept (the
  rest left in the residual), the kept dense tensor averaged over the
  group (fp32 on the wire too).

The bytes a rank hands to the all-reduce are counted in
``collectives.BYTES["all_reduce"]``. Nothing in the port's Trainer
calls this, as nothing in the reference's does.
"""

from __future__ import annotations

import torch

from repro_torch.parallel import collectives as C

F32 = torch.float32
BLOCK = 256


def int8_encode(x, block: int = BLOCK):
    """``x`` -> (codes (n_blocks, block) int8, scales (n_blocks, 1) fp32,
    the dequantised ``x``): the reference's ``_int8_encode``."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = fp.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(fp / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    deq = (q * scale).reshape(-1)[:flat.numel()].reshape(x.shape)
    return q.to(torch.int8), scale, deq


def compressed_psum_int8(x, group, residual):
    """``(the int8-compressed mean of x over the group, new residual)``:
    the reference's ``compressed_psum_int8``."""
    xin = x.to(F32) + residual
    q, scale, deq = int8_encode(xin)
    qsum = C.all_reduce_(q.to(torch.int32) * scale, group)   # fp32 wire
    mean = (qsum / C.size(group)).reshape(-1)[:x.numel()].reshape(x.shape)
    return mean, xin - deq


def compressed_psum_topk(x, group, residual, frac: float = 0.01):
    """``(the mean over the group of each rank's top-k of x, new
    residual)``: the reference's ``compressed_psum_topk``."""
    xin = x.to(F32) + residual
    flat = xin.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    idx = torch.topk(flat.abs(), k).indices
    kept = torch.zeros_like(flat)
    kept[idx] = flat[idx]
    mean = C.all_reduce_(kept.clone(), group) / C.size(group)
    return mean.reshape(x.shape), (flat - kept).reshape(x.shape)


def make_compressed_grad_fn(loss_fn, group, *, codec: str = "int8",
                            frac: float = 0.01):
    """``fn(params, batch, residuals) -> (loss, grads, new_residuals)``:
    this rank's loss and gradients on its own shard of the batch, each
    gradient reduced over ``group`` by ``codec`` with error feedback,
    and the loss averaged over the group. ``params`` and ``residuals``
    are dicts of tensors (the same on every rank), ``loss_fn(params,
    batch) -> (loss, aux)``."""
    if codec not in ("int8", "topk"):
        raise ValueError(f"codec {codec!r} not in ('int8', 'topk')")

    def reduce(g, r):
        if codec == "int8":
            return compressed_psum_int8(g, group, r)
        return compressed_psum_topk(g, group, r, frac)

    def fn(params, batch, residuals):
        names = list(params)
        loss = loss_fn(params, batch)[0]
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        out = {n: reduce(g, residuals[n]) for n, g in zip(names, grads)}
        loss = C.all_reduce_(loss.detach().to(F32).reshape(1), group)[0] \
            / C.size(group)
        return (loss, {n: o[0] for n, o in out.items()},
                {n: o[1] for n, o in out.items()})

    return fn


def init_residuals(params: dict) -> dict:
    """Zero fp32 residuals shaped like ``params``."""
    return {n: torch.zeros(p.shape, dtype=F32, device=p.device)
            for n, p in params.items()}
