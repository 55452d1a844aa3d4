"""Graph transformers on the port (Graphormer-Slim/Large, GT): degree or
Laplacian positional encodings + dual-interleaved attention
(cluster-sparse over the reformation layout, or dense with the
structural bias) — the port of ``repro.core.graph_model``
(``graph_defs``, ``graph_forward``, ``apply_head``, ``graph_predict``,
``graph_loss``, ``with_dense_bias``, ``graph_loss_dense`` and the
model's ``loss_variants``), each layer recomputed in the backward unless
``cfg.remat`` is ``"none"``.

Batch layout (built by data/graph_pipeline.py, moved to the device by
:func:`batch_to_torch`):
  feat       (B, S, F)      node features, zeros at global/pad positions
  in_deg     (B, S)         clipped degrees (0 at global/pad)
  out_deg    (B, S)
  lap_pe     (B, S, 8)      Laplacian positional encodings (GT only)
  block_idx  (B, nq, mb)    cluster-sparse layout, int32
  buckets    (B, nq, mb, bq, bk) int8 bias/mask buckets
  block_idx_t (B, nk, mt, 2) transposed layout (the dK/dV backward)
  labels     (B, S)         -1 = masked (global tokens, padding, test nodes)
  dense_buckets (B, S, S) int8  scattered buckets (the dense step's bias)

Parameters are fp32; compute runs in ``cfg.dtype``.

Under a mesh (``parallel.axes.axis_rules``) the batch holds this rank's
S/P contiguous tokens of the per-node arrays (``dense_buckets`` its
rows) and the whole layouts (of its data shard's graphs), and the
forward is the reference's sharded one: the global tokens only at global positions below
``n_global``, the sparse step through ``sharded_cluster_attention``,
the dense step sequence-parallel, and ``graph_loss`` the mean over every
rank's tokens. Where the sparse step cannot shard (heads or blocks that
do not split over the group), each rank all-gathers q, k and v and runs
the unsharded op on the whole sequence, keeping its own rows: the
counterpart of the reference's GSPMD fallback, which computes the whole
attention on every rank too. A sequence that does not split over the
group at all stays whole on every rank (``tasks`` keep it so, and the
recipe says so: ``pax.seq_group()`` is None), and every rank runs the
single-device forward on it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.core.dual_attention import dense_bias_from_buckets
from repro_torch.device import resolve
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.parallel import axes as pax
from repro_torch.parallel import collectives as C
from repro_torch.parallel.cluster_parallel import (can_shard_cluster,
                                                   sharded_cluster_attention)
from repro_torch.parallel.ulysses import seqpar_attention

# numpy batch arrays -> the torch dtype each lives in on the device
_BATCH_DTYPES = {"feat": torch.float32, "in_deg": torch.long,
                 "out_deg": torch.long, "lap_pe": torch.float32,
                 "block_idx": torch.int32, "buckets": torch.int8,
                 "block_idx_t": torch.int32, "labels": torch.long,
                 "dense_buckets": torch.int8}
PE_DIM = 8    # Laplacian eigenvectors GT projects (encodings.lap_pe's k)


def _n_buckets(cfg) -> int:
    # SPD: hop counts 0..max_spd + the global-token virtual-distance bucket
    return (cfg.max_spd + 2) if cfg.graph_bias == "spd" else 3


def graph_defs(cfg) -> dict:
    """``{name: (shape, init)}`` of every parameter, per layer for the
    ``layers.*`` entries (the model holds ``n_layers`` of each). Shapes
    and init families are the reference's: ``fan_in`` is a normal scaled
    by ``shape[0] ** -0.5``, ``normal``/``embed`` a normal scaled by 0.02."""
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    defs = {
        "feat_proj": ((cfg.feat_dim, D), "fan_in"),
        "global_tok": ((max(cfg.n_global, 1), D), "normal"),
        "layers.attn_norm.scale": ((D,), "ones"),
        "layers.attn.wq": ((D, H, Dh), "fan_in"),
        "layers.attn.wk": ((D, KV, Dh), "fan_in"),
        "layers.attn.wv": ((D, KV, Dh), "fan_in"),
        "layers.attn.wo": ((H, Dh, D), "fan_in"),
        "layers.mlp_norm.scale": ((D,), "ones"),
        "layers.mlp.w_gate": ((D, cfg.d_ff), "fan_in"),
        "layers.mlp.w_up": ((D, cfg.d_ff), "fan_in"),
        "layers.mlp.w_down": ((cfg.d_ff, D), "fan_in"),
        "final_norm.scale": ((D,), "ones"),
        "head": ((D, cfg.n_classes), "fan_in"),
    }
    if cfg.name.startswith("graphormer"):
        defs["z_in"] = ((cfg.max_degree, D), "embed")
        defs["z_out"] = ((cfg.max_degree, D), "embed")
    if cfg.graph_bias:
        defs["bias_table"] = ((cfg.n_heads, _n_buckets(cfg)), "zeros")
    if cfg.name.startswith("gt"):
        defs["pe_proj"] = ((PE_DIM, D), "fan_in")
    return defs


class GraphLayer(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.attn_norm = L.RMSNorm(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, device=device)
        self.mlp_norm = L.RMSNorm(cfg.d_model, device=device)
        self.mlp = L.MLP(cfg, device=device)


class GraphModel(nn.Module):
    """A graph transformer with the reference's parameter names and
    shapes, so a JAX parameter tree loads through
    ``convert.params_from_jax``. ``seed`` drives the port's own init (same
    shapes and init families as the reference, other random numbers)."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.family != "graph":
            raise ValueError(f"GraphModel is the graph family, got "
                             f"{cfg.family!r}")
        dev = resolve(device)
        self.cfg = cfg
        defs = graph_defs(cfg)
        for name, (shape, _) in defs.items():
            if "." not in name:
                setattr(self, name, nn.Parameter(torch.empty(shape,
                                                             device=dev)))
        self.layers = nn.ModuleList(GraphLayer(cfg, device=dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device=dev)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.head.device

    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded init (``layers.seeded_init``)."""
        L.seeded_init(self, graph_defs(self.cfg), seed)

    @property
    def loss_variants(self) -> dict:
        """The named losses a task trains: ``{"sparse", "dense"}``, each
        ``fn(model, batch) -> (loss, metrics)``."""
        return LOSS_VARIANTS

    def forward(self, batch: dict, *, impl: str | None = None):
        return graph_forward(self, batch, impl=impl)


def batch_to_torch(batch: dict, device, uploads: dict | None = None,
                   shard=None) -> dict:
    """The numpy batch of ``prepare_node_task`` as tensors on ``device``
    (the keys the model reads). ``uploads`` (``id(host array) -> tensor``)
    dedupes uploads of arrays shared between batches; the caller keeps
    the host arrays alive while the dict is in use. ``shard(key, arr)``,
    when given, picks the part of each host array that is uploaded (a
    rank's shard on a mesh), before the upload and its dedup."""
    dev = resolve(device)
    out = {}
    for key, dt in _BATCH_DTYPES.items():
        if key not in batch:
            continue
        arr = batch[key]
        if uploads is not None and id(arr) in uploads:
            out[key] = uploads[id(arr)]
            continue
        host = arr if shard is None else shard(key, arr)
        out[key] = torch.from_numpy(np.ascontiguousarray(host)).to(
            device=dev, dtype=dt)
        if uploads is not None:
            uploads[id(arr)] = out[key]
    return out


def _graph_attn(p: L.Attention, cfg, h, batch, bias_table, dense, impl):
    """Attention of one layer on ``h``, this rank's sequence shard under a
    mesh: the sparse step through :func:`sharded_cluster_attention` (the
    Ulysses all-to-all around the kernels, ``bias_table`` sharded by
    head), the dense step as :func:`seqpar_attention` (this rank's rows
    of ``dense_bias`` against all-gathered k and v)."""
    # the graph configs run no RoPE (rope_theta=0): no positions needed
    q, k, v = L.project_qkv(p, cfg, h, None)
    group = pax.seq_group()
    bias = batch.get("dense_bias")
    if dense and group is None:
        o = L.chunked_attention(q, k, v, bias=bias)
    elif dense:
        o = seqpar_attention(q, k, v, group=group,
                             attn_fn=lambda a, b, c, off:
                             L.chunked_attention(a, b, c, bias=bias))
    elif group is None:
        o = kops.cluster_attention(q, k, v, batch["block_idx"],
                                   batch.get("buckets"), bias_table,
                                   batch.get("block_idx_t"), causal=False,
                                   impl=impl)
    else:
        o = _sharded_sparse(q, k, v, cfg, batch, bias_table, group, impl)
    return L.out_proj(p, o)


def _sharded_sparse(q, k, v, cfg, batch, bias_table, group, impl):
    """The sparse step on a sequence shard (the reference's
    ``_graph_attn`` under a model-axis mesh): the sharded op where the
    shapes shard, else the fallback: q, k and v all-gathered over the
    group (``GatherSeq``, whose backward reduce-scatters their
    gradients), the unsharded op on the whole sequence with the whole
    ``bias_table``, and this rank's rows of its output. The fallback
    computes the whole attention on every rank, as GSPMD's replicated
    fallback does; each rank's ``bias_table`` gradient is its rows'
    share, summed over the ranks by the Trainer's all-reduce."""
    bi, bu = batch["block_idx"], batch.get("buckets")
    p = C.size(group)
    S = q.shape[1] * p
    bq = S // bi.shape[-2]
    bk = bu.shape[-1] if bu is not None else bq
    if pax.current()[0].ulysses and can_shard_cluster(
            cfg.n_heads, cfg.kv_heads, S, p, bq, bk):
        return sharded_cluster_attention(
            q, k, v, bi, bu, bias_table, batch.get("block_idx_t"),
            group=group, bq=bq, bk=bk, impl=impl)
    qf, kf, vf = (C.GatherSeq.apply(x, group) for x in (q, k, v))
    o = kops.cluster_attention(qf, kf, vf, bi, bu, bias_table,
                               batch.get("block_idx_t"), causal=False,
                               impl=impl)
    m, n = C.rank(group), q.shape[1]
    return o[:, m * n:(m + 1) * n]


def _layer(layer: GraphLayer, h, cfg, batch, bias_table, dense, impl):
    """One layer: pre-norm attention and SwiGLU MLP, residual."""
    a = L.rmsnorm(layer.attn_norm, h, cfg.norm_eps)
    h = h + _graph_attn(layer.attn, cfg, a, batch, bias_table, dense, impl)
    m = L.rmsnorm(layer.mlp_norm, h, cfg.norm_eps)
    return h + L.mlp(layer.mlp, m)


def graph_forward(model: GraphModel, batch: dict, *, dense: bool = False,
                  impl: str | None = None):
    """(B, S, D) final-normed hidden states. ``dense`` runs the dense
    interleave step (``batch["dense_bias"]`` biases it, see
    :func:`with_dense_bias`). ``impl="plain"`` runs the sparse
    attention's plain versions on any device (for holding the kernels
    against them). With grad enabled and ``cfg.remat`` other than
    ``"none"``, each layer keeps only its input and is recomputed in the
    backward (a non-reentrant checkpoint), so the sparse forward kernel
    launches twice per layer and step."""
    cfg = model.cfg
    dtype = getattr(torch, cfg.dtype)
    feat = batch["feat"].to(dtype)
    h = feat @ model.feat_proj.to(dtype)
    if hasattr(model, "z_in"):
        h = h + model.z_in[batch["in_deg"]].to(dtype)
        h = h + model.z_out[batch["out_deg"]].to(dtype)
    if hasattr(model, "pe_proj"):
        h = h + batch["lap_pe"].to(dtype) @ model.pe_proj.to(dtype)
    if cfg.n_global:
        # the leading n_global positions are the global tokens (a new
        # tensor rather than a write into h, so autograd sees a plain
        # op); under a mesh only where the *global* position is below
        # n_global, which is on the first ranks' shards
        off = _seq_offset(h.shape[1])
        n = min(max(cfg.n_global - off, 0), h.shape[1])
        if n:
            g = model.global_tok[off:off + n].to(dtype)
            h = torch.cat([g.expand(h.shape[0], -1, -1), h[:, n:]], dim=1)
    bu = batch.get("buckets")
    if bu is not None:
        # the global sequence from the layout; the batch as the data
        # shard gives it
        pax.logical(h, "batch", "seq_outer", "embed", full=(
            h.shape[0] * pax.mesh_axis_size("batch"),
            batch["block_idx"].shape[-2] * bu.shape[-2], h.shape[2]))
    body = functools.partial(_layer, cfg=cfg, batch=batch,
                             bias_table=getattr(model, "bias_table", None),
                             dense=dense, impl=impl)
    # the reference checkpoints each layer unless remat is "none" (it has
    # no "dots" policy here)
    body = L.maybe_remat(body, cfg.replace(remat="block")
                         if cfg.remat == "dots" else cfg)
    for layer in model.layers:
        h = body(layer, h)
    return L.rmsnorm(model.final_norm, h, cfg.norm_eps)


def _seq_offset(local_len: int) -> int:
    """The global position of this rank's first token: its rank in the
    model group times the shard length (0 without a mesh)."""
    group = pax.seq_group()
    return 0 if group is None else C.rank(group) * local_len


def apply_head(model: GraphModel, h):
    """(B, S, D) hidden states -> (B, S, n_classes) logits."""
    return h @ model.head.to(h.dtype)


def graph_predict(model: GraphModel, batch: dict, *,
                  impl: str | None = None):
    return apply_head(model, graph_forward(model, batch, impl=impl))



def graph_loss(model: GraphModel, batch: dict, *, dense: bool = False,
               impl: str | None = None):
    """Node-level masked cross-entropy (labels -1 ignored) and accuracy,
    on fp32 logits: ``(loss, {"xent": loss, "acc": acc})``."""
    h = graph_forward(model, batch, dense=dense, impl=impl)
    logits = apply_head(model, h).float()
    labels = batch["labels"]
    mask = (labels >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    sums = torch.stack([((logz - ll) * mask).sum(), mask.sum(),
                        ((logits.argmax(-1) == labels).float() * mask).sum()])
    group = pax.mesh_group()
    if group is not None:   # the global mean over every rank's shard
        sums = C.SumAcross.apply(sums, group)
    n = sums[1].clamp_min(1.0)
    loss, acc = sums[0] / n, sums[2] / n
    return loss, {"xent": loss, "acc": acc}


def with_dense_bias(model: GraphModel, batch: dict) -> dict:
    """Batch copy with ``dense_bias`` built from the scattered
    ``dense_buckets`` (when present) and the model's ``bias_table``."""
    b = dict(batch)
    bias_table = getattr(model, "bias_table", None)
    if "dense_bias" not in b and b.get("dense_buckets") is not None \
            and bias_table is not None:
        b["dense_bias"] = dense_bias_from_buckets(
            b["dense_buckets"], bias_table, model.cfg.n_heads)
    return b


def graph_loss_dense(model: GraphModel, batch: dict):
    """Dense interleave step (§III-B): fully-connected attention, biased
    where the sparse pattern defines structure."""
    return graph_loss(model, with_dense_bias(model, batch), dense=True)


LOSS_VARIANTS = {"sparse": graph_loss, "dense": graph_loss_dense}
