"""Roofline terms and a model's FLOPs on one NVIDIA H100.

The port of ``repro.launch.roofline``'s model half: ``roofline_terms``,
``active_params`` and ``model_flops``, the same arithmetic on the card's
peaks. The reference's other half (``collective_bytes``,
``_shape_bytes``) parses compiled XLA HLO and has no counterpart here;
the port counts its collectives' bytes as it sends them
(``parallel/collectives.BYTES``).

Hardware model (NVIDIA H100 80GB HBM3 (SXM), 700 W power limit, the
data sheet's dense rates): 989 TFLOP/s bf16 on the tensor cores, 3.35
TB/s HBM3, NVLink 450 GB/s each way.

Terms (per card):

  compute    = flops / PEAK_FLOPS
  memory     = bytes_accessed / HBM_BW
  collective = sum over collective kinds of payload * mult / LINK_BW,
               mult = 2 for all-reduce (reduce and broadcast), else 1.

``active_params`` and ``model_flops`` read the port's parameter
definitions (names and shapes, ``graph_defs``, ``lm_defs``, ...), so a
model is counted without allocating it: Kimi-K2 and InternVL2-76B at
full width count on the CPU.
"""

from __future__ import annotations

import math

PEAK_FLOPS = 989e12   # bf16 dense, NVIDIA H100 80GB HBM3, 700 W
HBM_BW = 3.35e12      # bytes/s, NVIDIA H100 80GB HBM3, 700 W
LINK_BW = 450e9       # bytes/s each way, NVLink, NVIDIA H100 80GB HBM3

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the expert stacks of a MoE FFN (``models/moe.moe_defs``): the
# reference's leaves on its "experts" axis
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def roofline_terms(flops: float, bytes_accessed: float,
                   coll: dict) -> dict:
    """The reference's terms on the card's peaks: ``compute_s``,
    ``memory_s``, ``collective_s`` (``coll`` maps a kind of
    ``COLLECTIVES`` to its payload bytes), the ``dominant`` term, the
    ``step_lower_bound_s`` and the ``roofline_frac``, useful compute over
    the bounding term."""
    coll_time = 0.0
    for c in COLLECTIVES:
        mult = 2.0 if c == "all-reduce" else 1.0
        coll_time += coll.get(c, 0) * mult / LINK_BW
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": coll_time}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["step_lower_bound_s"] = bound
    terms["roofline_frac"] = (t_compute / bound) if bound > 0 else 0.0
    return terms


def family_defs(cfg) -> tuple:
    """``(defs, stacks)`` of ``cfg``'s model: the family's definitions
    (``{name: (shape, init)}``, one layer's for a stacked entry) and the
    number of entries of each stack, by the names' first part."""
    fam = cfg.family
    if fam == "graph":
        from repro_torch.core.graph_model import graph_defs
        defs, stacks = graph_defs(cfg), {"layers": cfg.n_layers}
    elif fam in ("dense", "moe", "vlm"):
        from repro_torch.models.lm import lm_defs
        defs = lm_defs(cfg)
        stacks = {"layers": cfg.n_layers - cfg.n_dense_layers}
    elif fam == "ssm":
        from repro_torch.models.api import ssm_lm_defs
        defs, stacks = ssm_lm_defs(cfg), {"layers": cfg.n_layers}
    elif fam == "hybrid":
        from repro_torch.models.hybrid import hybrid_defs
        defs = hybrid_defs(cfg)
        stacks = {"periods": cfg.n_layers // cfg.attn_every}
    elif fam == "encdec":
        from repro_torch.models.encdec import encdec_defs
        defs = encdec_defs(cfg)
        stacks = {"enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers}
    else:
        raise ValueError(f"no parameter definitions for family {fam!r}")
    return defs, stacks


def param_shapes(cfg) -> list:
    """``[(name, shape, copies)]`` of every parameter of ``cfg``'s model:
    the family's definitions, each per-layer entry held once per layer,
    period or stack entry, as the model holds it."""
    defs, stacks = family_defs(cfg)
    return [(name, tuple(shape), stacks.get(name.split(".", 1)[0], 1))
            for name, (shape, _) in defs.items()]


def active_params(cfg) -> int:
    """Parameters touched per token, the reference's rule: every parameter
    but the token table, with only ``moe_top_k / moe_experts`` of the
    expert stacks (integer division, as the reference's), and the table
    added back when the unembedding reuses it (tied embeddings)."""
    total = expert = embed_tbl = 0
    for name, shape, copies in param_shapes(cfg):
        n = math.prod(shape) * copies
        total += n
        if cfg.moe_experts and len(shape) == 3 \
                and shape[0] == cfg.moe_experts \
                and name.rsplit(".", 1)[-1] in _EXPERT_LEAVES:
            expert += n
        if name.rsplit(".", 1)[-1] == "tok":
            embed_tbl += n
    active = total - embed_tbl
    if cfg.moe_experts:
        active -= expert
        active += expert * cfg.moe_top_k // cfg.moe_experts
    if cfg.tie_embeddings:
        active += embed_tbl
    return int(active)


def model_flops(cfg, shape) -> float:
    """The reference's analytic MODEL_FLOPS of ``shape`` (a ShapeConfig:
    ``kind``, ``global_batch``, ``seq_len``): 6 N tokens to train, 2 N
    tokens to prefill, 2 N a sequence a decode step, N =
    :func:`active_params`. Products only, no attention scores."""
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
