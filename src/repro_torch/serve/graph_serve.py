"""GraphServe: node- and link-prediction serving — the port of
``repro.serve.graph_serve``.

A "request" is a query against an encoded graph. GraphServe runs the
reformation pipeline (``data/graph_pipeline.prepare_node_task`` — cluster
reorder, global tokens, sparse layout) and caches the prepared layout,
already moved to the model's device, per *graph hash*, so repeated
queries against one graph pay the reformation and the upload once.

Two endpoints:

* ``node(g, nodes)``   — class logits / argmax labels for node ids;
* ``link(g, src, dst)`` — symmetric dot-product scores for node pairs,
  ``(h_u . h_v) / sqrt(D)`` (the reference's ``tasks/link`` rule).

Node ids are ORIGINAL graph ids; the mapping onto cluster-reordered
sequence positions (``inv_perm[node] + n_global``) is internal.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from repro_torch.core.graph_model import (apply_head, batch_to_torch,
                                          graph_forward)
from repro_torch.data.graph_pipeline import prepare_node_task


def graph_hash(g) -> str:
    """Content hash of a graph (topology + features + labels) — the
    layout-cache key, so a mutated graph re-forms instead of aliasing a
    stale layout. Equal to the reference's hash of the same graph."""
    h = hashlib.sha256()
    h.update(np.int64(g.n).tobytes())
    h.update(np.ascontiguousarray(g.src, np.int64).tobytes())
    h.update(np.ascontiguousarray(g.dst, np.int64).tobytes())
    for arr in (g.feat, g.labels):
        h.update(b"|")
        if arr is not None:
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


class GraphServe:
    """Serves node/link queries for a graph-family ``GraphModel``; the
    forward runs on the model's device."""

    def __init__(self, model, *, bq: int = 32, bk: int = 32, d_b: int = 8,
                 seed: int = 0):
        if model.cfg.family != "graph":
            raise ValueError(
                f"GraphServe serves the graph family, got "
                f"{model.cfg.family!r}")
        self.model = model
        self.cfg = model.cfg
        self.bq, self.bk, self.d_b, self.seed = bq, bk, d_b, seed
        # hash -> (prep, inv_perm, device batch)
        self._layouts: dict[str, tuple] = {}

    # ------------------------------------------------------------- layout

    def prepared(self, g):
        """``(PreparedGraph, inv_perm, device batch)`` for ``g``, from the
        cache when the graph was seen before."""
        key = graph_hash(g)
        hit = self._layouts.get(key)
        if hit is None:
            prep = prepare_node_task(g, self.cfg, bq=self.bq, bk=self.bk,
                                     d_b=self.d_b, seed=self.seed)
            inv = np.empty(g.n, np.int64)
            inv[prep.perm] = np.arange(g.n)
            dev_batch = batch_to_torch(prep.batch, self.model.device)
            hit = self._layouts[key] = (prep, inv, dev_batch)
        return hit

    def n_cached_layouts(self) -> int:
        return len(self._layouts)

    def _positions(self, g, nodes, inv) -> np.ndarray:
        nodes = np.asarray(nodes, np.int64)
        if nodes.size and (nodes.min() < 0 or nodes.max() >= g.n):
            raise ValueError(
                f"node ids must be in [0, {g.n}), got "
                f"[{nodes.min()}, {nodes.max()}]")
        return inv[nodes] + self.cfg.n_global

    # ---------------------------------------------------------- endpoints

    def node(self, g, nodes) -> dict:
        """Class logits + argmax labels for original node ids."""
        _, inv, batch = self.prepared(g)
        pos = torch.from_numpy(self._positions(g, nodes, inv))
        with torch.inference_mode():
            h = graph_forward(self.model, batch)[0]
            logits = apply_head(self.model, h[pos.to(h.device)])
        sel = logits.float().cpu().numpy()
        return {"nodes": np.asarray(nodes, np.int64),
                "logits": sel,
                "labels": np.argmax(sel, axis=-1).astype(np.int64)}

    def link(self, g, src, dst) -> dict:
        """Scaled dot-product scores for node pairs, probability via
        sigmoid."""
        _, inv, batch = self.prepared(g)
        ps = torch.from_numpy(self._positions(g, src, inv))
        pd = torch.from_numpy(self._positions(g, dst, inv))
        with torch.inference_mode():
            h = graph_forward(self.model, batch)[0]
            hs, hd = h[ps.to(h.device)].float(), h[pd.to(h.device)].float()
            scores = (hs * hd).sum(-1) / math.sqrt(h.shape[-1])
        scores = scores.cpu().numpy()
        return {"src": np.asarray(src, np.int64),
                "dst": np.asarray(dst, np.int64),
                "scores": scores,
                "prob": 1.0 / (1.0 + np.exp(-scores))}
