"""Serving on the port: paged-KV continuous batching for token LMs
(:class:`ServeEngine`) and reformation-cached node/link queries for graph
transformers (:class:`GraphServe`).

``python -m repro_torch.launch.serve`` is the CLI over both.
"""

from repro_torch.serve.engine import Admitted, Rejected, ServeEngine
from repro_torch.serve.graph_serve import GraphServe, graph_hash
from repro_torch.serve.paged import BlockAllocator

__all__ = ["ServeEngine", "Admitted", "Rejected", "GraphServe",
           "BlockAllocator", "graph_hash"]
