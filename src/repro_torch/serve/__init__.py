from repro_torch.serve.graph_serve import GraphServe, graph_hash

__all__ = ["GraphServe", "graph_hash"]
