"""Cluster-aware Graph Parallelism on ``torch.distributed`` (paper
§III-C): recipes (``sharding``), the logical-axis context (``axes``), the
collectives (``collectives``), the Ulysses all-to-all (``ulysses``) and
the sharded cluster-sparse attention (``cluster_parallel``)."""
