"""Task API on the port: the contract between a workload and the
Trainer (``tasks/base.py``). Slice 2 ports node classification, slice 3
the LM stream task; the graph-level and link tasks wait for their
slices."""

from repro_torch.tasks.base import BatchFnTask, Task
from repro_torch.tasks.elastic import ElasticTask, LadderMove
from repro_torch.tasks.node import NodeTask

__all__ = ["BatchFnTask", "ElasticTask", "LadderMove", "NodeTask", "Task"]
