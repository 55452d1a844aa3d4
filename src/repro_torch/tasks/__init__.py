"""Task API on the port: the contract between a workload and the
Trainer (``tasks/base.py``). Slice 2 ports node classification; the
graph-level, link and stream tasks wait for their slices."""

from repro_torch.tasks.base import Task
from repro_torch.tasks.elastic import ElasticTask, LadderMove
from repro_torch.tasks.node import NodeTask

__all__ = ["ElasticTask", "LadderMove", "NodeTask", "Task"]
