"""Task API on the port: the contract between a workload and the
Trainer (``tasks/base.py``) — node classification, graph-level
classification over packed mini-graphs, link prediction and the LM
stream task."""

from repro_torch.tasks.base import BatchFnTask, Task
from repro_torch.tasks.elastic import ElasticTask, LadderMove
from repro_torch.tasks.graph_level import (GraphLevelTask,
                                           synthetic_graph_level_dataset)
from repro_torch.tasks.link import LinkTask, link_loss
from repro_torch.tasks.node import NodeTask

__all__ = [
    "BatchFnTask",
    "ElasticTask",
    "GraphLevelTask",
    "LadderMove",
    "LinkTask",
    "NodeTask",
    "Task",
    "link_loss",
    "synthetic_graph_level_dataset",
]
