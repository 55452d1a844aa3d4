"""Checkpoints of the port, on the reference's on-disk format."""

from repro_torch.ckpt.checkpoint import (CheckpointCorrupt, Checkpointer,
                                         default_codec, snapshot)

__all__ = ["CheckpointCorrupt", "Checkpointer", "default_codec", "snapshot"]
