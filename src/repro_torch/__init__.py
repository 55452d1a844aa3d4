"""PyTorch/CUDA port of the TorchGT reproduction (``src/repro/`` is the
JAX reference). Module names mirror the JAX package so each counterpart
is easy to find; the port imports ``torch`` and ``numpy`` only, and keeps
its own copy of every host-side module it needs.

Slice 1 covers graph serving: host reformation, the Graphormer forward,
and the cluster-sparse attention forward as a hand-written CUDA kernel.
"""
