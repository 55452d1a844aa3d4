"""Auto Tuner (paper §III-D): the elastic transfer threshold controller
and the cluster dimensionality of the reformation layout — the port's
copy of ``repro.core.auto_tuner.AutoTuner`` and ``choose_cluster_dim``.

* ``AutoTuner`` tracks the running-average loss
  ``F_t = 0.9 F_{t-1} + 0.1 L_t`` and the Loss Descent Rate
  ``LDR_t = (F_t - F_{t-1}) / epoch_time``. When LDR is not degrading
  against ``delta`` (=10) epochs ago it moves ``beta_thre`` UP the ladder
  ``{0, bG, 1.5bG, 5bG, 7bG, 10bG, 1}`` (more clusters transferred ->
  faster), otherwise one step DOWN (more fidelity).
* ``choose_cluster_dim``'s constants are the reference's heuristic, kept
  byte for byte because they decide the layout and the port's layouts
  must equal the reference's. They model a TPU core's fast memory, not an
  H100; a Hopper-specific cluster size is work for a later PR.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class AutoTuner:
    beta_g: float
    delta: int = 10
    ema: float = 0.9
    _ladder: tuple = ()
    _pos: int = 1
    _f: list = dataclasses.field(default_factory=list)
    _ldr: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self._ladder:
            bg = self.beta_g
            self._ladder = (0.0, bg, 1.5 * bg, 5 * bg, 7 * bg, 10 * bg, 1.0)
        self._pos = 1  # start at beta_G (paper §III-D)

    @property
    def beta_thre(self) -> float:
        return self._ladder[self._pos]

    @property
    def ladder(self) -> tuple:
        return self._ladder

    @property
    def pos(self) -> int:
        return self._pos

    @property
    def last_ldr(self) -> float:
        return self._ldr[-1]

    def state_dict(self) -> dict:
        """JSON-safe tuner state: ladder position plus the EMA/LDR tails
        ``update`` reads."""
        return {"pos": int(self._pos),
                "beta_g": float(self.beta_g),
                "ladder": [float(x) for x in self._ladder],
                "f": [float(x) for x in self._f[-1:]],
                "ldr": [float(x) for x in self._ldr[-(self.delta + 1):]]}

    def load_state_dict(self, d: dict) -> None:
        self._ladder = tuple(float(x) for x in d["ladder"])
        self._pos = int(d["pos"])
        self._f = [float(x) for x in d["f"]]
        self._ldr = [float(x) for x in d["ldr"]]

    def update(self, loss: float, epoch_time: float) -> float:
        """Feed one epoch's (loss, wall time); returns the new beta_thre."""
        f_prev = self._f[-1] if self._f else loss
        f = self.ema * f_prev + (1 - self.ema) * loss
        self._f.append(f)
        ldr = (f - f_prev) / max(epoch_time, 1e-9)  # negative = improving
        self._ldr.append(ldr)
        if len(self._ldr) > self.delta:
            if ldr <= self._ldr[-1 - self.delta]:
                # descending at least as fast as delta epochs ago: speed up
                self._pos = min(self._pos + 1, len(self._ladder) - 1)
            else:
                # converging or degrading: back off for fidelity
                self._pos = max(self._pos - 1, 0)
        return self.beta_thre

VMEM_BYTES = 16 * 1024 * 1024     # the reference's per-core budget


def choose_cluster_dim(seq_len: int, d_model: int, bq: int = 128) -> int:
    """Cluster dimensionality k — adapted from the paper's L2 formula
    k = floor(sqrt(Q_L2 / (i*d))): the cluster side is a multiple of bq
    that keeps the per-cluster k/v panel within a quarter of the
    reference's fast-memory budget."""
    panel = VMEM_BYTES // 4
    side = max(bq, min(seq_len,
                       (panel // max(d_model, 1) // bq) * bq or bq))
    k = max(1, seq_len // side)
    return k
