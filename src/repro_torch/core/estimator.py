"""Cost estimation — per-block processing time at nominal frequency.

Two layers:

1. ``CostModel`` — linear model over cheap-to-sample block *features* (record count,
   token count, match density, …).  Calibrated by least squares on a handful of
   measured (features → seconds) points, exactly the role of the paper's
   pre-processing + estimator box (Fig. 3).

2. ``RooflineTimeModel`` — the TPU adaptation: step time at relative frequency f is

       PT(f) = max(T_comp · f_max/f, T_mem, T_coll) + T_fixed

   Only the compute term scales with core clock; HBM and ICI terms do not.  This is
   what turns roofline analysis (EXPERIMENTS.md §Roofline) into DVFS headroom: when
   T_comp < max(T_mem, T_coll), the clock can drop to

       f* = f_max · T_comp / max(T_mem, T_coll)

   with zero time penalty ("free" energy savings — beyond-paper, see DESIGN.md §7).

Copied from ``src/repro/core/estimator.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

__all__ = ["CostModel", "RooflineTimeModel", "RooflineTerms", "V5E"]


@dataclasses.dataclass
class CostModel:
    """seconds ≈ features @ weights  (non-negative least squares via clipping)."""

    feature_names: tuple
    weights: np.ndarray | None = None

    def fit(self, features: Sequence[Mapping[str, float]], seconds: Sequence[float]):
        x = np.asarray([[f[k] for k in self.feature_names] for f in features],
                       dtype=np.float64)
        y = np.asarray(seconds, dtype=np.float64)
        w, *_ = np.linalg.lstsq(x, y, rcond=None)
        self.weights = np.maximum(w, 0.0)  # time contributions are non-negative
        return self

    def predict(self, feats: Mapping[str, float]) -> float:
        if self.weights is None:
            raise RuntimeError("CostModel not fitted")
        x = np.asarray([feats[k] for k in self.feature_names], dtype=np.float64)
        return float(np.maximum(x @ self.weights, 0.0))


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms in SECONDS, plus fixed overhead."""

    t_comp: float
    t_mem: float = 0.0
    t_coll: float = 0.0
    t_fixed: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    def bound(self) -> float:
        return max(self.t_comp, self.t_mem, self.t_coll)


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Hardware constants (per chip)."""

    peak_flops: float = 197e12    # bf16 FLOP/s (TPU v5e)
    hbm_bw: float = 819e9         # B/s
    ici_bw: float = 50e9          # B/s per link
    hbm_bytes: float = 16e9


V5E = ChipSpec()


@dataclasses.dataclass(frozen=True)
class RooflineTimeModel:
    """PT(f) = max(T_comp·f_max/f, T_mem, T_coll) + T_fixed."""

    terms: RooflineTerms

    def time_at(self, rel_freq: float) -> float:
        f = max(rel_freq, 1e-6)
        return max(self.terms.t_comp / f, self.terms.t_mem,
                   self.terms.t_coll) + self.terms.t_fixed

    def zero_cost_freq(self) -> float:
        """Lowest relative frequency with NO time increase vs f_max."""
        bound = max(self.terms.t_mem, self.terms.t_coll)
        if bound <= 0.0 or self.terms.t_comp <= 0.0:
            return 1.0
        return min(1.0, self.terms.t_comp / bound)

    @staticmethod
    def from_counts(flops: float, hbm_bytes: float, coll_bytes: float,
                    chips: int = 1, spec: ChipSpec = V5E,
                    t_fixed: float = 0.0) -> "RooflineTimeModel":
        terms = RooflineTerms(
            t_comp=flops / (chips * spec.peak_flops),
            t_mem=hbm_bytes / (chips * spec.hbm_bw),
            t_coll=coll_bytes / (chips * spec.ici_bw),
            t_fixed=t_fixed,
        )
        return RooflineTimeModel(terms)
