"""Structure-of-arrays views of the DV-DVFS planning pipeline.

The object path (``BlockEstimate`` -> ``BlockInfo`` -> ``SchedulePlan`` of
``BlockPlan``) is pleasant at dozens of blocks and ruinous at a million: one
Python object per block per stage.  These containers carry the same
information as parallel NumPy arrays so the dataset->plan path
(``repro.pipeline``) never materializes per-block objects; ``to_blocks()`` /
``to_block_estimates()`` reconstruct the object forms on demand (tests,
small-n interop, the frozen loop oracles).

Layering: this module only depends on NumPy.  Conversions to the object
types import ``repro.core.scheduler`` / ``repro.core.sampling`` lazily so
``scheduler`` itself can import these containers without a cycle.

Copied from ``src/repro/core/soa.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = ["RooflineArrays", "BlockArrays", "EstimateArrays", "PlanArrays"]


def _as_f64(x, n: int, default: float) -> np.ndarray:
    if x is None:
        return np.full(n, default, dtype=np.float64)
    out = np.asarray(x, dtype=np.float64)
    if out.shape != (n,):
        raise ValueError(f"expected shape ({n},), got {out.shape}")
    return out


@dataclasses.dataclass(frozen=True)
class RooflineArrays:
    """Per-block roofline terms; ``has[i]`` False means block i has none."""

    has: np.ndarray      # (n,) bool
    t_comp: np.ndarray   # (n,) float64 (0 where has is False)
    t_mem: np.ndarray
    t_coll: np.ndarray
    t_fixed: np.ndarray

    def select(self, idx) -> "RooflineArrays":
        return RooflineArrays(self.has[idx], self.t_comp[idx], self.t_mem[idx],
                              self.t_coll[idx], self.t_fixed[idx])


@dataclasses.dataclass(frozen=True)
class BlockArrays:
    """SoA analogue of a ``Sequence[BlockInfo]`` (same field semantics)."""

    index: np.ndarray            # (n,) int64
    est_time_fmax: np.ndarray    # (n,) float64
    est_rel_halfwidth: np.ndarray  # (n,) float64
    util: np.ndarray             # (n,) float64
    roofline: RooflineArrays | None = None
    records: np.ndarray | None = None  # (n,) float64 data sizes; None = unknown

    def __len__(self) -> int:
        return len(self.index)

    @classmethod
    def build(cls, est_time_fmax, *, index=None, est_rel_halfwidth=None,
              util=None, roofline: RooflineArrays | None = None,
              records=None) -> "BlockArrays":
        est = np.asarray(est_time_fmax, dtype=np.float64)
        n = len(est)
        idx = (np.arange(n, dtype=np.int64) if index is None
               else np.asarray(index, dtype=np.int64))
        rec = None if records is None else _as_f64(records, n, 0.0)
        return cls(idx, est, _as_f64(est_rel_halfwidth, n, 0.0),
                   _as_f64(util, n, 1.0), roofline, rec)

    @classmethod
    def from_blocks(cls, blocks) -> "BlockArrays":
        n = len(blocks)
        index = np.fromiter((b.index for b in blocks), np.int64, count=n)
        est = np.fromiter((b.est_time_fmax for b in blocks), np.float64,
                          count=n)
        hw = np.fromiter((b.est_rel_halfwidth for b in blocks), np.float64,
                         count=n)
        util = np.fromiter((b.util for b in blocks), np.float64, count=n)
        roofline = None
        if any(b.roofline is not None for b in blocks):
            has = np.fromiter((b.roofline is not None for b in blocks),
                              np.bool_, count=n)
            terms = [b.roofline.terms if b.roofline is not None else None
                     for b in blocks]
            pull = lambda attr: np.fromiter(
                (getattr(t, attr) if t is not None else 0.0 for t in terms),
                np.float64, count=n)
            roofline = RooflineArrays(has, pull("t_comp"), pull("t_mem"),
                                      pull("t_coll"), pull("t_fixed"))
        records = None
        if any(getattr(b, "records", 0.0) for b in blocks):
            records = np.fromiter((getattr(b, "records", 0.0) for b in blocks),
                                  np.float64, count=n)
        return cls(index, est, hw, util, roofline, records)

    def select(self, idx) -> "BlockArrays":
        roof = self.roofline.select(idx) if self.roofline is not None else None
        rec = self.records[idx] if self.records is not None else None
        return BlockArrays(self.index[idx], self.est_time_fmax[idx],
                           self.est_rel_halfwidth[idx], self.util[idx], roof,
                           rec)

    @classmethod
    def concat(cls, a: "BlockArrays", b: "BlockArrays") -> "BlockArrays":
        """Concatenate two stores (open-loop arrivals extending a base).

        Pure ``np.concatenate`` copies — every pre-existing element keeps
        its exact floats.  Mixed optional columns fill the absent side with
        the neutral value (no roofline, zero records).
        """
        na, nb = len(a), len(b)
        roof = None
        if a.roofline is not None or b.roofline is not None:
            def _part(r, n):
                if r is not None:
                    return (r.has, r.t_comp, r.t_mem, r.t_coll, r.t_fixed)
                z = np.zeros(n)
                return (np.zeros(n, dtype=bool), z, z, z, z)
            pa, pb = _part(a.roofline, na), _part(b.roofline, nb)
            roof = RooflineArrays(*(np.concatenate([x, y])
                                    for x, y in zip(pa, pb)))
        rec = None
        if a.records is not None or b.records is not None:
            rec = np.concatenate([
                a.records if a.records is not None else np.zeros(na),
                b.records if b.records is not None else np.zeros(nb)])
        return cls(np.concatenate([a.index, b.index]),
                   np.concatenate([a.est_time_fmax, b.est_time_fmax]),
                   np.concatenate([a.est_rel_halfwidth,
                                   b.est_rel_halfwidth]),
                   np.concatenate([a.util, b.util]), roof, rec)

    def to_blocks(self) -> list:
        """Materialize ``BlockInfo`` objects (small-n interop / oracles)."""
        from repro_torch.core.estimator import RooflineTerms, RooflineTimeModel
        from repro_torch.core.scheduler import BlockInfo
        out = []
        for i in range(len(self)):
            roof = None
            if self.roofline is not None and bool(self.roofline.has[i]):
                roof = RooflineTimeModel(RooflineTerms(
                    t_comp=float(self.roofline.t_comp[i]),
                    t_mem=float(self.roofline.t_mem[i]),
                    t_coll=float(self.roofline.t_coll[i]),
                    t_fixed=float(self.roofline.t_fixed[i])))
            out.append(BlockInfo(
                index=int(self.index[i]),
                est_time_fmax=float(self.est_time_fmax[i]),
                est_rel_halfwidth=float(self.est_rel_halfwidth[i]),
                util=float(self.util[i]), roofline=roof,
                records=(float(self.records[i])
                         if self.records is not None else 0.0)))
        return out


@dataclasses.dataclass(frozen=True)
class EstimateArrays:
    """SoA analogue of a ``list[BlockEstimate]`` (same field semantics)."""

    index: np.ndarray      # (n,) int64 global block index
    total: np.ndarray      # (n,) float64
    ci_low: np.ndarray
    ci_high: np.ndarray
    n_sampled: np.ndarray  # (n,) int64
    n_records: np.ndarray  # (n,) int64

    def __len__(self) -> int:
        return len(self.total)

    @property
    def rel_halfwidth(self) -> np.ndarray:
        """Vectorized ``BlockEstimate.rel_halfwidth`` (0 where total <= 0)."""
        safe = np.where(self.total > 0, self.total, 1.0)
        hw = np.maximum(self.total - self.ci_low, self.ci_high - self.total)
        return np.where(self.total > 0, hw / safe, 0.0)

    @classmethod
    def concat(cls, parts: list) -> "EstimateArrays":
        if not parts:
            z = np.zeros(0)
            zi = np.zeros(0, dtype=np.int64)
            return cls(zi, z, z.copy(), z.copy(), zi.copy(), zi.copy())
        cat = lambda attr: np.concatenate([getattr(p, attr) for p in parts])
        return cls(cat("index"), cat("total"), cat("ci_low"), cat("ci_high"),
                   cat("n_sampled"), cat("n_records"))

    def to_block_arrays(self, *, util=None,
                        roofline: RooflineArrays | None = None) -> BlockArrays:
        """Planner input: est PT_i at f_max = the estimated total cost.

        ``n_records`` rides along as the blocks' data sizes — what the
        migration wire model (``repro.runtime.migrate``) prices transfers
        by."""
        return BlockArrays.build(self.total, index=self.index,
                                 est_rel_halfwidth=self.rel_halfwidth,
                                 util=util, roofline=roofline,
                                 records=self.n_records)

    def to_block_estimates(self) -> list:
        """Materialize ``BlockEstimate`` objects (oracle / interop path)."""
        from repro_torch.core.sampling import BlockEstimate
        return [BlockEstimate(total=float(self.total[i]),
                              ci_low=float(self.ci_low[i]),
                              ci_high=float(self.ci_high[i]),
                              n_sampled=int(self.n_sampled[i]),
                              n_records=int(self.n_records[i]))
                for i in range(len(self))]


@dataclasses.dataclass(frozen=True)
class PlanArrays:
    """SoA analogue of ``SchedulePlan`` — one frequency plan, zero per-block
    objects.  ``to_schedule_plan()`` reconstructs the object form on demand."""

    planner: str
    deadline_s: float
    slot_s: float
    index: np.ndarray          # (n,) int64
    rel_freq: np.ndarray       # (n,) float64 (exact ladder states)
    pred_time_s: np.ndarray    # (n,) float64
    pred_energy_j: np.ndarray  # (n,) float64
    feasible: bool

    def __len__(self) -> int:
        return len(self.index)

    @functools.cached_property
    def pred_total_time(self) -> float:
        return float(self.pred_time_s.sum())

    @functools.cached_property
    def pred_total_energy(self) -> float:
        return float(self.pred_energy_j.sum())

    def select(self, idx) -> "PlanArrays":
        """Subset of the plan (same metadata) — how the runtime engine and
        the migration policy slice queued block sets without materializing
        ``BlockPlan`` objects."""
        return PlanArrays(self.planner, self.deadline_s, self.slot_s,
                          self.index[idx], self.rel_freq[idx],
                          self.pred_time_s[idx], self.pred_energy_j[idx],
                          self.feasible)

    def split_at(self, k: int) -> tuple:
        """(done-or-in-flight, still-queued) views at queue position ``k`` —
        the runtime's in-flight/queued boundary over one node's plan."""
        return self.select(slice(0, k)), self.select(slice(k, None))

    def to_blocks(self) -> tuple:
        """Materialize the ``BlockPlan`` tuple (on demand only)."""
        from repro_torch.core.scheduler import _make_plans
        return _make_plans(self.index.tolist(), self.slot_s,
                           self.rel_freq.tolist(), self.pred_time_s.tolist(),
                           self.pred_energy_j.tolist())

    def to_schedule_plan(self):
        from repro_torch.core.scheduler import SchedulePlan
        return SchedulePlan(self.planner, self.deadline_s, self.to_blocks(),
                            self.feasible)
