"""Batch fitters: counter traces -> the models the planners consume.

Three fitters, all deterministic closed-form/grid least squares (no
iterative optimizers, no RNG):

``fit_power_model``
    recovers ``(p_idle, p_full, alpha)`` of the power family
    ``P(u, f) = p_idle + (p_full - p_idle) * u * (f/f_max)^alpha`` from
    observed interval powers.  For a FIXED alpha the family is linear in
    ``(p_idle, p_full - p_idle)`` with regressor ``x = u * f^alpha``, so the
    joint fit is a dense alpha grid of closed-form 2-parameter weighted
    least squares (vectorized: one pass computes every alpha's residual),
    followed by one parabolic refinement of the best grid point.  Samples
    are weighted by interval duration — a 10 s interval is ten 1 s
    intervals' worth of evidence.

``fit_cost_model``
    recovers a per-app record-cost and roofline memory-bound fraction from
    observed block walls: ``wall = records * cost_per_record *
    max((1 - mem_fraction)/f, 1)`` — the planner's own max-form roofline,
    where ``1 - mem_fraction`` is the zero-cost down-clock floor (clocks
    above it ride the memory bound for free; below it the compute term
    takes over).  Same structure as the power fit: ``mem_fraction`` grid x
    closed-form through-origin scale fit, vectorized, with parabolic
    refinement.

``fit_node_speeds``
    recovers per-node relative speeds for heterogeneous ``NodeSpec``s /
    serve ``replica_speeds``: the compute-bound model says
    ``dur = (work/f) / speed``, so the duration-weighted estimate is the
    ratio of sums ``speed = sum(work/f) / sum(dur)`` — exact on noise-free
    traces, and robust because both sums grow with observed time.

Degenerate inputs (empty traces, a single frequency for the power fit, a
non-increasing fitted curve) raise ``CalibrationError`` rather than
returning a confidently-wrong model; ``OnlineCalibrator`` catches it and
keeps the previous model.

Copied from ``src/repro/calibrate/fit.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.energy import PowerModel
from repro_torch.core.estimator import RooflineTerms, RooflineTimeModel
from repro_torch.calibrate.trace import CounterTrace

__all__ = ["CalibrationError", "PowerFit", "CostFit", "SpeedFit",
           "fit_power_model", "fit_cost_model", "fit_node_speeds",
           "calibrate_nodes"]

# alpha grid for the power family: spans sub-linear leakage-dominated chips
# through the paper's alpha=3 CPU with margin; 0.01 steps keep the parabolic
# refinement's bracket tight
_ALPHA_GRID = np.round(np.arange(0.20, 5.001, 0.01), 4)
_BETA_GRID = np.round(np.arange(0.0, 0.991, 0.005), 4)


class CalibrationError(ValueError):
    """A fitter refused: not enough signal in the trace to identify the
    model (empty window, single frequency, degenerate curve)."""


@dataclasses.dataclass(frozen=True)
class PowerFit:
    """Fitted ``(p_idle, p_full, alpha)`` + fit quality."""

    p_idle: float
    p_full: float
    alpha: float
    rmse_w: float        # duration-weighted residual RMS (watts)
    n_samples: int

    def to_power_model(self) -> PowerModel:
        return PowerModel(p_full=self.p_full, p_idle=self.p_idle,
                          alpha=self.alpha)


@dataclasses.dataclass(frozen=True)
class CostFit:
    """Fitted per-record roofline cost: ``wall(records, f) =
    records * cost_per_record * max((1 - mem_fraction)/f, 1)``.

    ``mem_fraction`` is the memory-bound share of the f_max wall:
    0 = pure compute (every down-clock stretches time 1/f), 0.4 = the clock
    can drop to 0.6 before time grows at all (the roofline's zero-cost
    point ``f* = 1 - mem_fraction``)."""

    cost_per_record: float   # seconds per record at f_max
    mem_fraction: float      # memory-bound share; 1 - mem_fraction = f*
    rmse_s: float
    n_samples: int

    def time_at(self, records, rel_freq) -> np.ndarray:
        r = np.asarray(records, dtype=np.float64)
        f = np.maximum(np.asarray(rel_freq, dtype=np.float64), 1e-6)
        return r * self.cost_per_record \
            * np.maximum((1.0 - self.mem_fraction) / f, 1.0)

    def est_time_fmax(self, records) -> np.ndarray:
        """Planner ``est_time_fmax`` for blocks of ``records`` records."""
        return np.asarray(records, dtype=np.float64) * self.cost_per_record

    def roofline(self, records: float) -> RooflineTimeModel:
        """The planner's max-form time model for one block."""
        t1 = float(records) * self.cost_per_record
        return RooflineTimeModel(RooflineTerms(
            t_comp=t1 * (1.0 - self.mem_fraction),
            t_mem=t1 if self.mem_fraction > 0 else 0.0))

    def roofline_arrays(self, records) -> "RooflineArrays":
        """Vectorized ``roofline()`` over per-block record counts.

        Produces the ``RooflineArrays`` the SoA planners consume
        (``repro.pipeline`` attaches it to streamed estimates) — per-element
        identical to building ``roofline(r)`` block by block.
        """
        from repro_torch.core.soa import RooflineArrays
        r = np.asarray(records, dtype=np.float64)
        t1 = r * self.cost_per_record
        z = np.zeros(len(r))
        return RooflineArrays(
            has=np.ones(len(r), dtype=bool),
            t_comp=t1 * (1.0 - self.mem_fraction),
            t_mem=t1 if self.mem_fraction > 0 else z,
            t_coll=z, t_fixed=z.copy())


@dataclasses.dataclass(frozen=True)
class SpeedFit:
    """Fitted effective node speed (planner units — see trace docstring)."""

    speed: float
    n_samples: int
    work_s: float        # total planner-unit work observed
    wall_s: float        # total wall time observed


def _weighted_linfit(p: np.ndarray, x: np.ndarray,
                     w: np.ndarray) -> tuple:
    """Closed-form weighted LS of ``p ~ a + b*x`` for a BATCH of regressor
    rows ``x`` (shape ``(A, n)``); returns per-row ``(a, b, rss)``."""
    sw = w.sum()
    mx = (x * w).sum(axis=1) / sw
    mp = float((p * w).sum() / sw)
    dx = x - mx[:, None]
    var = (w * dx * dx).sum(axis=1)
    cov = (w * dx * (p - mp)).sum(axis=1)
    safe = np.where(var > 1e-12, var, 1.0)
    b = np.where(var > 1e-12, cov / safe, 0.0)
    a = mp - b * mx
    resid = p[None, :] - a[:, None] - b[:, None] * x
    rss = (w * resid * resid).sum(axis=1)
    rss = np.where(var > 1e-12, rss, np.inf)
    return a, b, rss


def fit_power_model(
    trace: CounterTrace,
    *,
    node: str | None = None,
    alpha_grid: np.ndarray = _ALPHA_GRID,
) -> PowerFit:
    """Jointly recover ``(p_idle, p_full, alpha)`` from one node's trace.

    Raises ``CalibrationError`` when the trace cannot identify the family:
    fewer than 3 usable samples, fewer than 2 distinct frequencies (at one
    frequency ``f^alpha`` is a constant — alpha and the linear slope are
    confounded no matter how utilization varies), or fewer than 3 distinct
    frequencies when utilization is constant (a 2-point line fits every
    alpha exactly).
    """
    if node is not None:
        trace = trace.for_node(node)
    keep = trace.dur_s > 0
    f = trace.freq[keep]
    u = np.clip(trace.util[keep], 0.0, 1.0)
    w = trace.dur_s[keep]
    p = trace.power_w[keep]
    n = len(f)
    if n < 3:
        raise CalibrationError(f"power fit needs >= 3 samples, got {n}")
    ops = {(round(float(uu), 9), round(float(ff), 9)) for uu, ff in zip(u, f)}
    n_freqs = len({op[1] for op in ops})
    n_utils = len({op[0] for op in ops})
    if n_freqs < 2 or (n_utils == 1 and n_freqs < 3):
        raise CalibrationError(
            f"power fit under-determined: {n_freqs} distinct frequencies x "
            f"{n_utils} distinct utilizations")

    alphas = np.asarray(alpha_grid, dtype=np.float64)
    x = u[None, :] * np.power(f[None, :], alphas[:, None])
    a, b, rss = _weighted_linfit(p, x, w)
    # inadmissible rows (flat or decreasing busy power) never win the grid
    rss = np.where((b > 0) & (a > 0), rss, np.inf)
    if not np.isfinite(rss).any():
        raise CalibrationError("power fit found no admissible "
                               "(p_idle > 0, p_full > p_idle) model")
    k = int(np.argmin(rss))

    # one parabolic refinement through the best grid point and neighbours
    if 0 < k < len(alphas) - 1 and np.isfinite(rss[k - 1]) \
            and np.isfinite(rss[k + 1]):
        r0, r1, r2 = rss[k - 1], rss[k], rss[k + 1]
        denom = r0 - 2 * r1 + r2
        if denom > 1e-18:
            shift = 0.5 * (r0 - r2) / denom
            alpha_ref = float(alphas[k]
                              + np.clip(shift, -1.0, 1.0)
                              * (alphas[k + 1] - alphas[k]))
            xr = (u * np.power(f, alpha_ref))[None, :]
            ar, br, rr = _weighted_linfit(p, xr, w)
            if br[0] > 0 and ar[0] > 0 and rr[0] <= rss[k]:
                a = np.concatenate((a, ar))
                b = np.concatenate((b, br))
                rss = np.concatenate((rss, rr))
                alphas = np.concatenate((alphas, [alpha_ref]))
                k = len(alphas) - 1

    return PowerFit(p_idle=float(a[k]), p_full=float(a[k] + b[k]),
                    alpha=float(alphas[k]),
                    rmse_w=float(np.sqrt(rss[k] / w.sum())), n_samples=n)


def fit_cost_model(
    records: Sequence[float],
    rel_freq: Sequence[float],
    wall_s: Sequence[float],
    *,
    beta_grid: np.ndarray = _BETA_GRID,
) -> CostFit:
    """Per-app record-cost + memory-bound fraction from observed block walls.

    Inputs are per-block observations: record count, the relative frequency
    the block ran at, and its wall time.  ``mem_fraction`` is only
    identifiable when some blocks ran below f_max (the max-form kink needs
    to be exercised); with a single frequency the fit still recovers
    ``cost_per_record`` and reports ``mem_fraction = 0``.  When the true
    zero-cost floor lies BELOW every observed frequency the data only
    bounds it (any floor under min(f) fits equally); ties resolve to the
    smallest consistent ``mem_fraction`` — conservative for the planner,
    which then never claims more free down-clock headroom than the trace
    actually exhibited.
    """
    r = np.asarray(records, dtype=np.float64)
    f = np.asarray(rel_freq, dtype=np.float64)
    y = np.asarray(wall_s, dtype=np.float64)
    keep = (r > 0) & (f > 0) & (y > 0)
    r, f, y = r[keep], f[keep], y[keep]
    n = len(r)
    if n < 2:
        raise CalibrationError(f"cost fit needs >= 2 usable blocks, got {n}")
    if len(np.unique(np.round(f, 9))) < 2:
        beta_grid = np.zeros(1)  # kink unobservable: pure compute model

    def scale_fit(betas):
        """Through-origin LS scale per beta row; (c, rss) arrays."""
        s = r[None, :] * np.maximum((1.0 - betas[:, None]) / f[None, :], 1.0)
        num = (s * y[None, :]).sum(axis=1)
        den = (s * s).sum(axis=1)
        c = num / np.where(den > 1e-18, den, 1.0)
        rss = (y * y).sum() - 2 * c * num + c * c * den
        return c, np.where((den > 1e-18) & (c > 0), rss, np.inf)

    betas = np.asarray(beta_grid, dtype=np.float64)
    c, rss = scale_fit(betas)
    if not np.isfinite(rss).any():
        raise CalibrationError("cost fit degenerate (zero-work blocks?)")
    k = int(np.argmin(rss))
    beta, cost, best_rss = float(betas[k]), float(c[k]), float(rss[k])
    if 0 < k < len(betas) - 1 and np.isfinite(rss[k - 1]) \
            and np.isfinite(rss[k + 1]):
        r0, r1, r2 = rss[k - 1], rss[k], rss[k + 1]
        denom = r0 - 2 * r1 + r2
        if denom > 1e-18:
            beta_ref = betas[k] \
                + float(np.clip(0.5 * (r0 - r2) / denom, -1.0, 1.0)) \
                * (betas[k + 1] - betas[k])
            c_r, rss_r = scale_fit(np.array([beta_ref]))
            if np.isfinite(rss_r[0]) and rss_r[0] <= best_rss:
                beta, cost, best_rss = float(beta_ref), float(c_r[0]), \
                    float(rss_r[0])
    return CostFit(cost_per_record=cost, mem_fraction=beta,
                   rmse_s=float(np.sqrt(max(best_rss, 0.0) / n)),
                   n_samples=n)


def fit_node_speeds(
    trace: CounterTrace,
    *,
    reference: str | None = None,
) -> dict:
    """Per-node effective speed recovery: ``{name: SpeedFit}``.

    ``speed = sum(work/f) / sum(dur)`` per node (duration-weighted, exact
    under the compute-bound model).  With ``reference`` set, every speed is
    divided by the reference node's — the serve engine's
    ``replica_speeds`` convention (replica 0 == 1.0).  Nodes with no usable
    samples are absent from the result; an entirely unusable trace raises
    ``CalibrationError``.
    """
    out: dict = {}
    for name in trace.node_names():
        tr = trace.for_node(name)
        keep = (tr.dur_s > 0) & (tr.work_done > 0)
        if not keep.any():
            continue
        work = tr.work_done[keep]
        wall = float(tr.dur_s[keep].sum())
        demand = float((work / tr.freq[keep]).sum())
        out[name] = SpeedFit(speed=demand / wall, n_samples=int(keep.sum()),
                             work_s=float(work.sum()), wall_s=wall)
    if not out:
        raise CalibrationError("speed fit: no usable samples in trace")
    if reference is not None:
        if reference not in out:
            raise CalibrationError(
                f"speed fit: reference node {reference!r} not in trace")
        ref = out[reference].speed
        out = {nm: dataclasses.replace(sf, speed=sf.speed / ref)
               for nm, sf in out.items()}
    return out


def calibrate_nodes(nodes, trace: CounterTrace, *, fit_power: bool = True,
                    fit_speed: bool = True) -> list:
    """Upgrade ``NodeSpec``s to ``CalibratedNodeSpec``s from one trace.

    The end-to-end entry: ``plan_cluster(blocks, calibrate_nodes(nodes,
    trace), ...)`` — or equivalently ``plan_cluster(..., calibration=trace)``
    — plans against fitted speeds/power models instead of the constructed
    constants.  Per-node fits that the trace cannot support (no samples,
    under-determined power family) silently keep that node's existing
    model; a node absent from the trace entirely is returned unchanged.
    """
    from repro_torch.cluster.node import CalibratedNodeSpec
    speeds = {}
    if fit_speed:
        try:
            speeds = fit_node_speeds(trace)
        except CalibrationError:
            speeds = {}
    out = []
    for nd in nodes:
        pf = None
        if fit_power:
            try:
                pf = fit_power_model(trace, node=nd.name)
            except CalibrationError:
                pf = None
        sf = speeds.get(nd.name)
        if pf is None and sf is None:
            out.append(nd)
            continue
        out.append(CalibratedNodeSpec(
            name=nd.name,
            speed=sf.speed if sf is not None else nd.speed,
            ladder=nd.ladder,
            power=pf.to_power_model() if pf is not None else nd.power,
            power_fit=pf, speed_fit=sf))
    return out
