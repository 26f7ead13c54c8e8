"""DV-DVFS scheduler — Algorithm 1 (paper-faithful) + beyond-paper planners.

Paper Algorithm 1:
    divide Deadline into N_DP equal time slots
    divide InputData into N_DP equal-size blocks
    sample every block  -> estimate PT_i at f_max
    estimate SFB_i      -> lowest frequency finishing B_i inside TS_i (minus margin)

Planners:
  * ``paper``   — exact Algorithm 1: equal slots, per-slot lowest feasible frequency,
                  fixed error margin (paper Fig. 5's reserved area).
  * ``global``  — beyond-paper: Algorithm 1 samples ALL blocks before deciding, so the
                  plan is offline — a global greedy can trade slack across blocks:
                  start at f_max everywhere, repeatedly take the single down-clock step
                  with the best energy-saved / time-added ratio while the total still
                  fits the deadline (minus margin).  Strictly dominates equal slots at
                  tight deadlines.
  * ``roofline``— beyond-paper TPU adaptation: ``global`` driven by per-block roofline
                  time models ``PT(f) = max(T_comp·f_max/f, T_mem, T_coll)``.  Memory/
                  collective-bound blocks down-clock to their zero-cost point for FREE
                  (Δtime = 0), so the greedy takes those first.
  * DVO baseline — Data-Variety-Oblivious: f_max everywhere (paper's comparison).

Hot path
========
All planners run off per-block ``(n_blocks, n_states)`` time/energy tables
(``block_time_table`` / ``busy_energy_table``) precomputed once as NumPy
arrays; the shared ΔE/Δt greedy (``_run_downclock_tables``) and the paper
planner's repair pass are heap-driven table lookups, so planning scales to
100k+ blocks (see ``benchmarks/run.py`` section ``planner_scale``).  The
single-budget tight-deadline regime (budget-binding kills dominating) is a
fully array-level round loop — see ``_downclock_sorted_scan`` — with no
per-step python tail.  The original loop implementations live in
``repro.core._reference`` as equivalence oracles: same frequencies, energies
within 1e-9.

SoA path
========
``plan_dvfs_arrays`` / ``plan_dvo_arrays`` are the same planners over
``repro.core.soa.BlockArrays`` returning ``PlanArrays`` — zero per-block
Python objects end to end.  ``plan_dvfs`` / ``plan_dvo`` are thin object
wrappers over them, so the two paths cannot diverge.

Copied from ``src/repro/core/scheduler.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
from typing import Sequence

import numpy as np

from repro_torch.core.energy import DEFAULT_LADDER, FrequencyLadder, PowerModel, TPU_V5E_POWER
from repro_torch.core.estimator import RooflineTimeModel
from repro_torch.core.soa import BlockArrays, PlanArrays

__all__ = [
    "BlockInfo", "BlockPlan", "SchedulePlan", "ExecutionReport",
    "block_time_table", "block_time_table_arrays", "busy_energy_table",
    "plan_dvfs", "plan_dvfs_arrays", "plan_dvo", "plan_dvo_arrays",
    "simulate",
]


@dataclasses.dataclass(frozen=True)
class BlockInfo:
    """What the planner knows about one block."""

    index: int
    est_time_fmax: float                    # estimated PT_i at f_max (from sampling)
    est_rel_halfwidth: float = 0.0          # estimation uncertainty (CI halfwidth / PT)
    util: float = 1.0                       # busy utilization while processing
    roofline: RooflineTimeModel | None = None  # optional TPU time model
    records: float = 0.0                    # data size (records); 0 = unknown


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    index: int
    slot_s: float
    rel_freq: float
    pred_time_s: float
    pred_energy_j: float


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    planner: str
    deadline_s: float
    blocks: tuple
    feasible: bool

    # cached: planner loops and the auto-assignment search read these totals
    # repeatedly; re-summing 100k blocks per access was itself a hot spot
    @functools.cached_property
    def pred_total_time(self) -> float:
        return sum(b.pred_time_s for b in self.blocks)

    @functools.cached_property
    def pred_total_energy(self) -> float:
        return sum(b.pred_energy_j for b in self.blocks)


@dataclasses.dataclass(frozen=True)
class ExecutionReport:
    planner: str
    total_time_s: float
    total_energy_j: float          # paper EC (formula 7): busy-only
    idle_energy_j: float           # idle tail up to the deadline window
    deadline_s: float
    deadline_met: bool
    per_block_time: tuple
    per_block_energy: tuple

    def improvement_vs(self, other: "ExecutionReport") -> float:
        """Fractional energy improvement of self over ``other`` (paper's metric)."""
        if other.total_energy_j <= 0:
            return 0.0
        return 1.0 - self.total_energy_j / other.total_energy_j


def block_time(block: BlockInfo, rel_freq: float) -> float:
    """PT_i at frequency f.

    Roofline-aware when the block carries a time model (the model's compute term is
    rescaled so that PT(f_max) matches the sampled estimate); otherwise the paper's
    pure compute scaling PT(f) = PT(f_max)·f_max/f.
    """
    if block.roofline is not None:
        scale = block.est_time_fmax / max(block.roofline.time_at(1.0), 1e-12)
        return block.roofline.time_at(rel_freq) * scale
    return block.est_time_fmax / max(rel_freq, 1e-6)


def _required_freq(block: BlockInfo, budget_s: float, ladder: FrequencyLadder,
                   power: PowerModel) -> float:
    """Cheapest ladder state finishing the block within ``budget_s``.

    Algorithm 1 says "lowest feasible frequency", under the paper's premise
    that lower clocks always cost less energy — true for its CPU model, but
    the TPU busy energy t·P(f) is U-shaped in f (the idle floor stretches
    with time), so blindly taking the lowest state can cost MORE than f_max.
    Picking the minimum-energy feasible state is identical to the paper's
    rule whenever energy decreases monotonically with falling f, and clamps
    at the energy-optimal state otherwise.  f_max if nothing fits.
    """
    if budget_s <= 0:
        return ladder.f_max
    best_f, best_e = None, float("inf")
    for f in ladder.states:
        t = block_time(block, f)
        if t > budget_s + 1e-12:
            continue
        e = _block_energy(power, block, t, f)
        if e < best_e - 1e-15:
            best_f, best_e = f, e
    return best_f if best_f is not None else ladder.f_max


def _block_energy(power: PowerModel, block: BlockInfo, t: float,
                  f: float) -> float:
    """Paper EC term (formula 7): busy-only processing energy."""
    return power.busy_energy(t, f, util=block.util)


# --- vectorized planning tables --------------------------------------------

def block_time_table_arrays(ba: BlockArrays, states) -> np.ndarray:
    """Per-block processing times from SoA inputs (see ``block_time_table``).

    Every arithmetic step mirrors the scalar ``block_time`` op-for-op so
    table entries are bitwise identical to what the loop reference computes.
    """
    states_arr = np.asarray(states, dtype=np.float64)
    f_safe = np.maximum(states_arr, 1e-6)
    est = ba.est_time_fmax
    times = est[:, None] / f_safe[None, :]

    if ba.roofline is not None and ba.roofline.has.any():
        roof = ba.roofline.has
        t_comp = ba.roofline.t_comp[roof]
        t_mem = ba.roofline.t_mem[roof]
        t_coll = ba.roofline.t_coll[roof]
        t_fixed = ba.roofline.t_fixed[roof]
        time_at_fmax = np.maximum(np.maximum(t_comp, t_mem), t_coll) + t_fixed
        scale = est[roof] / np.maximum(time_at_fmax, 1e-12)
        shaped = np.maximum(
            np.maximum(t_comp[:, None] / f_safe[None, :], t_mem[:, None]),
            t_coll[:, None]) + t_fixed[:, None]
        times[roof] = shaped * scale[:, None]
    return times


def block_time_table(blocks: Sequence[BlockInfo], states) -> np.ndarray:
    """Per-block processing times: ``out[i, j] == block_time(blocks[i], states[j])``.

    One vectorized pass replaces n·s ``block_time`` calls (object wrapper
    over ``block_time_table_arrays``).
    """
    return block_time_table_arrays(BlockArrays.from_blocks(blocks), states)


def busy_energy_table(times_tab: np.ndarray, utils: np.ndarray, states,
                      power: PowerModel) -> np.ndarray:
    """Busy energies for a time table: ``out[i,j] == busy_energy(t[i,j], states[j])``.

    The per-state ``f**alpha`` factors are evaluated with scalar python pow —
    the same libm call ``PowerModel.power`` makes — so energies match the
    scalar path bitwise.
    """
    fpow = np.array([float(np.clip(f, 0.0, 1.0)) ** power.alpha
                     for f in states], dtype=np.float64)
    util = np.clip(np.asarray(utils, dtype=np.float64), 0.0, 1.0)
    ptab = power.p_idle + (power.p_full - power.p_idle) * util[:, None] * fpow[None, :]
    return times_tab * ptab


def _make_plans(indices, slot: float, freqs, times, energies) -> tuple:
    """Bulk-construct BlockPlans, bypassing the frozen-dataclass __init__
    (one object.__setattr__ per field — ~3x the cost of the plan math at
    100k blocks).  Field semantics identical to BlockPlan(...)."""
    new = object.__new__
    out = []
    for i, f, t, e in zip(indices, freqs, times, energies):
        bp = new(BlockPlan)
        bp.__dict__.update(index=i, slot_s=slot, rel_freq=f,
                           pred_time_s=t, pred_energy_j=e)
        out.append(bp)
    return tuple(out)


def _chain_stops(energies_tab: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Where each item's improving descent ends.

    Walking down from ``pos[i]``, a step p -> p-1 is improving iff
    ``E[i, p-1] < E[i, p] - 1e-15`` (the greedy's gate); the chain stops at
    the first non-improving step.  One O(n_states) sweep over columns; padded
    columns (energy +inf) never count as improving.
    """
    s = energies_tab.shape[1]
    stop = pos.copy()
    improving = energies_tab[:, :-1] < energies_tab[:, 1:] - 1e-15
    for j in range(s - 2, -1, -1):
        step = improving[:, j] & (stop == j + 1)
        stop[step] = j
    return stop


def _downclock_sorted_scan(times_tab: np.ndarray, energies_tab: np.ndarray,
                           pos: np.ndarray, times: np.ndarray,
                           energies: np.ndarray, stop: np.ndarray,
                           group_total: np.ndarray,
                           group_budget: np.ndarray,
                           exact: bool = True) -> bool:
    """Single-pool greedy as one sorted pass (returns False when inapplicable).

    When every item's ΔE/Δt keys are monotone along its descent chain
    (diminishing returns — true for convex power curves, checked here at
    runtime), the heap's pop order IS the global sort order of all chain
    steps by ``(key, item, chain position)``: an item's next step only enters
    the heap after its previous one, and monotone keys mean it can never
    overtake.  So the greedy becomes a scan of the sorted steps where a
    rejected step retires its item — exactly the heap's no-retry semantics.

    The scan itself is a round loop of whole-array passes (no per-step
    python), built on three exact facts about the sequential process:

      * the running total never decreases, so any step over budget at the
        CURRENT total is rejected whenever the scan reaches it, and a
        rejected step's sole effect is retiring its item — the step and its
        chain suffix can be dropped the moment it first overflows (the
        bucketed-Δt prune: one threshold, ``budget - total``, splits the
        pending steps into retired / still-eligible in a single pass);
      * WHEN a rejection retires an item is unobservable: the retired item's
        pending step can never be accepted later (the total only grows), and
        its chain suffix is gated behind that step — so rejections need no
        ordering at all, only accepts do;
      * between two rejections every step is accepted, so a whole stretch
        resolves as one cumsum seeded with the running total (the cumsum's
        left-to-right accumulation reproduces the reference's ``total += dt``
        to the last ulp).

    Because only accepted stretches are order-sensitive, the sort itself is
    lazy: an incrementally-extended sorted WINDOW of smallest-key steps
    (ties never straddle the boundary, so stable in-window order equals the
    global sort order) is scanned round by round — prune at the current
    total, accept one maximal cumsum stretch, compact — and the unsorted
    pool is only sorted chunk by chunk as the scan actually reaches it.  In
    the kill-dominated tight-deadline regime most steps retire via the
    threshold prune without ever being sorted, which is what keeps this
    regime within shouting distance of the ample one.  Mutates state and
    returns True on success; returns False (state untouched) for
    non-monotone keys, leaving the heap path to handle them.
    """
    n = len(pos)
    counts = pos - stop
    idx = np.repeat(np.arange(n), counts)
    if len(idx) == 0:
        return True
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    stepno = np.arange(len(idx)) - np.repeat(starts, counts)
    levels = pos[idx] - 1 - stepno
    s = times_tab.shape[1]
    # per-step dt/de off adjacent table columns: one flat gather from the
    # (n, s-1) diff tables instead of four from the raw tables.  The diffs
    # are the same two-operand subtractions the scalar path performs, so
    # values are bitwise identical.
    flat = idx * (s - 1) + levels
    dt = (times_tab[:, :s - 1] - times_tab[:, 1:]).ravel().take(flat)
    de = (energies_tab[:, 1:] - energies_tab[:, :s - 1]).ravel().take(flat)
    # first step of each chain prices off the item's exact initial values
    # (the ladder top may not be exactly 1.0); later steps off the table
    fpos = starts[counts > 0]
    fitem = idx[fpos]
    flev = levels[fpos]
    dt[fpos] = times_tab[fitem, flev] - times[fitem]
    de_first = energies[fitem] - energies_tab[fitem, flev]
    de[fpos] = de_first
    if not np.all(de_first > 1e-15):
        return False  # chain gate priced differently off-table: rare, punt
    keys = -de / np.maximum(dt, 1e-12)
    nondecr = keys[1:] >= keys[:-1]
    if not np.all(nondecr | (idx[1:] != idx[:-1])):
        return False  # non-monotone chain: heap order != sort order
    if not exact:
        # bucketed-key mode: quantize the float keys into ~1024 integer
        # ranks.  Floor quantization is monotone, so the per-chain
        # nondecreasing property (just verified) survives, and the integer
        # keys sort via radix instead of comparison.  Steps in one bucket
        # resolve in (item, chain position) order — still deterministic,
        # but in-bucket the greedy's exact ratio order is given up, which
        # can cost at most one bucket width of ΔE/Δt optimality per accept
        # (the budget itself is still respected exactly).
        lo = float(keys.min())
        step = (float(keys.max()) - lo) / 1024.0
        if step > 0.0:
            keys = np.floor((keys - lo) / step).astype(np.int64)
        else:
            keys = np.zeros(len(keys), dtype=np.int64)

    total = float(group_total[0])
    budget = float(group_budget[0])
    final = pos.copy()
    cut = np.full(n, -1, dtype=np.int64)  # highest retired level per item

    # pop order == sort by (key, item, chain position): the steps sit
    # item-major with levels descending, so a STABLE sort by key alone
    # leaves equal-key runs in exactly that (item, chain position) order.
    # The sort is windowed: only steps the scan actually reaches get sorted.
    # Initial window ~ enough average-sized steps to cross the budget.
    m = len(keys)
    mean_dt = float(dt.mean())
    slack = budget - total
    w0 = m if mean_dt <= 0 else int(min(m, max(4096, 1.5 * slack / mean_dt)))
    pi, pl, pd, pk = idx, levels, dt, keys  # pool, original (tie) order
    wi = np.empty(0, dtype=pi.dtype)
    wl = np.empty(0, dtype=pl.dtype)
    wd = np.empty(0)
    chunk = max(w0, 1)
    while True:
        if len(wi) == 0:
            if len(pi) == 0:
                break
            kth = min(chunk, len(pi)) - 1
            if kth == len(pi) - 1:  # chunk swallows the pool: take it whole
                ci, cl, cd, ck = pi, pl, pd, pk
                pi = pi[:0]
                pl, pd, pk = pl[:0], pd[:0], pk[:0]
            else:
                bound = np.partition(pk, kth)[kth]
                take = pk <= bound  # tie-inclusive: ties never straddle
                ci, cl, cd, ck = pi[take], pl[take], pd[take], pk[take]
                rest = ~take
                pi, pl, pd, pk = pi[rest], pl[rest], pd[rest], pk[rest]
            chunk *= 2
            live = cl > cut[ci]  # retired items' chain suffixes never run
            if not live.all():
                ci, cl, cd = ci[live], cl[live], cd[live]
                ck = ck[live]
            # pre-sort prune: in the tight regime most of a late chunk is
            # already over budget — retire those before paying the sort
            killer = total + cd > budget + 1e-9
            if killer.any():
                np.maximum.at(cut, ci[killer], cl[killer])
                live = cl > cut[ci]
                ci, cl, cd = ci[live], cl[live], cd[live]
                ck = ck[live]
            if len(ci) == 0:
                continue
            o = np.argsort(ck, kind="stable")
            wi, wl, wd = ci[o], cl[o], cd[o]
        # prune: every step over budget at the current total is rejected
        # whenever reached; rejection retires its item, so the step and the
        # chain levels at or below it drop out in one threshold pass
        killer = total + wd > budget + 1e-9
        if killer.any():
            np.maximum.at(cut, wi[killer], wl[killer])
            keep = wl > cut[wi]
            wi, wl, wd = wi[keep], wl[keep], wd[keep]
            if len(wi) == 0:
                continue
        # accept stretch: cumsum seeded with the running total, stop at the
        # first step pushing past the budget (post-prune the window head
        # always fits, so every pass accepts at least one step)
        tot = np.cumsum(np.concatenate(([total], wd)))[1:]
        v = int(np.searchsorted(tot, budget + 1e-9, side="right"))
        np.minimum.at(final, wi[:v], wl[:v])
        total = float(tot[v - 1]) if v else total
        wi, wl, wd = wi[v:], wl[v:], wd[v:]
    group_total[0] = total
    moved = final < pos
    rows = np.arange(n)
    times[moved] = times_tab[rows[moved], final[moved]]
    energies[moved] = energies_tab[rows[moved], final[moved]]
    pos[moved] = final[moved]
    return True


def _run_downclock_tables(times_tab: np.ndarray, energies_tab: np.ndarray,
                          pos: np.ndarray, times: np.ndarray,
                          energies: np.ndarray, group: np.ndarray,
                          group_total: np.ndarray,
                          group_budget: np.ndarray,
                          exact: bool = True) -> None:
    """Shared ΔE/Δt greedy core over precomputed tables (single-node + cluster).

    Exact table-driven analogue of the callback greedy in
    ``repro.core._reference.run_downclock_heap_loops``: repeatedly take the
    single down-clock step with the best energy-saved / time-added ratio
    while the stepped item's budget pool accepts it.  ``group`` maps each
    item to a budget pool (one pool single-node, one per node cluster-wide);
    ``group_total``/``group_budget`` carry the pools' running busy time and
    budgets.  ``pos``/``times``/``energies``/``group_total`` are mutated in
    place.

    Fast path: when every item's improving-descent chain fits its pool
    budget, the greedy provably accepts every step (per-step Δt >= 0, so
    pool totals rise monotonically toward the final sum) — resolved with
    pure array ops, no heap.
    """
    n = len(pos)
    if n == 0:
        return
    rows = np.arange(n)
    stop = _chain_stops(energies_tab, pos)
    moved = stop < pos  # unmoved items keep their exact initial values
    dt_group = np.zeros(len(group_total))
    np.add.at(dt_group, group[moved],
              times_tab[rows[moved], stop[moved]] - times[moved])
    if np.all(group_total + dt_group <= group_budget + 1e-9):
        pos[moved] = stop[moved]
        times[moved] = times_tab[rows[moved], stop[moved]]
        energies[moved] = energies_tab[rows[moved], stop[moved]]
        group_total += dt_group
        return

    if len(group_total) == 1:
        # budget-binding single pool: the sorted-scan path resolves the bulk
        # of the greedy with array ops when it is provably heap-equivalent
        if _downclock_sorted_scan(times_tab, energies_tab, pos, times,
                                  energies, stop, group_total, group_budget,
                                  exact=exact):
            return
    else:
        # per-pool budgets are independent: a step's acceptance reads only
        # its own pool's total/budget, and steps in different pools commute,
        # so the global best-ratio greedy restricted to one pool IS that
        # pool's best-ratio greedy — decompose exactly into single-pool runs
        # (each of which gets the all-fits / sorted-scan fast paths)
        for g in range(len(group_total)):
            sel = np.nonzero(group == g)[0]
            if len(sel) == 0:
                continue
            sub_pos = pos[sel]
            sub_t = times[sel]
            sub_e = energies[sel]
            _run_downclock_tables(times_tab[sel], energies_tab[sel],
                                  sub_pos, sub_t, sub_e,
                                  np.zeros(len(sel), dtype=np.int64),
                                  group_total[g:g + 1],
                                  group_budget[g:g + 1], exact=exact)
            pos[sel] = sub_pos
            times[sel] = sub_t
            energies[sel] = sub_e
        return

    # budget-binding pool: lazily validated max-heap over table lookups
    cand = np.nonzero(pos > 0)[0]
    p = pos[cand]
    t_lo = times_tab[cand, p - 1]
    e_lo = energies_tab[cand, p - 1]
    dt = t_lo - times[cand]
    de = energies[cand] - e_lo
    keep = de > 1e-15
    heap = list(zip((-de[keep] / np.maximum(dt[keep], 1e-12)).tolist(),
                    cand[keep].tolist(), (p[keep] - 1).tolist(),
                    t_lo[keep].tolist(), e_lo[keep].tolist(),
                    dt[keep].tolist()))
    heapq.heapify(heap)
    while heap:
        _, i, target, t_lo_i, e_lo_i, dt_i = heapq.heappop(heap)
        if target != pos[i] - 1:
            continue  # stale entry
        g = group[i]
        if not group_total[g] + dt_i <= group_budget[g] + 1e-9:
            continue  # this pool is out of slack; other items may still fit
        pos[i] = target
        times[i] = t_lo_i
        energies[i] = e_lo_i
        group_total[g] += dt_i
        if target > 0:
            t2 = float(times_tab[i, target - 1])
            e2 = float(energies_tab[i, target - 1])
            de2 = e_lo_i - e2
            if de2 > 1e-15:
                heapq.heappush(heap, (-de2 / max(t2 - t_lo_i, 1e-12), i,
                                      target - 1, t2, e2, t2 - t_lo_i))


def plan_dvfs_arrays(
    ba: BlockArrays,
    deadline_s: float,
    *,
    planner: str = "paper",
    ladder: FrequencyLadder = DEFAULT_LADDER,
    power: PowerModel = TPU_V5E_POWER,
    error_margin: float = 0.05,
    adaptive_margin: bool = False,
    exact: bool = True,
) -> PlanArrays:
    """``plan_dvfs`` over SoA inputs: ``BlockArrays`` in, ``PlanArrays`` out.

    No per-block Python objects are created at any point — this is the
    streamed-pipeline planner entry (``repro.pipeline``).  ``plan_dvfs`` is a
    thin wrapper over this function, so the two paths produce identical
    plans by construction.

    ``exact=False`` relaxes the global-greedy sorted scan's key sort to
    ~1024 integer buckets (radix-sortable) in the tight-deadline regime —
    same feasibility guarantee and deterministic output, energy within a
    bucket width of the exact greedy per step (``tests/test_scheduler.py``
    pins the bound).  The "paper" planner ignores it (no sorted scan).
    """
    n = len(ba)
    if n == 0:
        e = np.zeros(0)
        return PlanArrays(planner, deadline_s, deadline_s, ba.index,
                          e, e.copy(), e.copy(), True)
    if planner not in ("paper", "global", "slack_pool", "roofline"):
        raise ValueError(f"unknown planner: {planner}")
    if planner == "slack_pool":  # historical alias
        planner = "global"

    slot = deadline_s / n  # Algorithm 1 line 3: equal time slots
    states = ladder.states
    states_arr = np.asarray(states, dtype=np.float64)
    s = len(states)
    rows = np.arange(n)
    utils = ba.util
    times_tab = block_time_table_arrays(ba, states)
    energies_tab = busy_energy_table(times_tab, utils, states, power)

    if planner == "paper":
        # Per-slot frequency choice (Algorithm 1's lowest-feasible rule,
        # energy-clamped — see _required_freq): ascending state sweep keeps
        # the lowest state within 1e-15 of the feasible energy minimum.  A
        # block that overflows its slot even at f_max runs at f_max.
        if adaptive_margin:
            margins = np.maximum(error_margin, ba.est_rel_halfwidth)
        else:
            margins = np.full(n, error_margin)
        budgets = slot * (1.0 - margins)
        best_e = np.full(n, np.inf)
        best_pos = np.full(n, -1, dtype=np.int64)
        for j in range(s):
            e = energies_tab[:, j]
            upd = (times_tab[:, j] <= budgets + 1e-12) & (e < best_e - 1e-15)
            best_e[upd] = e[upd]
            best_pos[upd] = j
        pos = np.where((best_pos < 0) | (budgets <= 0), s - 1, best_pos)
        times = times_tab[rows, pos].copy()
        energies = energies_tab[rows, pos].copy()
        # Algorithm 1 line 5 (while TPT < D): repair pass — if the per-slot
        # plan still overruns the total deadline, undo the down-clocks that
        # cost the most time per joule saved until TPT fits.  Heap-driven:
        # a block's up-step rate only changes when that block steps, so lazy
        # invalidation reproduces the full O(n·states) rescan exactly.
        total_t = sum(times.tolist())
        target = deadline_s * (1.0 - error_margin)
        if total_t > target + 1e-9:
            cand = np.nonzero(pos < s - 1)[0]
            t_hi = times_tab[cand, pos[cand] + 1]
            e_hi = energies_tab[cand, pos[cand] + 1]
            rates = (times[cand] - t_hi) / np.maximum(e_hi - energies[cand],
                                                      1e-12)
            heap = list(zip((-rates).tolist(), cand.tolist(),
                            (pos[cand] + 1).tolist(), t_hi.tolist(),
                            e_hi.tolist()))
            heapq.heapify(heap)
            while total_t > target + 1e-9 and heap:
                _, i, tgt, t_hi_i, e_hi_i = heapq.heappop(heap)
                if tgt != pos[i] + 1:
                    continue  # stale entry
                pos[i] = tgt
                total_t += t_hi_i - times[i]
                times[i] = t_hi_i
                energies[i] = e_hi_i
                if tgt < s - 1:
                    t2 = float(times_tab[i, tgt + 1])
                    e2 = float(energies_tab[i, tgt + 1])
                    rate2 = (t_hi_i - t2) / max(e2 - e_hi_i, 1e-12)
                    heapq.heappush(heap, (-rate2, i, tgt + 1, t2, e2))
        feasible = bool(total_t <= deadline_s + 1e-9)
        return PlanArrays("paper", deadline_s, slot, ba.index,
                          states_arr[pos], times, energies, feasible)

    # --- global greedy ("global" / "roofline") ------------------------------
    # state: per-block ladder position (start at f_max); lower the block whose
    # next down-step has the best ΔE/Δt while total time fits
    # deadline*(1-margin).  Initial times/energies at rel_freq=1.0 exactly
    # (the ladder top may sit within 1e-9 of 1.0 without being 1.0).
    pos = np.full(n, s - 1, dtype=np.int64)
    times = block_time_table_arrays(ba, (1.0,))[:, 0]
    energies = busy_energy_table(times[:, None], utils, (1.0,), power)[:, 0]
    group_total = np.array([sum(times.tolist())])
    group_budget = np.array([deadline_s * (1.0 - error_margin)])
    _run_downclock_tables(times_tab, energies_tab, pos, times, energies,
                          np.zeros(n, dtype=np.int64), group_total,
                          group_budget, exact=exact)
    feasible = bool(sum(times.tolist()) <= deadline_s + 1e-9)
    return PlanArrays(planner, deadline_s, slot, ba.index,
                      states_arr[pos], times, energies, feasible)


def plan_dvfs(
    blocks: Sequence[BlockInfo],
    deadline_s: float,
    *,
    planner: str = "paper",
    ladder: FrequencyLadder = DEFAULT_LADDER,
    power: PowerModel = TPU_V5E_POWER,
    error_margin: float = 0.05,
    adaptive_margin: bool = False,
) -> SchedulePlan:
    """Build a frequency plan for ``blocks`` under ``deadline_s``.

    ``error_margin`` reserves a fraction of the budget (paper Fig. 5's "reserved
    area").  With ``adaptive_margin`` the reserve becomes max(error_margin, block CI
    half-width): sampling uncertainty drives the reserve.
    """
    if len(blocks) == 0:
        return SchedulePlan(planner, deadline_s, (), True)
    pa = plan_dvfs_arrays(BlockArrays.from_blocks(blocks), deadline_s,
                          planner=planner, ladder=ladder, power=power,
                          error_margin=error_margin,
                          adaptive_margin=adaptive_margin)
    return SchedulePlan(pa.planner, deadline_s, pa.to_blocks(), pa.feasible)


def plan_dvo_arrays(
    ba: BlockArrays,
    deadline_s: float,
    *,
    power: PowerModel = TPU_V5E_POWER,
) -> PlanArrays:
    """SoA Data-Variety-Oblivious baseline (see ``plan_dvo``)."""
    n = max(len(ba), 1)
    slot = deadline_s / n
    times = block_time_table_arrays(ba, (1.0,))[:, 0]
    energies = busy_energy_table(times[:, None], ba.util, (1.0,), power)[:, 0]
    feasible = bool(sum(times.tolist()) <= deadline_s + 1e-9)
    return PlanArrays("dvo", deadline_s, slot, ba.index,
                      np.ones(len(ba)), times, energies, feasible)


def plan_dvo(
    blocks: Sequence[BlockInfo],
    deadline_s: float,
    *,
    power: PowerModel = TPU_V5E_POWER,
) -> SchedulePlan:
    """Data-Variety-Oblivious baseline: everything at f_max, same slot layout."""
    pa = plan_dvo_arrays(BlockArrays.from_blocks(blocks), deadline_s,
                         power=power)
    return SchedulePlan("dvo", deadline_s, pa.to_blocks(), pa.feasible)


def simulate(
    plan: SchedulePlan,
    true_blocks: Sequence[BlockInfo],
    *,
    power: PowerModel = TPU_V5E_POWER,
) -> ExecutionReport:
    """Execute a plan against TRUE block costs (which sampling only estimated).

    ``true_blocks`` mirror the planner's blocks but with ``est_time_fmax`` set to the
    true processing time at f_max.  Blocks run back-to-back (work-conserving): the
    deadline check is on the true total finish time, like the paper's evaluation.
    """
    by_index = {b.index: b for b in true_blocks}
    times, energies = [], []
    for bp in plan.blocks:
        tb = by_index[bp.index]
        t = block_time(tb, bp.rel_freq)
        e = power.busy_energy(t, bp.rel_freq, util=tb.util)
        times.append(t)
        energies.append(e)
    total_busy = float(sum(times))
    idle = max(plan.deadline_s - total_busy, 0.0) * power.p_idle
    return ExecutionReport(
        planner=plan.planner,
        total_time_s=total_busy,
        total_energy_j=float(sum(energies)),
        idle_energy_j=float(idle),
        deadline_s=plan.deadline_s,
        deadline_met=total_busy <= plan.deadline_s + 1e-9,
        per_block_time=tuple(times),
        per_block_energy=tuple(energies),
    )
