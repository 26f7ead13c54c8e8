"""Loop-based reference oracles for the vectorized planner/sampler hot path.

These are the original (pre-vectorization) implementations, kept verbatim as
equivalence oracles: ``plan_dvfs`` / ``plan_cluster`` / ``sample_block_cost``
must produce IDENTICAL plans (same frequencies, energies within 1e-9) and
identical estimates.  ``tests/test_vectorized_equivalence.py`` enforces the
contract across random ladders, power models, rooflines, and deadlines, and
``benchmarks/run.py`` section ``planner_scale`` re-checks it at small n before
reporting speedups.

Nothing here is exported through ``repro.core``; import the module directly.
Do not "optimize" this file — its value is being the slow, obviously-correct
original.

Copied from ``src/repro/core/_reference.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import heapq
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.energy import DEFAULT_LADDER, FrequencyLadder, PowerModel, TPU_V5E_POWER
from repro_torch.core.sampling import BlockEstimate

__all__ = [
    "run_downclock_heap_loops",
    "plan_dvfs_reference",
    "sample_block_cost_reference",
    "sample_blocks_reference",
]


def run_downclock_heap_loops(n: int, states_of, time_of, energy_of,
                             pos: list, times: list, energies: list,
                             step_ok, on_step=None) -> None:
    """Original callback-driven ΔE/Δt greedy core (one python call per lookup).

    Repeatedly takes the single down-clock step with the best energy-saved /
    time-added ratio while its governing budget accepts it, via a lazily
    validated max-heap.  Mutates ``pos``/``times``/``energies`` in place.

      states_of(i)      item i's ladder states (ascending, ends at f_max)
      time_of(i, f)     item i's processing time at frequency f
      energy_of(i,t,f)  item i's busy energy for t seconds at f
      step_ok(i, dt)    True if adding dt to item i's budget still fits
      on_step(i, dt)    budget bookkeeping after a step is taken
    """
    def step_gain(i):
        p = pos[i]
        if p == 0:
            return None
        f_lo = states_of(i)[p - 1]
        t_lo = time_of(i, f_lo)
        dt = t_lo - times[i]
        e_lo = energy_of(i, t_lo, f_lo)
        de = energies[i] - e_lo
        if de <= 1e-15:
            return None
        return (-de / max(dt, 1e-12), i, p - 1, t_lo, e_lo, dt)

    heap = []
    for i in range(n):
        g = step_gain(i)
        if g is not None:
            heapq.heappush(heap, g)
    while heap:
        _, i, target, t_lo, e_lo, dt = heapq.heappop(heap)
        if target != pos[i] - 1:
            continue  # stale entry
        if not step_ok(i, dt):
            continue  # this budget is out of slack; other items may still fit
        pos[i] = target
        times[i] = t_lo
        energies[i] = e_lo
        if on_step is not None:
            on_step(i, dt)
        g = step_gain(i)
        if g is not None:
            heapq.heappush(heap, g)


def plan_dvfs_reference(
    blocks,
    deadline_s: float,
    *,
    planner: str = "paper",
    ladder: FrequencyLadder = DEFAULT_LADDER,
    power: PowerModel = TPU_V5E_POWER,
    error_margin: float = 0.05,
    adaptive_margin: bool = False,
):
    """Original loop-bound ``plan_dvfs`` (O(n²·states) paper repair scan)."""
    from repro_torch.core.scheduler import (BlockPlan, SchedulePlan, _block_energy,
                                      _required_freq, block_time)
    n = len(blocks)
    if n == 0:
        return SchedulePlan(planner, deadline_s, (), True)
    if planner not in ("paper", "global", "slack_pool", "roofline"):
        raise ValueError(f"unknown planner: {planner}")
    if planner == "slack_pool":  # historical alias
        planner = "global"

    slot = deadline_s / n  # Algorithm 1 line 3: equal time slots

    def margin_for(b) -> float:
        return max(error_margin, b.est_rel_halfwidth) if adaptive_margin \
            else error_margin

    if planner == "paper":
        # Per-slot frequency choice; a block that overflows its slot even at
        # f_max simply runs at f_max (cheap blocks' slack absorbs it).
        freqs = []
        for b in blocks:
            budget = slot * (1.0 - margin_for(b))
            freqs.append(_required_freq(b, budget, ladder, power))
        # Algorithm 1 line 5 (while TPT < D): repair pass — if the per-slot
        # plan still overruns the total deadline, undo the down-clocks that
        # cost the most time per joule saved until TPT fits.  O(n²·states):
        # every while-iteration rescans every block.
        state_idx = {round(f, 6): i for i, f in enumerate(ladder.states)}
        pos = [state_idx[round(f, 6)] for f in freqs]
        times = [block_time(b, ladder.states[p]) for b, p in zip(blocks, pos)]
        total_t = sum(times)
        target = deadline_s * (1.0 - error_margin)
        while total_t > target + 1e-9:
            best, best_rate = None, -1.0
            for i, b in enumerate(blocks):
                if pos[i] >= len(ladder.states) - 1:
                    continue
                f_hi = ladder.states[pos[i] + 1]
                dt = times[i] - block_time(b, f_hi)  # time recovered (>=0)
                de = (_block_energy(power, b, block_time(b, f_hi), f_hi)
                      - _block_energy(power, b, times[i], ladder.states[pos[i]]))
                rate = dt / max(de, 1e-12)  # time recovered per extra joule
                if rate > best_rate:
                    best, best_rate = i, rate
            if best is None:
                break  # everything already at f_max
            pos[best] += 1
            new_t = block_time(blocks[best], ladder.states[pos[best]])
            total_t += new_t - times[best]
            times[best] = new_t
        plans = []
        for i, b in enumerate(blocks):
            f = ladder.states[pos[i]]
            plans.append(BlockPlan(b.index, slot, f, times[i],
                                   _block_energy(power, b, times[i], f)))
        feasible = total_t <= deadline_s + 1e-9
        return SchedulePlan("paper", deadline_s, tuple(plans), feasible)

    # --- global greedy ("global" / "roofline") ------------------------------
    states = ladder.states
    pos = [len(states) - 1 for _ in blocks]  # index into ladder per block
    times = [block_time(b, 1.0) for b in blocks]
    energies = [_block_energy(power, b, t, 1.0) for b, t in zip(blocks, times)]
    budget_total = deadline_s * (1.0 - error_margin)
    total = {"t": sum(times)}

    def on_step(i: int, dt: float) -> None:
        total["t"] += dt

    run_downclock_heap_loops(
        n,
        lambda i: states,
        lambda i, f: block_time(blocks[i], f),
        lambda i, t, f: _block_energy(power, blocks[i], t, f),
        pos, times, energies,
        step_ok=lambda i, dt: total["t"] + dt <= budget_total + 1e-9,
        on_step=on_step,
    )

    plans = []
    for i, b in enumerate(blocks):
        f = states[pos[i]]
        plans.append(BlockPlan(b.index, slot, f, times[i], energies[i]))
    feasible = sum(times) <= deadline_s + 1e-9
    return SchedulePlan(planner, deadline_s, tuple(plans), feasible)


def sample_block_cost_reference(
    record_costs: Sequence[float] | np.ndarray,
    *,
    fraction: float = 0.05,
    min_samples: int = 16,
    n_boot: int = 200,
    confidence: float = 0.95,
    seed: int = 0,
    cost_fn: Callable[[np.ndarray], np.ndarray] | None = None,
) -> BlockEstimate:
    """Original ``sample_block_cost`` with the 200-iteration bootstrap loop."""
    costs = np.asarray(record_costs, dtype=np.float64)
    n = len(costs)
    if n == 0:
        return BlockEstimate(0.0, 0.0, 0.0, 0, 0)
    rng = np.random.default_rng(seed)
    k = min(n, max(min_samples, int(np.ceil(fraction * n))))
    idx = rng.choice(n, size=k, replace=False)
    sampled = costs[idx]
    if cost_fn is not None:
        sampled = np.asarray(cost_fn(sampled), dtype=np.float64)

    est_total = float(sampled.mean() * n)
    # bootstrap CI on the mean — one python-level resample per iteration
    boots = np.empty(n_boot)
    for b in range(n_boot):
        boots[b] = sampled[rng.integers(0, k, size=k)].mean()
    lo_q, hi_q = (1 - confidence) / 2, 1 - (1 - confidence) / 2
    ci_low = float(np.quantile(boots, lo_q) * n)
    ci_high = float(np.quantile(boots, hi_q) * n)
    return BlockEstimate(total=est_total, ci_low=ci_low, ci_high=ci_high,
                         n_sampled=k, n_records=n)


def sample_blocks_reference(block_costs, **kw) -> list:
    """Loop analogue of the batched ``sample_blocks`` API.

    Block i draws from an rng seeded ``(seed, i)`` — the same convention the
    batched implementation uses, so estimates must match exactly.
    """
    seed = kw.pop("seed", 0)
    return [sample_block_cost_reference(costs, seed=np.random.SeedSequence((seed, i)),
                                        **kw)
            for i, costs in enumerate(block_costs)]
