"""Miss and energy attribution: why was a job late, where did joules go.

``explain_miss`` decomposes an observed wall interval — a node's span from
t=0 to its last finish, or a job's span from arrival to its terminal event
— into named components:

    queueing        idle-waiting-for-work gaps (and, for jobs, the
                    admission window plus time queued behind other blocks)
    cap_clamp       launch stalls behind the power cap (a ``deferred``
                    marker opened the gap)
    crash           outage overlap (node down inside the window)
    migration       wire-transfer overlap not hidden behind compute
    slowdown        busy seconds attributable to fault degradation
                    (``dur * (1 - 1/factor)`` under an active slowdown)
    actuation       busy seconds lost to async frequency actuation
                    (segments run below the block's eventually-applied
                    frequency: ``dur * (1 - f_seg/f_final)``)
    service         everything else — the residual productive compute

The components tile the window disjointly by construction (gaps are
labelled by a single-cause precedence scan; slowdown/actuation carve the
busy intervals; service absorbs the remainder), and the module guarantees
``math.fsum(components) == wall`` *bitwise*: the residual is computed in
exact rational arithmetic (floats are rationals) and nudged by at most one
ulp so the rounded sum lands exactly on the observed wall.  Both engines
produce identical logs, hence identical decompositions.

``explain_energy`` does the same for joules: the cluster split is exactly
the report's ledger channels (busy / idle / switch / wire / failed — their
sum *is* the observed total; there is no other total), and the per-node
split reproduces the engine's own idle formula so that per-node idles sum
— in the engine's own summation order — to ``report.idle_energy_j``.

Copied from ``src/repro/obs/explain.py`` with its imports pointed at
``repro_torch``. It is NumPy, as the original is, so its results are bit-
identical to the reference's.

The exact-sum claim above fails by one ulp on some inputs: on
``_scenario(840380)`` of ``tests/test_runtime_vector.py`` (vector engine),
node ``n1``'s seven parts fsum to 167.95204775588456 where ``wall_s`` is
167.95204775588454.  The copy keeps the reference's arithmetic, and so
that result too.
"""
from __future__ import annotations

import math
from fractions import Fraction

from repro_torch.obs.spans import build_spans, require_full_log

__all__ = ["explain_miss", "explain_energy"]

_MISS_KEYS = ("queueing_s", "cap_clamp_s", "crash_s", "migration_s",
              "slowdown_s", "actuation_s", "service_s")


def _exact_residual(wall: float, parts: list) -> float:
    """The float r with fsum(parts + [r]) == wall, bitwise.

    Computed exactly in rational space, then nudged by single ulps for the
    rare case where rounding r breaks the correctly-rounded total.
    """
    r = Fraction(wall)
    for p in parts:
        r -= Fraction(p)
    out = float(r)
    for _ in range(4):
        tot = math.fsum(parts + [out])
        if tot == wall:
            return out
        out = math.nextafter(out, out + (wall - tot))
    return out


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def _fault_timeline(event_log, node: str) -> list:
    """[(t_start, t_end, factor)] degradation windows (factor > 1)."""
    out: list = []
    cur_t, cur_f = 0.0, 1.0
    for row in event_log:
        if row[1] == "fault" and row[2] == node:
            if cur_f > 1.0:
                out.append((cur_t, row[0], cur_f))
            cur_t, cur_f = row[0], row[3]
    if cur_f > 1.0:
        out.append((cur_t, math.inf, cur_f))
    return out


def _node_components(spans, faults, wall: float, t0: float = 0.0) -> dict:
    """Single-cause tiling of [t0, wall] for one node's span list."""
    comp = {k: 0.0 for k in _MISS_KEYS}
    busy: list = []        # (start, end, span)
    outages: list = []
    wires: list = []
    defers: list = []      # instants: (t, index)
    for s in spans:
        if s.cat in ("block", "crashed", "unfinished"):
            busy.append(s)
        elif s.cat == "outage":
            outages.append((s.start, s.end))
        elif s.cat == "wire":
            wires.append((s.start, s.end))
        elif s.cat == "defer":
            defers.append((s.start, s.get("index")))

    # busy-interior attribution: slowdown and actuation carve the compute
    slow_parts: list = []
    act_parts: list = []
    for b in busy:
        segs = [c for c in b.children if c.cat == "freq"] or [b]
        f_final = segs[-1].get("freq", 1.0) or 1.0
        for seg in segs:
            for (ft0, ft1, factor) in faults:
                ov = _overlap(seg.start, seg.end, ft0, ft1)
                if ov > 0.0:
                    slow_parts.append(ov * (1.0 - 1.0 / factor))
            f = seg.get("freq", f_final) or f_final
            if f < f_final:
                act_parts.append(seg.dur * (1.0 - f / f_final))

    # gap attribution: activity = busy ∪ outage, scanned left to right;
    # each gap gets exactly one cause by precedence
    activity = sorted([(b.start, b.end, "busy") for b in busy]
                      + [(a, b, "outage") for a, b in outages])
    gap_parts: dict = {"cap_clamp_s": [], "migration_s": [], "queueing_s": []}
    crash_parts: list = []
    cursor = t0
    for (a, b, kind) in activity + [(wall, wall, "end")]:
        if a > cursor:
            g0, g1 = cursor, min(a, wall)
            if g1 > g0:
                if any(t <= g0 + 1e-12 or (g0 <= t < g1) for t, _ in defers):
                    gap_parts["cap_clamp_s"].append(g1 - g0)
                elif any(_overlap(g0, g1, w0, w1) > 0.0 for w0, w1 in wires):
                    gap_parts["migration_s"].append(g1 - g0)
                else:
                    gap_parts["queueing_s"].append(g1 - g0)
        if kind == "outage":
            crash_parts.append(_overlap(a, b, t0, wall))
        cursor = max(cursor, min(b, wall))

    comp["slowdown_s"] = math.fsum(slow_parts)
    comp["actuation_s"] = math.fsum(act_parts)
    comp["crash_s"] = math.fsum(crash_parts)
    for k, parts in gap_parts.items():
        comp[k] = math.fsum(parts)
    fixed = [comp[k] for k in _MISS_KEYS if k != "service_s"]
    comp["service_s"] = _exact_residual(wall - t0, fixed)
    return comp


def explain_miss(report, job_id: int | None = None, node: str | None = None,
                 *, spans: dict | None = None) -> dict:
    """Attribute an observed wall to its causes.  Exactly one of ``node``
    (a node name, decomposing ``[0, finish_s]``) or ``job_id`` (a
    ``ServingReport`` job, decomposing arrival → terminal) is required.

    Returns ``{"wall_s", "missed", components...}`` with
    ``math.fsum(components) == wall_s`` bitwise.
    """
    if (job_id is None) == (node is None):
        raise ValueError("pass exactly one of job_id= or node=")
    runtime = getattr(report, "runtime", report)
    require_full_log(runtime)
    if spans is None:
        spans = build_spans(runtime.event_log)

    if node is not None:
        nr = next((n for n in runtime.node_reports if n.name == node), None)
        if nr is None:
            raise KeyError(f"unknown node {node!r}")
        wall = nr.finish_s
        comp = _node_components(spans.get(node, ()),
                                _fault_timeline(runtime.event_log, node),
                                wall)
        return {"node": node, "wall_s": wall,
                "missed": wall > runtime.deadline_s + 1e-9, **comp}

    if not hasattr(report, "jobs"):
        raise TypeError("job_id= needs a ServingReport")
    jr = next((j for j in report.jobs if j.job_id == job_id), None)
    if jr is None:
        raise KeyError(f"unknown job {job_id}")
    out = {"job_id": jr.job_id, "tenant": jr.tenant, "status": jr.status,
           "missed": not jr.slo_met}
    if jr.status == "rejected":
        out.update({"wall_s": 0.0}, **{k: 0.0 for k in _MISS_KEYS})
        return out

    # terminal time: finish, shed instant, or run end (never finished)
    end = jr.t_finish
    if end < 0.0:
        end = float(runtime.makespan_s)
        for row in runtime.event_log:
            if row[1] == "job_shed" and row[3][0] == jr.job_id:
                end = row[0]
                break
    wall = end - jr.time

    # admission window: arrival → last decision row for this job
    admit_t = jr.time
    for row in runtime.event_log:
        if row[1] == "job_arrival" and row[3][0] == jr.job_id:
            admit_t = row[0]
    blocks = set(jr.blocks)
    node_spans = spans.get(jr.node, ())
    mine = [s for s in node_spans
            if s.cat in ("block", "crashed", "unfinished")
            and s.get("index") in blocks]
    if mine:
        # decompose the on-node window [first launch, end]; everything
        # before the first launch (admission + queued-behind-others) folds
        # into the queueing residual below
        t_first = min(s.start for s in mine)
        comp = _node_components(
            [s for s in node_spans if s.end > t_first or s.start >= t_first],
            _fault_timeline(runtime.event_log, jr.node), end, t0=t_first)
    else:
        comp = {k: 0.0 for k in _MISS_KEYS}
    fixed = [comp[k] for k in _MISS_KEYS if k != "queueing_s"]
    comp["queueing_s"] = _exact_residual(wall, fixed)
    comp["admission_s"] = admit_t - jr.time
    out.update({"wall_s": wall, "deadline_s": jr.deadline_s}, **comp)
    return out


def explain_energy(report, node: str | None = None, *, specs=None) -> dict:
    """Ledger-channel energy split.  Cluster-wide (default): the report's
    busy / idle / switch / wire / failed channels, whose sum *is* the
    observed total — ``math.fsum`` of the returned channels ``==``
    ``total_j`` bitwise.  With ``node=`` and the run's ``specs`` (for
    ``p_idle``), the per-node split uses the engine's own idle formula, so
    per-node idles sum (builtin ``sum`` in node order) to
    ``report.idle_energy_j``.
    """
    runtime = getattr(report, "runtime", report)
    require_full_log(runtime)
    if node is None:
        ch = {"busy_j": runtime.total_energy_j,
              "idle_j": runtime.idle_energy_j,
              "switch_j": runtime.switch_energy_j,
              "wire_j": runtime.migration_energy_j,
              "failed_j": runtime.failed_energy_j}
        return {"total_j": math.fsum(ch.values()), **ch}
    nr = next((n for n in runtime.node_reports if n.name == node), None)
    if nr is None:
        raise KeyError(f"unknown node {node!r}")
    idle = 0.0
    if specs is not None:
        spec = next((s for s in specs if s.name == node), None)
        if spec is not None:
            idle = max(runtime.deadline_s - nr.busy_s, 0.0) \
                * spec.power.p_idle
    ch = {"busy_j": nr.energy_j, "idle_j": idle,
          "switch_j": nr.switch_energy_j, "wire_j": nr.migrate_energy_j,
          "failed_j": nr.failed_energy_j}
    return {"node": node, "total_j": math.fsum(ch.values()), **ch}
