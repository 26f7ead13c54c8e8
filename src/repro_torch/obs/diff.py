"""Run-diff attribution: what got slower (or hungrier) between two runs.

``diff_runs(report_a, report_b)`` aligns two runs' span trees — blocks by
block index, jobs by job id, nodes and tenants by name — and rolls the
structured per-block deltas up into per-node / per-tenant / per-mechanism
regression tables, so any two bench or CI artifacts can answer "what
changed and why" without re-running anything.

Alignment handles work that exists on only one side: a block executed in
``a`` but not in ``b`` (shed, or lost to a crash) lands in ``dropped``,
the reverse in ``added``, and a block that ran on different nodes in
``moved`` — the add/drop/move sets are how shedding and migration show up
structurally before they show up in joules.

Every table keeps only rows with a non-zero delta, so
``diff_runs(r, r).empty`` is True for any report — the identity diff is
empty by construction, which doubles as the determinism cross-check.
Totals reuse ``delta_ledger``: the five-channel energy delta plus its
rational-space residual sums bitwise to the difference of the two
reports' own totals.

Per-block alignment needs both runs' full event logs
(``event_log="full"``); with ring/off logs the span-level tables are
skipped and the report-level rollups still diff.

Copied from ``src/repro/obs/diff.py`` with its imports pointed at
``repro_torch``. It is NumPy, as the original is, so its results are bit-
identical to the reference's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.counterfactual import delta_ledger
from repro_torch.obs.spans import build_spans

__all__ = ["RunDiff", "diff_runs"]

_BLOCK_CATS = ("block", "crashed", "unfinished")


@dataclasses.dataclass(frozen=True)
class RunDiff:
    """Structured delta of run ``b`` minus run ``a``.  All tables keep
    only rows that actually changed; ``empty`` is True iff nothing did."""

    totals: dict          # delta_ledger + d_makespan_s (always present)
    blocks: tuple = ()    # per-block delta dicts, index-aligned
    added: tuple = ()     # block indices executed only in b
    dropped: tuple = ()   # block indices executed only in a
    moved: tuple = ()     # (index, node_a, node_b)
    nodes: tuple = ()     # per-node rollup delta dicts
    tenants: tuple = ()   # per-tenant delta dicts (serving runs)
    jobs: tuple = ()      # per-job delta dicts (serving runs)
    jobs_added: tuple = ()
    jobs_dropped: tuple = ()
    mechanisms: tuple = ()  # per-mechanism counter rollup
    spans_aligned: bool = True  # False when a log was ring/off-truncated

    @property
    def empty(self) -> bool:
        return not (self.blocks or self.added or self.dropped or self.moved
                    or self.nodes or self.tenants or self.jobs
                    or self.jobs_added or self.jobs_dropped
                    or self.mechanisms
                    or any(v for k, v in self.totals.items()
                           if k.startswith(("d_", "residual"))))


def _block_table(report) -> dict | None:
    """{index: {node, start, end, busy_s, cat}} off a full event log, or
    None when the log cannot be replayed (ring/off, or logging off)."""
    rt = getattr(report, "runtime", report)
    if getattr(rt, "event_log_mode", "full") != "full" or not rt.event_log:
        return None
    out: dict = {}
    for node, spans in build_spans(rt.event_log).items():
        for s in spans:
            if s.cat not in _BLOCK_CATS:
                continue
            idx = s.get("index")
            row = out.get(idx)
            if row is None:
                out[idx] = {"node": node, "start": s.start, "end": s.end,
                            "busy_s": s.dur, "cat": s.cat}
            else:
                # crash + retry: busy accumulates, the latest span wins
                # the outcome fields
                row["busy_s"] += s.dur
                if s.end >= row["end"]:
                    row.update(node=node, start=s.start, end=s.end,
                               cat=s.cat)
    return out


def _diff_blocks(ta: dict, tb: dict):
    blocks, moved = [], []
    added = tuple(sorted(set(tb) - set(ta)))
    dropped = tuple(sorted(set(ta) - set(tb)))
    for idx in sorted(set(ta) & set(tb)):
        a, b = ta[idx], tb[idx]
        row = {"index": idx,
               "d_busy_s": b["busy_s"] - a["busy_s"],
               "d_start_s": b["start"] - a["start"],
               "d_end_s": b["end"] - a["end"],
               "node_a": a["node"], "node_b": b["node"],
               "cat_a": a["cat"], "cat_b": b["cat"]}
        if a["node"] != b["node"]:
            moved.append((idx, a["node"], b["node"]))
        if (row["d_busy_s"] or row["d_start_s"] or row["d_end_s"]
                or a["node"] != b["node"] or a["cat"] != b["cat"]):
            blocks.append(row)
    return tuple(blocks), added, dropped, tuple(moved)


def _diff_nodes(ra, rb) -> tuple:
    na = {nr.name: nr for nr in ra.node_reports}
    nb = {nr.name: nr for nr in rb.node_reports}
    rows = []
    for name in sorted(set(na) | set(nb)):
        a, b = na.get(name), nb.get(name)

        def g(nr, field, default=0.0):
            return getattr(nr, field) if nr is not None else default

        row = {"node": name,
               "d_blocks": g(b, "n_blocks", 0) - g(a, "n_blocks", 0),
               "d_busy_s": g(b, "busy_s") - g(a, "busy_s"),
               "d_finish_s": g(b, "finish_s") - g(a, "finish_s"),
               "d_energy_j": g(b, "energy_j") - g(a, "energy_j"),
               "d_in": g(b, "migrated_in", 0) - g(a, "migrated_in", 0),
               "d_out": g(b, "migrated_out", 0) - g(a, "migrated_out", 0),
               "d_switches": g(b, "n_switches", 0) - g(a, "n_switches", 0),
               "d_crashes": g(b, "crashes", 0) - g(a, "crashes", 0)}
        if any(v for k, v in row.items() if k != "node"):
            rows.append(row)
    return tuple(rows)


def _diff_tenants(a, b) -> tuple:
    if not (hasattr(a, "tenants") and hasattr(b, "tenants")):
        return ()
    ta = {ts.tenant: ts for ts in a.tenants}
    tb = {ts.tenant: ts for ts in b.tenants}
    rows = []
    for name in sorted(set(ta) | set(tb)):
        x, y = ta.get(name), tb.get(name)

        def g(ts, field):
            return getattr(ts, field) if ts is not None else 0

        row = {"tenant": name}
        for f in ("arrived", "accepted", "rejected", "shed", "finished",
                  "slo_miss"):
            row["d_" + f] = g(y, f) - g(x, f)
        row["d_miss_rate"] = g(y, "miss_rate") - g(x, "miss_rate")
        if any(v for k, v in row.items() if k != "tenant"):
            rows.append(row)
    return tuple(rows)


def _diff_jobs(a, b):
    if not (hasattr(a, "jobs") and hasattr(b, "jobs")):
        return (), (), ()
    ja = {j.job_id: j for j in a.jobs}
    jb = {j.job_id: j for j in b.jobs}
    added = tuple(sorted(set(jb) - set(ja)))
    dropped = tuple(sorted(set(ja) - set(jb)))
    rows = []
    for jid in sorted(set(ja) & set(jb)):
        x, y = ja[jid], jb[jid]
        row = {"job_id": jid, "tenant": x.tenant,
               "status_a": x.status, "status_b": y.status,
               "node_a": x.node, "node_b": y.node,
               "d_finish_s": y.t_finish - x.t_finish,
               "d_slo_met": int(y.slo_met) - int(x.slo_met)}
        if (x.status != y.status or x.node != y.node
                or row["d_finish_s"] or row["d_slo_met"]):
            rows.append(row)
    return tuple(rows), added, dropped


def _diff_mechanisms(a, b) -> tuple:
    """Per-mechanism counter rollup off the report scalars — which
    machinery ran harder in ``b`` (positive) or eased off (negative)."""
    ra = getattr(a, "runtime", a)
    rb = getattr(b, "runtime", b)
    rows = [
        ("dvfs", {"d_switches": rb.n_switches - ra.n_switches,
                  "d_switch_j": rb.switch_energy_j - ra.switch_energy_j,
                  "d_replans": rb.n_replans - ra.n_replans}),
        ("migration", {"d_moves": rb.n_migrations - ra.n_migrations,
                       "d_wire_j": (rb.migration_energy_j
                                    - ra.migration_energy_j)}),
        ("recovery", {"d_crashes": rb.n_crashes - ra.n_crashes,
                      "d_repairs": rb.n_repairs - ra.n_repairs,
                      "d_failed_j": rb.failed_energy_j - ra.failed_energy_j,
                      "d_missed_blocks": (len(rb.missed_blocks)
                                          - len(ra.missed_blocks))}),
        ("power_cap", {"d_peak_w": rb.peak_power_w - ra.peak_power_w}),
    ]
    if hasattr(a, "n_shed") and hasattr(b, "n_shed"):
        rows.append(("admission",
                     {"d_accepted": b.n_accepted - a.n_accepted,
                      "d_rejected": b.n_rejected - a.n_rejected,
                      "d_shed": b.n_shed - a.n_shed,
                      "d_deferred": b.n_deferred - a.n_deferred}))
    return tuple({"mechanism": name, **vals} for name, vals in rows
                 if any(vals.values()))


def diff_runs(report_a, report_b) -> RunDiff:
    """Align two runs and return the structured delta ``b - a``.

    Either argument may be a ``RuntimeReport`` or a ``ServingReport`` —
    job and tenant tables appear when both are serving reports.  All
    tables keep changed rows only; ``diff_runs(r, r).empty`` is True.
    """
    ra = getattr(report_a, "runtime", report_a)
    rb = getattr(report_b, "runtime", report_b)
    totals = delta_ledger(report_a, report_b)
    totals["d_makespan_s"] = rb.makespan_s - ra.makespan_s

    ta, tb = _block_table(report_a), _block_table(report_b)
    aligned = ta is not None and tb is not None
    if aligned:
        blocks, added, dropped, moved = _diff_blocks(ta, tb)
    else:
        blocks, added, dropped, moved = (), (), (), ()

    jobs, jobs_added, jobs_dropped = _diff_jobs(report_a, report_b)
    return RunDiff(
        totals=totals, blocks=blocks, added=added, dropped=dropped,
        moved=moved, nodes=_diff_nodes(ra, rb),
        tenants=_diff_tenants(report_a, report_b),
        jobs=jobs, jobs_added=jobs_added, jobs_dropped=jobs_dropped,
        mechanisms=_diff_mechanisms(report_a, report_b),
        spans_aligned=aligned)
