"""Lifecycle spans: per-block and per-job span trees off the event log.

``build_spans`` replays a ``RuntimeReport.event_log`` (the full-mode log —
ring/off modes cannot reconstruct history) into a per-node forest of
``Span`` trees:

* a **block** span per executed block (``block_start`` → ``block_finish``),
  with one **freq** child per constant-frequency segment (mid-block
  ``freq_switch`` rows split the block) and instant **telemetry** children;
  a block killed mid-flight by a crash closes as category ``crashed``;
* an **outage** span per repaired crash (``node_down`` → ``node_up``;
  un-repaired outages stay open to the end of the log);
* a **wire** span per migration transfer batch (moves logged at one
  instant share one wire; the matching ``wire_release`` closes it — FIFO
  per source node, mirroring the engine's one-release-per-batch schedule);
* instant spans (zero duration) for defers, faults, idle switches,
  migrate in/out marks, and park/wake provisioning flips.

``build_job_spans`` does the serving layer: one **job** span per job
(arrival → terminal), with instant **decision** children per admission
attempt (admit / defer / reject), a **queue** child (admission → first
block launch) and a **service** child (first launch → finish) when the
job's block spans are available.

Reconstruction is a deterministic fold over the log, so the scalar and
vector engines — whose logs are bitwise-identical — produce identical
forests (pinned by ``tests/test_obs.py``).

Copied from ``src/repro/obs/spans.py`` with its imports pointed at
``repro_torch``. It is NumPy, as the original is, so its results are bit-
identical to the reference's.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Span", "build_spans", "build_job_spans", "flatten",
           "require_full_log"]


def require_full_log(report) -> None:
    """Raise unless ``report`` carries a replayable (full-mode) event log.

    Reports produced with ``RuntimeConfig(event_log="ring:N" | "off")`` (or
    ``log_events=False``) truncate history; computing spans or attribution
    from them would silently blame the surviving tail.  ``ServingReport``
    wrappers are unwrapped; objects without an ``event_log_mode`` field
    (raw log tuples, sinks) pass through and fall back to the older
    ``dropped`` check in ``build_spans``.
    """
    runtime = getattr(report, "runtime", report)
    mode = getattr(runtime, "event_log_mode", "full")
    if mode != "full":
        dropped = getattr(runtime, "events_dropped", 0)
        raise ValueError(
            f"report's event log is not replayable: event_log={mode!r} "
            f"(events_dropped={dropped}) — re-run with "
            "RuntimeConfig(log_events=True, event_log='full')")


@dataclasses.dataclass(frozen=True)
class Span:
    """One lifecycle interval.  ``start == end`` marks an instant event.

    ``meta`` is a sorted tuple of ``(key, value)`` pairs (hashable, so
    whole forests compare with ``==`` for the identity tests); ``children``
    nest strictly inside ``[start, end]``.
    """

    name: str
    cat: str           # block | freq | telemetry | outage | wire | job | ...
    node: str
    start: float
    end: float
    meta: tuple = ()
    children: tuple = ()

    @property
    def dur(self) -> float:
        return self.end - self.start

    def get(self, key, default=None):
        for k, v in self.meta:
            if k == key:
                return v
        return default


def _span(name, cat, node, start, end, meta=(), children=()):
    return Span(name, cat, node, start, end,
                tuple(sorted(meta)), tuple(children))


class _OpenBlock:
    __slots__ = ("index", "start", "seg_t", "seg_f", "segs", "notes")

    def __init__(self, index, start, f_run):
        self.index = index
        self.start = start
        self.seg_t = start
        self.seg_f = f_run
        self.segs: list = []
        self.notes: list = []

    def cut(self, now, new_f) -> None:
        self.segs.append(_span(f"f={self.seg_f:g}", "freq", "", self.seg_t,
                               now, (("freq", self.seg_f),)))
        self.seg_t = now
        self.seg_f = new_f

    def close(self, node, now, cat, meta) -> Span:
        self.cut(now, self.seg_f)
        segs = [dataclasses.replace(s, node=node) for s in self.segs]
        kids = tuple(sorted(segs + self.notes, key=lambda s: (s.start, s.cat)))
        return _span(f"block:{self.index}", cat, node, self.start, now,
                     tuple(meta) + (("index", self.index),), kids)


def build_spans(event_log) -> dict:
    """``{node_name: (root spans, start-sorted)}`` from a full event log.

    Accepts a raw event log (tuple of rows or ``EventLogSink``) or a whole
    ``RuntimeReport`` / ``ServingReport``.  Raises ``ValueError`` on any
    ring-truncated or disabled log (``require_full_log``) — span
    reconstruction needs history.
    """
    if hasattr(event_log, "event_log") or hasattr(event_log, "runtime"):
        require_full_log(event_log)
        event_log = getattr(event_log, "runtime", event_log).event_log
    dropped = getattr(event_log, "dropped", 0)
    if dropped:
        raise ValueError(f"event log dropped {dropped} rows (ring mode) — "
                         "span reconstruction needs event_log='full'")
    out: dict = {}
    open_block: dict = {}     # node -> _OpenBlock
    open_outage: dict = {}    # node -> (t_down, flavor)
    open_wires: dict = {}     # node -> [[t_open, n_blocks], ...] batches
    end_t = 0.0

    def emit(node, span):
        out.setdefault(node, []).append(span)

    def open_wire(node, t):
        # moves logged at one instant form one transfer batch — the engine
        # schedules a single WIRE_RELEASE per batch
        pend = open_wires.setdefault(node, [])
        if pend and pend[-1][0] == t:
            pend[-1][1] += 1
        else:
            pend.append([t, 1])

    for row in event_log:
        t, kind, node = row[0], row[1], row[2]
        data = row[3:]
        end_t = max(end_t, t)
        if kind == "block_start":
            if data[0] == "deferred":
                emit(node, _span(f"defer:{data[1]}", "defer", node, t, t,
                                 (("index", data[1]),)))
            else:
                open_block[node] = _OpenBlock(data[0], t, data[1])
        elif kind == "block_finish":
            ob = open_block.pop(node, None)
            if ob is not None:
                emit(node, ob.close(node, t, "block",
                                    (("busy_s", data[1]),
                                     ("energy_j", data[2]))))
        elif kind == "telemetry":
            if data[0] == "migrate":
                emit(node, _span(f"migrate:{data[1]}", "migrate_out", node,
                                 t, t, (("index", data[1]),
                                        ("dst", data[2]))))
                emit(data[2], _span(f"migrate:{data[1]}", "migrate_in",
                                    data[2], t, t, (("index", data[1]),
                                                    ("src", node))))
                open_wire(node, t)
            else:
                note = _span(f"telemetry:{data[0]}", "telemetry", node, t, t,
                             (("index", data[0]), ("observed_s", data[1]),
                              ("replanned", data[2])))
                ob = open_block.get(node)
                if ob is not None and ob.index == data[0]:
                    ob.notes.append(note)
                else:
                    emit(node, note)
        elif kind == "freq_switch":
            if len(data) == 3:
                ob = open_block.get(node)
                if ob is not None and ob.index == data[0]:
                    ob.cut(t, data[2])
                else:
                    emit(node, _span(f"switch:{data[0]}", "switch", node,
                                     t, t, (("index", data[0]),
                                            ("old_f", data[1]),
                                            ("new_f", data[2]))))
            else:  # (target, "idle") — applied between blocks
                emit(node, _span(f"switch:{data[0]:g}", "switch", node, t, t,
                                 (("new_f", data[0]), ("idle", True))))
        elif kind == "fault":
            emit(node, _span(f"fault:{data[0]:g}", "fault", node, t, t,
                             (("factor", data[0]),)))
        elif kind == "wire_release":
            pend = open_wires.get(node)
            if pend:
                t0, nb = pend.pop(0)
                meta = [("n_blocks", nb), ("wire_w", data[0])]
                if len(data) > 1:
                    meta.append(("stale", True))
                emit(node, _span("wire", "wire", node, t0, t, tuple(meta)))
        elif kind == "node_down":
            if data[0] == "migrate":
                emit(node, _span(f"migrate:{data[1]}", "migrate_out", node,
                                 t, t, (("index", data[1]),
                                        ("dst", data[2]), ("crash", True))))
                emit(data[2], _span(f"migrate:{data[1]}", "migrate_in",
                                    data[2], t, t, (("index", data[1]),
                                                    ("src", node))))
                open_wire(node, t)
            elif len(data) > 1 and data[1] == "already-down":
                pass
            else:
                ob = open_block.pop(node, None)
                if ob is not None:
                    emit(node, ob.close(node, t, "crashed",
                                        (("busy_s", data[2]),
                                         ("energy_j", data[3]),
                                         ("salvaged", data[4]))))
                open_outage[node] = (t, data[0])
        elif kind == "node_up":
            if data[0] != "already-up":
                od = open_outage.pop(node, None)
                t0 = od[0] if od is not None else t - data[0]
                flavor = od[1] if od is not None else "?"
                emit(node, _span("outage", "outage", node, t0, t,
                                 (("flavor", flavor), ("down_s", data[0]))))

    for node, ob in open_block.items():
        emit(node, ob.close(node, end_t, "unfinished", ()))
    for node, (t0, flavor) in open_outage.items():
        emit(node, _span("outage", "outage", node, t0, end_t,
                         (("flavor", flavor), ("unrepaired", True))))
    return {node: tuple(sorted(spans, key=lambda s: (s.start, s.end, s.name)))
            for node, spans in sorted(out.items())}


def build_job_spans(sreport, node_spans: dict | None = None) -> tuple:
    """One ``Span`` per job off a ``ServingReport`` (job_id order).

    Decision instants come from the ``job_arrival`` log rows; with
    ``node_spans`` (a ``build_spans`` result) each accepted job also gets
    **queue** and **service** children split at its first block launch.
    """
    decisions: dict = {}
    sheds: dict = {}
    for row in sreport.event_log:
        if row[1] == "job_arrival":
            jid, tenant, decision, attempt = row[3]
            decisions.setdefault(jid, []).append(
                _span(decision, "decision", row[2], row[0], row[0],
                      (("attempt", attempt), ("tenant", tenant))))
        elif row[1] == "job_shed":
            sheds[row[3][0]] = row[0]

    block_start: dict = {}
    if node_spans:
        for spans in node_spans.values():
            for s in spans:
                if s.cat in ("block", "crashed", "unfinished"):
                    idx = s.get("index")
                    if idx not in block_start or s.start < block_start[idx]:
                        block_start[idx] = s.start

    end_t = float(sreport.runtime.makespan_s)
    jobs = []
    for jr in sreport.jobs:
        kids = list(decisions.get(jr.job_id, ()))
        if jr.status == "shed" and jr.job_id in sheds:
            end = sheds[jr.job_id]
        elif jr.t_finish >= 0.0:
            end = jr.t_finish
        elif jr.status == "rejected":
            end = kids[-1].end if kids else jr.time
        else:
            end = end_t
        if jr.status in ("accepted", "shed") and kids:
            admit_t = kids[-1].end
            starts = [block_start[b] for b in jr.blocks if b in block_start]
            if starts and min(starts) <= end:
                t0 = min(starts)
                kids.append(_span("queue", "queue", jr.node, admit_t,
                                  max(t0, admit_t)))
                kids.append(_span("service", "service", jr.node,
                                  max(t0, admit_t), end))
            else:
                kids.append(_span("queue", "queue", jr.node, admit_t, end))
        jobs.append(_span(
            f"job:{jr.job_id}", "job", jr.node or "-", jr.time, end,
            (("job_id", jr.job_id), ("tenant", jr.tenant),
             ("status", jr.status), ("slo_met", jr.slo_met),
             ("deadline_s", jr.deadline_s)),
            tuple(sorted(kids, key=lambda s: (s.start, s.end, s.name)))))
    return tuple(jobs)


def flatten(spans) -> list:
    """Depth-first list of every span in a forest (dict, tuple, or Span)."""
    out: list = []
    if isinstance(spans, dict):
        for v in spans.values():
            out.extend(flatten(v))
        return out
    if isinstance(spans, Span):
        spans = (spans,)
    for s in spans:
        out.append(s)
        out.extend(flatten(s.children))
    return out
