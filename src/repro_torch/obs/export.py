"""Trace exporters: Chrome-trace / Perfetto JSON, Prometheus text, JSONL.

``to_chrome_trace`` renders a run as a Chrome Trace Event document (the
JSON array format — load it at ``chrome://tracing`` or
https://ui.perfetto.dev): one process track per node carrying the block /
outage / wire spans as complete (``"X"``) events with freq-segment and
telemetry children nested inside, a frequency counter (``"C"``) track per
node, a cluster power-draw counter track fed by the ledger's recorded
step samples, and — when a ``ServingReport`` is given — a jobs track with
one span per job.  Timestamps are microseconds, as the format requires.

``validate_chrome_trace`` is a hand-rolled structural checker (no schema
dependency): it returns a list of problem strings, empty when the
document is well-formed — CI's obs-smoke job asserts on it.

``to_prometheus`` renders a ``StreamingMetrics`` snapshot (or a bare
``RuntimeReport``) in the Prometheus text exposition format —
``validate_prometheus`` is its structural checker (HELP/TYPE pairing,
name/label syntax, escape and float formatting, series uniqueness), the
text-format twin of ``validate_chrome_trace`` — and ``to_jsonl`` streams
the raw event log one JSON object per line.

Copied from ``src/repro/obs/export.py`` with its imports pointed at
``repro_torch``. It is NumPy, as the original is, so its results are bit-
identical to the reference's.
"""
from __future__ import annotations

import json
import math
import re

from repro_torch.obs.spans import Span, build_job_spans, build_spans

__all__ = ["to_chrome_trace", "write_chrome_trace", "validate_chrome_trace",
           "to_prometheus", "validate_prometheus", "to_jsonl", "write_jsonl"]

_US = 1e6


def _span_events(span: Span, pid: int, tid: int) -> list:
    ev = [{"name": span.name, "cat": span.cat, "ph": "X",
           "ts": span.start * _US, "dur": span.dur * _US,
           "pid": pid, "tid": tid, "args": dict(span.meta)}]
    for child in span.children:
        ev.extend(_span_events(child, pid, tid))
    return ev


def to_chrome_trace(report=None, *, spans=None, job_spans=None,
                    power_samples=None, metrics=None) -> dict:
    """Chrome Trace Event document for a run.

    ``report`` may be a ``RuntimeReport`` or a ``ServingReport``; spans are
    reconstructed from its event log unless pre-built forests are passed
    in.  ``metrics`` (a fed ``StreamingMetrics``) substitutes its binned
    power timeline when the ledger didn't record step samples (ring/off
    event-log modes).
    """
    runtime = getattr(report, "runtime", report)
    if spans is None:
        if runtime is None:
            raise ValueError("need a report or a prebuilt span forest")
        spans = build_spans(runtime.event_log)
    if job_spans is None and report is not None and hasattr(report, "jobs"):
        job_spans = build_job_spans(report, spans)
    if power_samples is None and runtime is not None:
        power_samples = runtime.power_samples

    names = sorted(spans)
    pid_of = {nm: i + 1 for i, nm in enumerate(names)}
    events: list = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                     "args": {"name": "cluster"}}]
    for nm in names:
        events.append({"name": "process_name", "ph": "M", "pid": pid_of[nm],
                       "tid": 0, "args": {"name": f"node:{nm}"}})

    for nm in names:
        pid = pid_of[nm]
        for s in spans[nm]:
            events.extend(_span_events(s, pid, 0))
            # frequency counter: one sample per constant-frequency segment
            for c in s.children:
                if c.cat == "freq":
                    events.append({"name": "freq", "ph": "C", "pid": pid,
                                   "tid": 0, "ts": c.start * _US,
                                   "args": {"freq": c.get("freq")}})
            if s.cat == "switch" and s.get("idle"):
                events.append({"name": "freq", "ph": "C", "pid": pid,
                               "tid": 0, "ts": s.start * _US,
                               "args": {"freq": s.get("new_f")}})

    if power_samples:
        for t, w in power_samples:
            events.append({"name": "power_w", "ph": "C", "pid": 0, "tid": 0,
                           "ts": t * _US, "args": {"total_w": w}})
    elif metrics is not None:
        edges, watts = metrics.power_timeline()
        for j in range(metrics.bins):
            events.append({"name": "power_w", "ph": "C", "pid": 0, "tid": 0,
                           "ts": float(edges[j]) * _US,
                           "args": {"total_w": float(watts[j])}})

    if job_spans:
        jp = len(names) + 1
        events.append({"name": "process_name", "ph": "M", "pid": jp,
                       "tid": 0, "args": {"name": "jobs"}})
        for i, s in enumerate(job_spans):
            events.extend(_span_events(s, jp, i))

    events.sort(key=lambda e: (e.get("ts", -1.0), e["pid"], e["ph"]))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, report=None, **kw) -> dict:
    doc = to_chrome_trace(report, **kw)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc


_PHASES = frozenset("XBEICMb e n s t f P")


def validate_chrome_trace(doc) -> list:
    """Structural check of a Chrome Trace Event document.  Returns a list
    of problem strings — empty means well-formed."""
    bad: list = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not an object with a traceEvents array"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not an array"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            bad.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in _PHASES:
            bad.append(f"{where}: bad phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            bad.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int):
            bad.append(f"{where}: missing integer pid")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                bad.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < -1e-9:
                bad.append(f"{where}: X event with bad dur {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if (not isinstance(args, dict) or not args
                    or not all(isinstance(v, (int, float))
                               for v in args.values())):
                bad.append(f"{where}: counter args must be numeric")
    return bad


def _prom_label(s) -> str:
    return str(s).replace("\\", "\\\\").replace('"', '\\"')


def to_prometheus(source, *, prefix: str = "repro") -> str:
    """Prometheus text exposition for a ``StreamingMetrics`` (preferred —
    live gauges included) or a sealed ``RuntimeReport``."""
    lines: list = []

    def head(name, kind, help_):
        lines.append(f"# HELP {prefix}_{name} {help_}")
        lines.append(f"# TYPE {prefix}_{name} {kind}")

    def sample(name, value, **labels):
        lab = ",".join(f'{k}="{_prom_label(v)}"'
                       for k, v in sorted(labels.items()))
        lines.append(f"{prefix}_{name}{{{lab}}} {value!r}"
                     if lab else f"{prefix}_{name} {value!r}")

    if hasattr(source, "snapshot"):          # StreamingMetrics
        snap = source.snapshot()
        head("events_total", "counter", "Lifecycle events by kind.")
        for k, v in sorted(snap["counters"].items()):
            sample("events_total", v, kind=k)
        head("node_busy_seconds", "counter", "Busy seconds per node.")
        head("node_energy_joules", "counter", "Busy joules per node.")
        head("node_queue_depth", "gauge", "Backlog blocks per node.")
        head("node_freq", "gauge", "Last applied relative frequency.")
        for nm, g in snap["nodes"].items():
            sample("node_busy_seconds", g["busy_s"], node=nm)
            sample("node_energy_joules", g["energy_j"], node=nm)
            sample("node_queue_depth", g["queue_depth"], node=nm)
            sample("node_freq", g["freq"], node=nm)
        head("energy_joules", "counter", "Cluster energy by channel.")
        for ch, v in sorted(snap["energy"].items()):
            sample("energy_joules", v, channel=ch[:-2])
        head("peak_power_watts", "gauge", "Highest observed total draw.")
        sample("peak_power_watts", snap["peak_power_w"])
        head("slo_attainment", "gauge", "In-deadline fraction of finishes.")
        sample("slo_attainment", snap["slo_attainment"])
    else:                                    # RuntimeReport
        rep = getattr(source, "runtime", source)
        head("makespan_seconds", "gauge", "Run makespan.")
        sample("makespan_seconds", rep.makespan_s)
        head("energy_joules", "counter", "Cluster energy by channel.")
        for ch, v in (("busy", rep.total_energy_j),
                      ("idle", rep.idle_energy_j),
                      ("switch", rep.switch_energy_j),
                      ("wire", rep.migration_energy_j),
                      ("failed", rep.failed_energy_j)):
            sample("energy_joules", v, channel=ch)
        head("node_busy_seconds", "counter", "Busy seconds per node.")
        head("node_energy_joules", "counter", "Busy joules per node.")
        for nr in rep.node_reports:
            sample("node_busy_seconds", nr.busy_s, node=nr.name)
            sample("node_energy_joules", nr.energy_j, node=nr.name)
        head("events_total", "counter", "Lifecycle events by kind.")
        for k, v in (("migrations", rep.n_migrations),
                     ("crashes", rep.n_crashes),
                     ("repairs", rep.n_repairs),
                     ("switches", rep.n_switches)):
            sample("events_total", v, kind=k)
    return "\n".join(lines) + "\n"


_PROM_NAME = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_PROM_LABEL = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")
_PROM_KINDS = frozenset({"counter", "gauge", "histogram", "summary",
                         "untyped"})
_PROM_SAMPLE = re.compile(
    r"([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*\Z")


def _prom_parse_labels(body: str, where: str, bad: list):
    """Parse the inside of a ``{...}`` label block; appends problems."""
    labels = []
    i, n = 0, len(body)
    while i < n:
        j = body.find('="', i)
        if j < 0:
            bad.append(f"{where}: malformed label block {body!r}")
            return labels
        key = body[i:j]
        if not _PROM_LABEL.match(key):
            bad.append(f"{where}: bad label name {key!r}")
        k = j + 2
        while k < n:
            c = body[k]
            if c == "\\":
                if k + 1 >= n or body[k + 1] not in ('\\', '"', 'n'):
                    bad.append(f"{where}: bad escape in label {key!r}")
                k += 2
                continue
            if c == '"':
                break
            k += 1
        else:
            bad.append(f"{where}: unterminated value for label {key!r}")
            return labels
        labels.append((key, body[j + 2:k]))
        i = k + 1
        if i < n:
            if body[i] != ",":
                bad.append(f"{where}: junk after label {key!r}")
                return labels
            i += 1
    return labels


def validate_prometheus(text) -> list:
    """Structural check of a Prometheus text exposition document.  Returns
    a list of problem strings — empty means well-formed.  Checks HELP/TYPE
    pairing and ordering, metric/label name syntax, label-value escaping,
    float formatting, counter non-negativity, and series uniqueness."""
    bad: list = []
    if not isinstance(text, str):
        return ["document is not a string"]
    if text and not text.endswith("\n"):
        bad.append("missing trailing newline")
    helped: set = set()
    typed: dict = {}
    seen: set = set()
    for i, line in enumerate(text.splitlines()):
        where = f"line {i + 1}"
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue                     # free-form comment: legal
            name = parts[2]
            if not _PROM_NAME.match(name):
                bad.append(f"{where}: bad metric name {name!r}")
                continue
            if parts[1] == "HELP":
                if name in helped:
                    bad.append(f"{where}: duplicate HELP for {name}")
                helped.add(name)
            else:
                kind = parts[3].strip() if len(parts) > 3 else ""
                if kind not in _PROM_KINDS:
                    bad.append(f"{where}: bad TYPE kind {kind!r} for {name}")
                if name not in helped:
                    bad.append(f"{where}: TYPE for {name} without a "
                               "preceding HELP")
                if name in typed:
                    bad.append(f"{where}: duplicate TYPE for {name}")
                typed[name] = kind
            continue
        m = _PROM_SAMPLE.match(line)
        if m is None:
            bad.append(f"{where}: unparsable sample {line!r}")
            continue
        name, lab_body, value = m.groups()
        base = re.sub(r"_(bucket|sum|count)\Z", "", name)
        if name not in typed and base not in typed:
            bad.append(f"{where}: sample for undeclared metric {name}")
        labels = (_prom_parse_labels(lab_body, where, bad)
                  if lab_body is not None else [])
        try:
            v = float(value)
        except ValueError:
            bad.append(f"{where}: unparsable value {value!r}")
            continue
        kind = typed.get(name, typed.get(base))
        if kind == "counter" and not math.isnan(v) and v < 0:
            bad.append(f"{where}: negative counter sample {name} {v!r}")
        series = (name, tuple(sorted(labels)))
        if series in seen:
            bad.append(f"{where}: duplicate series {name}"
                       f"{dict(labels) or ''}")
        seen.add(series)
    return bad


def to_jsonl(event_log):
    """Yield one compact JSON line per event-log row:
    ``{"t": ..., "kind": ..., "node": ..., "data": [...]}``."""
    for row in event_log:
        yield json.dumps({"t": row[0], "kind": row[1], "node": row[2],
                          "data": list(row[3:])}, default=str,
                         separators=(",", ":"))


def write_jsonl(path, event_log) -> int:
    n = 0
    with open(path, "w") as fh:
        for line in to_jsonl(event_log):
            fh.write(line + "\n")
            n += 1
    return n
