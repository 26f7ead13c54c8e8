"""Event layer of the cluster runtime: typed events + a totally ordered queue.

The block-boundary simulator could only act when a block finished; the
runtime advances a single discrete-event clock instead, so frequency
switches, faults, telemetry, and block boundaries interleave freely.  For
the whole engine to be reproducible the *pop order* must be a pure function
of the event set — two events are never "simultaneous and unordered".
Every event is keyed by

    (time, kind priority, node id, seq)

``seq`` is a per-queue monotonically increasing push counter, so even two
identical events on the same node at the same instant pop in the order they
were scheduled.  Kind priorities encode the physical settling order at one
timestamp:

    BLOCK_FINISH   a finishing block releases its power draw and frees the
                   node *before* anything else at this instant reacts;
    FREQ_SWITCH    pending actuations land on the settled power state;
    FAULT          slowdown factors change before new work is priced;
    TELEMETRY      the controller observes a fully settled node, so its
                   re-plan (and any migration) sees post-fault truth;
    WIRE_RELEASE   a completed migration transfer returns its wire draw to
                   the power ledger before new work is admitted;
    NODE_DOWN      a crash lands after every same-instant completion has
                   settled and been observed — a block that finishes at the
                   crash timestamp counts, the recovery re-plan sees a
                   correct queue;
    NODE_UP        a repair revives the node before new work is admitted;
    JOB_ARRIVAL    an open-loop job arrival is admitted (or deferred, shed,
                   rejected) against the fully settled cluster state — every
                   same-instant completion, fault, crash, and repair has
                   already landed, so the feasibility test prices true
                   backlog;
    BLOCK_START    new work starts last, seeing every decision above.

Copied from ``src/repro/runtime/events.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq

__all__ = [
    "BLOCK_FINISH", "FREQ_SWITCH", "FAULT", "TELEMETRY", "WIRE_RELEASE",
    "NODE_DOWN", "NODE_UP", "JOB_ARRIVAL", "BLOCK_START", "KIND_NAMES",
    "Event", "FaultEvent", "EventQueue", "EventLogSink",
]

# kind priorities — the tie-break order at one timestamp (see module doc)
BLOCK_FINISH = 0
FREQ_SWITCH = 1
FAULT = 2
TELEMETRY = 3
WIRE_RELEASE = 4
NODE_DOWN = 5
NODE_UP = 6
JOB_ARRIVAL = 7
BLOCK_START = 8

KIND_NAMES = {
    BLOCK_FINISH: "block_finish",
    FREQ_SWITCH: "freq_switch",
    FAULT: "fault",
    TELEMETRY: "telemetry",
    WIRE_RELEASE: "wire_release",
    NODE_DOWN: "node_down",
    NODE_UP: "node_up",
    JOB_ARRIVAL: "job_arrival",
    BLOCK_START: "block_start",
}


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence.  ``data`` is kind-specific:

    BLOCK_FINISH  (block_index, generation) — generation guards stale
                  finishes after a mid-block re-split (switch or fault);
    FREQ_SWITCH   (target_rel_freq,) — requested earlier, lands now;
    FAULT         (factor,) — the node's truth times multiply by ``factor``
                  from this instant (in-flight remainder included);
    TELEMETRY     (block_index, observed_s, samples) — a finished block's
                  wall time plus its counter-trace segments (empty tuple
                  unless trace emission is on);
    WIRE_RELEASE  (watts,) — a migration transfer on this (source) node
                  completed; drop its wire draw from the power ledger;
    NODE_DOWN     (flavor, repair_at) — the node crashes: its in-flight work
                  is lost (to the last checkpoint, if salvage is on), its
                  queue freezes, its draw falls to idle.  ``repair_at`` is
                  the matching NODE_UP time (None for a permanent crash);
    NODE_UP       () — the node is repaired and may accept work again;
    JOB_ARRIVAL   (job_id, attempt) — an open-loop job arrives (attempt > 0
                  marks a deferred retry); the serving fabric decides
                  accept / defer / reject.  ``node`` is 0 (cluster-scoped);
    BLOCK_START   () — the node should (try to) start its next queued block.
    """

    time: float
    kind: int
    node: int           # node id (position in the plan's node order)
    data: tuple = ()


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """Time-based fault for the runtime: from ``time`` on, ``node``'s true
    processing times multiply by ``factor`` — mid-block included (the
    in-flight block's *remaining work* is re-priced at the fault instant).

    The block-boundary ``SlowdownEvent`` (count-based trigger) remains the
    compatibility form; ``simulate_cluster`` translates it for the engine.
    """

    time: float
    node: str
    factor: float


class EventLogSink:
    """Flight-recorder event log: a bounded ring that keeps the LAST ``n``
    rows pushed (``RuntimeConfig(event_log="ring:N")``).

    List-compatible where the engine writes (``append`` / ``extend``) and
    reads (iteration, ``len``, ``tuple(...)``), plus a ``pushed`` counter so
    ``dropped`` reports how many rows the ring evicted.  A full-fidelity log
    stays a plain list (the hot path pays no indirection); ``"off"`` never
    builds rows at all — this class only ever backs the ring mode.

    The vectorized engine may skip *materializing* rows it can prove would
    be immediately evicted (a commit batch longer than the ring); it
    accounts for them through ``skip`` so ``pushed``/``dropped`` match the
    scalar engine's exactly.
    """

    __slots__ = ("capacity", "pushed", "_ring")

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("ring capacity must be a positive integer")
        self.capacity = capacity
        self.pushed = 0
        self._ring: collections.deque = collections.deque(maxlen=capacity)

    def append(self, row) -> None:
        self.pushed += 1
        self._ring.append(row)

    def extend(self, rows) -> None:
        if not isinstance(rows, (list, tuple)):
            rows = list(rows)
        self.pushed += len(rows)
        self._ring.extend(rows)

    def skip(self, n: int) -> None:
        """Account ``n`` rows that were pushed-and-evicted without ever
        being materialized (vector-engine fast path)."""
        self.pushed += n

    @property
    def dropped(self) -> int:
        return self.pushed - len(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def __iter__(self):
        return iter(self._ring)


class EventQueue:
    """Min-heap over ``(time, kind, node, seq)`` — a total order, so pop
    order is deterministic for any push order of distinct events, and
    scheduling order breaks the (rare) exact ties between identical keys."""

    def __init__(self):
        self._heap: list = []
        self._seq = 0

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, (ev.time, ev.kind, ev.node, self._seq, ev))
        self._seq += 1

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[4]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
