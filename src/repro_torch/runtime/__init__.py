"""Event-driven cluster runtime: async DVFS actuation, migration, power cap.

The block-boundary simulator (``repro_torch.cluster.sim``) could only react when a
block finished; a straggler under a tight deadline had no recourse once
clocking up to f_max was not enough, and nothing modeled what a frequency
switch actually costs.  This package replaces that loop with a
discrete-event engine where four capabilities compose:

  * **events** — a totally ordered queue ``(time, kind, node, seq)``
    driving ``BLOCK_START / BLOCK_FINISH / FREQ_SWITCH / TELEMETRY /
    FAULT`` (``repro_torch.runtime.events``); pop order is a pure function of
    the event set, so whole simulations are reproducible.
  * **async actuation** — ``ActuationModel(latency_s, switch_energy_j)``:
    switch requests land ``latency_s`` later, mid-block, with exact
    partial-block accounting (a block split across k frequencies costs the
    segment sums of the planner's own time/energy tables —
    ``repro_torch.runtime.actuator``).
  * **migration** — when the online re-planner predicts a miss even at
    f_max, queued (never in-flight) blocks move to the node with the most
    slack, LPT keys, target-stays-feasible guard
    (``repro_torch.runtime.migrate``).
  * **power cap** — ``power_cap_w`` bounds the instantaneous cluster draw:
    launches clamp down the ladder or defer, clock-ups stagger until a
    finish or down-switch frees headroom; ``plan_cluster(...,
    power_cap_w=...)`` screens the same cap at plan time.
  * **failures + recovery** — ``NodeFailureEvent`` crashes a node
    (transient with an MTTR, or permanent) inside the same total event
    order: in-flight work is lost to record granularity (checkpoint
    salvage optional), open transfer windows abort, and
    ``RecoveryPolicy`` answers with a bounded energy-aware ladder —
    wait-for-repair, evacuate to slack, f_max blast, graceful degradation
    that REPORTS which blocks miss instead of raising
    (``repro_torch.runtime.failures`` / ``repro_torch.runtime.recovery``).  The
    seeded chaos harness (``run_campaign``) audits conservation
    invariants across randomized crash campaigns.

``run_cluster`` consumes ``ClusterPlanArrays`` directly (streamed-pipeline
plans feed straight in); ``repro_torch.cluster.simulate_cluster`` is now a thin
compatibility wrapper over this engine — with no faults, no cap, and zero
actuation latency the engine reproduces the old loop bit-for-bit
(``tests/test_runtime.py``).

Copied from ``src/repro/runtime/__init__.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from repro_torch.runtime.actuator import ActuationModel, PowerLedger
from repro_torch.runtime.engine import (ClusterRuntime, NodeRuntimeReport,
                                  RuntimeConfig, RuntimeReport, run_cluster)
from repro_torch.runtime.events import Event, EventQueue, FaultEvent
from repro_torch.runtime.failures import (CheckpointModel, NodeFailureEvent,
                                    chaos_scenario, check_conservation,
                                    run_campaign)
from repro_torch.runtime.migrate import MigrationModel, MigrationRecord, plan_moves
from repro_torch.runtime.recovery import (RecoveryDecision, RecoveryPolicy,
                                    salvage_fraction)
from repro_torch.runtime.vector import VectorClusterRuntime

__all__ = [
    "ActuationModel", "PowerLedger",
    "ClusterRuntime", "NodeRuntimeReport", "RuntimeConfig", "RuntimeReport",
    "run_cluster", "VectorClusterRuntime",
    "Event", "EventQueue", "FaultEvent",
    "MigrationModel", "MigrationRecord", "plan_moves",
    "NodeFailureEvent", "CheckpointModel", "chaos_scenario",
    "check_conservation", "run_campaign",
    "RecoveryPolicy", "RecoveryDecision", "salvage_fraction",
]
