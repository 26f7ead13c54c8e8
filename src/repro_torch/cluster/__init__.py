"""Cluster-scale online DV-DVFS: multi-node planning with feedback re-planning.

The paper's Algorithm 1 is single-node and offline: sample every block, pick
one frequency per slot, run.  This package scales that idea to a heterogeneous
cluster and keeps it correct while estimates drift mid-run.

Algorithm sketch
================

Offline (``plan_cluster``)::

    1  sample all blocks -> est PT_i at f_max on the reference node
    2  ASSIGN   auto: plan each candidate split and keep the cheapest —
                  lpt:  largest block first onto the node with the earliest
                        speed-aware finish INCLUDING the block (equal-WORK
                        split, the multi-node analogue of the paper's
                        equal-size blocks; minimizes makespan)
                  pack: consolidate onto the fastest nodes up to their
                        deadline capacity (busy energy scales with busy
                        time, so a fast node at f_max can beat a slow node
                        at its energy-optimal clock)
                  round_robin: the oblivious baseline split, kept as a
                        candidate so auto never loses to the baseline's own
                        placement
    3  DOWNCLOCK one shared max-heap over every (node, block) down-step,
                keyed by energy-saved / time-added on that node's ladder and
                power model; pop steps while the step's node still finishes
                within deadline * (1 - margin).  This is the single-node
                ``global`` greedy of repro.core.scheduler extended across
                nodes: parallel nodes mean per-node time constraints, but one
                global choice of where the next joule is cheapest.

Online (``OnlineReplanner`` inside ``simulate_cluster(..., online=True)``)::

    4  OBSERVE  each finished block's wall time; ratio = observed / base
                prediction feeds the straggler EWMA (repro.train.straggler)
                -> per-node drift estimate + straggler events
    5  REPLAN   when |drift / drift_at_last_plan - 1| > threshold and blocks
                remain: re-estimate the node's tail (base est x drift),
                recompute its budget (deadline - elapsed), re-run the greedy
                on that node only.  Late nodes clock up, early nodes harvest
                slack; hysteresis against the last plan's drift prevents
                frequency oscillation.

Baseline (``plan_independent``): round-robin split (equal block COUNT,
speed- and variety-oblivious) + the paper's Algorithm 1 per node — what N
independent single-node deployments would do.  The cluster benchmark
(``benchmarks/run.py`` section ``cluster``) shows ``plan_cluster`` beating it
on total busy energy at the same deadline on ≥3 heterogeneous nodes.

Planner contract (see ``tests/test_planner_invariants.py``)
-----------------------------------------------------------
* a plan reported ``feasible`` predicts every node inside the deadline;
* every planned frequency is a state of that node's own ladder;
* DV-DVFS busy energy never exceeds the DVO (all-f_max) baseline on the
  same blocks and assignment;
* assignment and down-clocking are deterministic for a fixed input.

Beyond the block boundary: ``repro_torch.runtime`` subsumes ``simulate_cluster``'s
loop with a discrete-event engine — asynchronous actuation (mid-block
frequency switches with latency + switch energy), cross-node migration of
queued blocks when clocking up to f_max cannot recover a straggler, and a
cluster-wide instantaneous power cap (screened at plan time via
``plan_cluster(..., power_cap_w=...)``, enforced at run time by the
actuator).  ``simulate_cluster`` is now a thin compatibility wrapper over
that engine; the original loop survives as ``simulate_cluster_reference``,
the bit-for-bit equivalence oracle of ``tests/test_runtime.py``.

Copied from ``src/repro/cluster/__init__.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from repro_torch.cluster.controller import OnlineReplanner
from repro_torch.cluster.node import CalibratedNodeSpec, NodeSpec
from repro_torch.cluster.planner import (ClusterPlan, ClusterPlanArrays, NodePlan,
                                   NodePlanArrays, assign_block_arrays,
                                   assign_blocks, plan_cluster,
                                   plan_cluster_arrays, plan_independent)
from repro_torch.cluster.sim import (ClusterReport, NodeReport, SlowdownEvent,
                               simulate_cluster, simulate_cluster_reference)

__all__ = [
    "NodeSpec", "CalibratedNodeSpec",
    "ClusterPlan", "NodePlan", "assign_blocks", "plan_cluster",
    "ClusterPlanArrays", "NodePlanArrays", "assign_block_arrays",
    "plan_cluster_arrays",
    "plan_independent",
    "OnlineReplanner",
    "ClusterReport", "NodeReport", "SlowdownEvent", "simulate_cluster",
    "simulate_cluster_reference",
]
