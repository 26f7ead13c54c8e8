"""Overload-resilient online serving: open-loop multi-tenant arrivals with
admission control, backpressure / SLO-aware shedding, rolling-horizon
re-planning, and elastic provisioning on top of the runtime engine.

Entry point: ``run_serving(plan, truth, arrivals, config=..., serving=...)``
with ``arrivals`` an ``repro_torch.pipeline.ArrivalSpec`` (or explicit
``JobArrival`` schedule).  Invariant audits live in
``repro_torch.serving.campaign``.

Copied from ``src/repro/serving/__init__.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from repro_torch.serving.campaign import (ServingScenario,
                                    check_serving_conservation,
                                    run_serving_campaign, serving_scenario)
from repro_torch.serving.fabric import (JobRecord, ProvisioningPolicy,
                                  ServingConfig, ServingFabric,
                                  ServingReport, ServingRuntime, TenantStats,
                                  VectorServingRuntime, run_serving)

__all__ = [
    "JobRecord",
    "ProvisioningPolicy",
    "ServingConfig",
    "ServingFabric",
    "ServingReport",
    "ServingRuntime",
    "ServingScenario",
    "TenantStats",
    "VectorServingRuntime",
    "check_serving_conservation",
    "run_serving",
    "run_serving_campaign",
    "serving_scenario",
]
