"""Fleet observatory: spans, metrics, exporters, attribution, what-ifs.

Seven views of one run, all derived from the same deterministic event
stream the runtime engines emit (scalar and vector logs are
bitwise-identical, so every artifact here is too):

* :mod:`repro_torch.obs.spans` — per-block / per-job lifecycle span trees
  reconstructed from the full event log;
* :mod:`repro_torch.obs.metrics` — ``StreamingMetrics``, the bounded-memory
  inline aggregator (``RuntimeConfig(metrics=...)``) plus the post-hoc
  table helpers the examples print;
* :mod:`repro_torch.obs.export` — Chrome-trace/Perfetto JSON, Prometheus text
  exposition (both with structural validators), JSONL;
* :mod:`repro_torch.obs.explain` — ``explain_miss`` / ``explain_energy``
  decompositions that sum *exactly* to the observed wall / joules;
* :mod:`repro_torch.obs.counterfactual` — deterministic what-if replay:
  ``ablate`` / ``profile_mechanisms`` re-run a captured ``Scenario`` with
  one mechanism neutralized and ledger the exact delta;
* :mod:`repro_torch.obs.diff` — ``diff_runs`` aligns two runs' span trees and
  rolls per-block deltas up to per-node/-tenant/-mechanism tables;
* :mod:`repro_torch.obs.watchdog` — SRE-style multi-window SLO burn-rate
  alerting off the streaming metrics, deterministic alert streams.

Copied from ``src/repro/obs/__init__.py`` with its imports pointed at
``repro_torch``. It is NumPy, as the original is, so its results are bit-
identical to the reference's.
"""
from repro_torch.obs.counterfactual import (MECHANISMS, Scenario, ablate,
                                            delta_ledger, mechanism_columns,
                                            neutralize, profile_mechanisms)
from repro_torch.obs.diff import RunDiff, diff_runs
from repro_torch.obs.explain import explain_energy, explain_miss
from repro_torch.obs.export import (to_chrome_trace, to_jsonl, to_prometheus,
                                    validate_chrome_trace, validate_prometheus,
                                    write_chrome_trace, write_jsonl)
from repro_torch.obs.metrics import (StreamingMetrics, format_table, node_rows,
                                     tenant_rows)
from repro_torch.obs.spans import (Span, build_job_spans, build_spans, flatten,
                                   require_full_log)
from repro_torch.obs.watchdog import Alert, Rule, Watchdog, standard_rules

__all__ = [
    "Span", "build_spans", "build_job_spans", "flatten", "require_full_log",
    "StreamingMetrics", "node_rows", "tenant_rows", "format_table",
    "to_chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "to_prometheus", "validate_prometheus", "to_jsonl", "write_jsonl",
    "explain_miss", "explain_energy",
    "MECHANISMS", "Scenario", "neutralize", "ablate", "delta_ledger",
    "profile_mechanisms", "mechanism_columns",
    "RunDiff", "diff_runs",
    "Rule", "Alert", "Watchdog", "standard_rules",
]
