"""Paper-faithful evaluation: the five big-data apps under DV-DVFS vs DVO
(paper Figs. 6-10), with measured block costs and sampled estimation.

The port of ``examples/bigdata_apps.py``: each block is timed on
``--device`` (default ``cuda``; ``cpu`` runs without a card) through the
port's ``examples.paper_figs.run_app_comparison``, and the table is the
reference's.

Run:  PYTHONPATH=src python -m repro_torch.examples.bigdata_apps [--planner paper|global] [--slack S] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.examples.paper_figs import run_app_comparison

APPS = ("wordcount", "grep", "inverted_index", "avg", "sum")


def main(argv=None) -> dict:
    """The table; returns each app's comparison by name.  The device is
    resolved first, so a missing card stops the run before any work."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--planner", default="paper",
                    choices=["paper", "global"])
    ap.add_argument("--slack", type=float, default=1.20,
                    help="deadline = DVO time × slack (1.08=tight, 1.20=firm)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"{'app':16s} {'Δenergy':>9s} {'Δtime':>8s} {'deadline':>9s} "
          f"{'est err':>8s}")
    rows = {}
    for app in APPS:
        r = run_app_comparison(app, planner=args.planner, slack=args.slack,
                               device=dev)
        rows[app] = r
        print(f"{app:16s} {-r['energy_improvement']:+9.1%} "
              f"{r['time_increase']:+8.1%} "
              f"{'met' if r['deadline_met'] else 'MISSED':>9s} "
              f"{r['est_mape']:8.3f}")
    print("\n(paper reports 9/15/11/13/7% energy savings at +6-8% time; "
          "power model = paper-era CPU)")
    return rows


if __name__ == "__main__":
    main()
