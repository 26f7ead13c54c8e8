"""The port's copied calibration layer is bit-identical to ``repro.calibrate``.

``repro_torch.calibrate`` is a NumPy copy, not an import, of the reference
package; the same seeded inputs must give the same bits: synthetic traces,
the power, cost and speed fits, ``calibrate_nodes``, the online calibrator
fed a stream whose node slows down mid-way, and the drift triage.  Fits that
cannot identify their model raise the same ``CalibrationError``.
"""
import dataclasses

import numpy as np
import pytest

import repro.calibrate as rcal
import repro.cluster as rcl
import repro.core as rc
import repro_torch.calibrate as tcal
import repro_torch.cluster as tcl
import repro_torch.core as tc

SEEDS = [0, 1, 2]
MODS = ((rc, rcl, rcal), (tc, tcl, tcal))
POWERS = [(230.0, 80.0, 2.0), (95.0, 15.0, 3.0), (300.0, 40.0, 1.2)]


def _same(a, b):
    """Dataclass / array / container / scalar equality, bit for bit."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


def _trace(core, cal, seed, noise, nodes=("a", "b", "c")):
    return cal.CounterTrace.concat([
        cal.synthetic_trace(name, core.PowerModel(*POWERS[k]),
                            speed=0.7 + 0.3 * k, n_samples=60, noise=noise,
                            seed=seed * 7 + k)
        for k, name in enumerate(nodes)])


def _each(fn):
    """``fn(core, cluster, calibrate)`` for the reference and the port."""
    return [fn(*mods) for mods in MODS]


@pytest.mark.parametrize("noise", [0.0, 0.03])
@pytest.mark.parametrize("seed", SEEDS)
def test_synthetic_trace_and_fits_bit_identical(seed, noise):
    def run(core, cl, cal):
        tr = _trace(core, cal, seed, noise)
        return (tr, tr.power_w, tr.freq_residency(), tr.node_names(),
                [cal.fit_power_model(tr, node=n) for n in tr.node_names()],
                cal.fit_node_speeds(tr), cal.fit_node_speeds(tr, reference="b"))
    ref, port = _each(run)
    _same(port, ref)


@pytest.mark.parametrize("truth", [(0.004, 0.0), (0.01, 0.25), (0.002, 0.45)])
@pytest.mark.parametrize("noise", [0.0, 0.03])
def test_fit_cost_model_bit_identical(truth, noise):
    cost, beta = truth
    rng = np.random.default_rng(11)
    rec = rng.integers(50, 500, 120).astype(float)
    f = rng.choice(np.arange(0.5, 1.001, 0.1), 120)
    wall = rec * cost * np.maximum((1 - beta) / f, 1.0)
    wall = wall * (1 + noise * rng.standard_normal(120))

    def run(core, cl, cal):
        fit = cal.fit_cost_model(rec, f, wall)
        return (fit, fit.time_at(rec[:5], f[:5]), fit.est_time_fmax(rec[:5]),
                fit.roofline(100.0).time_at(0.6),
                fit.roofline_arrays(rec[:7]))
    ref, port = _each(run)
    _same(port, ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_calibrate_nodes_bit_identical(seed):
    def run(core, cl, cal):
        tr = _trace(core, cal, seed, 0.02)
        nodes = [cl.NodeSpec(n, speed=1.0) for n in ("a", "b", "c", "d")]
        return (cal.calibrate_nodes(nodes, tr),
                cal.calibrate_nodes(nodes, tr, fit_power=False),
                cal.calibrate_nodes(nodes, tr, fit_speed=False))
    ref, port = _each(run)
    _same(port, ref)
    assert port[0][0].calibrated and type(port[0][3]).__name__ == "NodeSpec"


@pytest.mark.parametrize("seed", SEEDS)
def test_online_calibrator_bit_identical(seed):
    """One node's samples, its speed falling by a third half-way: the same
    refits, change detections and calibrated specs."""
    def run(core, cl, cal):
        before = cal.synthetic_trace("n0", core.PowerModel(*POWERS[0]),
                                     speed=1.0, n_samples=40, noise=0.02,
                                     seed=seed)
        after = cal.synthetic_trace("n0", core.PowerModel(*POWERS[1]),
                                    speed=0.66, n_samples=40, noise=0.02,
                                    seed=seed + 50)
        oc = cal.OnlineCalibrator(window=24, min_samples=6, refit_every=4)
        flags = [oc.add(s) for s in before.to_samples()]
        flags.append(oc.extend(after.to_samples()[:20]))
        flags += [oc.add(s) for s in after.to_samples()[20:]]
        spec = oc.calibrated_spec("n0", cl.NodeSpec("n0"))
        return (flags, oc.n_refits, oc.power_fit("n0"), oc.speed_fit("n0"),
                spec, oc.power_fit("absent"))
    ref, port = _each(run)
    _same(port, ref)
    assert any(port[0])


@pytest.mark.parametrize("kind", ["flat", "shift", "trend", "skew", "short"])
@pytest.mark.parametrize("seed", SEEDS)
def test_classify_ratios_bit_identical(seed, kind):
    rng = np.random.default_rng(seed)
    n = 4 if kind == "short" else 40
    base = np.exp(rng.normal(0, 0.03, n))
    ratios = {"flat": base, "short": base,
              "shift": base * 1.3,
              "trend": base * np.linspace(1.0, 1.8, n),
              "skew": base * np.where(rng.random(n) < 0.3, 2.5, 1.0)}[kind]
    ref, port = _each(lambda core, cl, cal: cal.classify_ratios(ratios))
    _same(port, ref)


def test_trace_recorder_bit_identical():
    def run(core, cl, cal):
        rec = cal.TraceRecorder()
        rec.record(0.0, 1.5, "n0", 0.8, 0.9, 120.0, 1.2)
        rec.record(1.5, 2.0, "n1", 1.0, 1.0, 300.0, 2.0)
        rec.extend([cal.CounterSample(3.5, 0.0, "n0", 1.0, 1.0, 0.0, 0.0)])
        tr = rec.trace()
        return (tr, tr.power_w, tr.for_node("n0"), tr.to_samples())
    ref, port = _each(run)
    _same(port, ref)


@pytest.mark.parametrize("case", ["two-samples", "one-frequency",
                                  "cost-degenerate", "empty-speeds"])
def test_unidentifiable_fits_raise_the_same_error(case):
    def run(core, cl, cal):
        try:
            if case == "two-samples":
                cal.fit_power_model(cal.synthetic_trace(
                    "n0", core.PowerModel(), n_samples=2, seed=0))
            elif case == "one-frequency":
                cal.fit_power_model(cal.synthetic_trace(
                    "n0", core.PowerModel(), n_samples=20, freqs=(1.0,),
                    util_range=(1.0, 1.0), seed=0))
            elif case == "cost-degenerate":
                cal.fit_cost_model([0.0], [1.0], [0.0])
            else:
                cal.fit_node_speeds(cal.CounterTrace.concat([]))
        except cal.CalibrationError as err:
            return str(err)
        raise AssertionError("no CalibrationError")
    ref, port = _each(run)
    assert port == ref
