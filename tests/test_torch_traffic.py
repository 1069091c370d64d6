"""PyTorch port, the traffic model (serving/traffic.py), held against the
JAX package's ``TrafficModel``.

The model cases of ``tests/test_traffic.py`` run on both packages' classes
with the same expectations (seeded determinism, the rate curve, the
priority mix, the zipf style skew, the argument checks), and the port's
schedule equals the JAX package's event for event, exactly, for the same
arguments. The model is host only: no clock, no device.
"""

import dataclasses
import importlib

import numpy as np
import pytest

from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)

PKGS = ("torch", "tpu")


def traffic(name):
    return importlib.import_module(f"speakingstyle_{name}.serving.traffic")


def model(name, **kw):
    args = dict(seed=7, base_qps=50.0, duration_s=6.0, flash_windows=[(2.0, 4.0)],
                flash_multiplier=10.0, n_styles=32)
    args.update(kw)
    return traffic(name).TrafficModel(**args)


# the argument sets the port's schedule is held to JAX's on, exactly
SCHEDULES = {
    "default": {},
    "seed_8": {"seed": 8},
    "no_flash": {"flash_windows": [], "duration_s": 20.0},
    "two_flashes": {"flash_windows": [(0.5, 1.0), (4.0, 5.5)], "flash_multiplier": 4.0},
    "diurnal": {"diurnal_period_s": 2.0, "diurnal_floor": 0.2, "zipf_s": 0.7},
    "custom_mix": {"mix": {"interactive": 1.0, "long_form": 3.0},
                   "priority_map": {"interactive": "interactive", "long_form": "long_form"}},
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_equals_the_jax_schedule(case):
    """The same arguments give the JAX package's events, field for field
    (``t`` and ``length_frac`` as equal floats), and the same describe()."""
    kw = SCHEDULES[case]
    got, want = model("torch", **kw), model("tpu", **kw)
    a, b = got.schedule(), want.schedule()
    assert a and [dataclasses.astuple(e) for e in a] == [dataclasses.astuple(e) for e in b]
    assert got.describe() == want.describe()
    for t in np.linspace(0.0, got.duration_s, 13, endpoint=False):
        assert got.rate_at(t) == want.rate_at(t)


@pytest.mark.parametrize("name", PKGS)
def test_same_seed_identical_schedule(name):
    a, b = model(name).schedule(), model(name).schedule()
    assert a == b and model(name).schedule() == a
    assert a and all(isinstance(e, traffic(name).TrafficEvent) for e in a)


@pytest.mark.parametrize("name", PKGS)
def test_different_seed_differs(name):
    assert model(name).schedule() != model(name, seed=8).schedule()


@pytest.mark.parametrize("name", PKGS)
def test_rate_curve_shape(name):
    m = model(name, diurnal_floor=0.4)
    assert m.diurnal_at(0.0) == pytest.approx(0.4)
    assert m.diurnal_at(3.0) == pytest.approx(1.0)
    assert m.rate_at(3.0) == pytest.approx(10.0 * m.base_qps)
    assert m.rate_at(1.0) < m.base_qps
    sched = m.schedule()
    assert sum(2.0 <= e.t < 4.0 for e in sched) / len(sched) > 0.6
    assert all(0.0 <= e.t < m.duration_s for e in sched)
    assert all(sched[i].t <= sched[i + 1].t for i in range(len(sched) - 1))


@pytest.mark.parametrize("name", PKGS)
def test_mix_rides_existing_priority_classes(name):
    sched = model(name, duration_s=20.0, flash_windows=[]).schedule()
    assert {e.kind for e in sched} == {"interactive", "batch", "long_form"}
    for e in sched:
        assert e.priority in ("interactive", "batch")
        if e.kind == "long_form":
            # a chapter past the interactive lattice: /synthesize/longform
            assert e.priority == "batch" and 2.0 <= e.length_frac <= 8.0
        else:
            assert 0.0 < e.length_frac < 1.0
    assert 0.45 < sum(e.kind == "interactive" for e in sched) / len(sched) < 0.75


@pytest.mark.parametrize("name", PKGS)
def test_zipf_styles_are_skewed_and_bounded(name):
    styles = [e.style for e in model(name, duration_s=30.0, flash_windows=[],
                                     n_styles=16).schedule()]
    assert all(0 <= s < 16 for s in styles)
    counts = np.bincount(styles, minlength=16)
    assert counts[0] == counts.max() and counts[0] > 3 * counts[8:].mean()
    assert (counts > 0).sum() >= 8


BAD_ARGS = {
    "base_qps": ({"base_qps": 0}, "base_qps"),
    "duration": ({"duration_s": 0}, "duration_s"),
    "floor": ({"diurnal_floor": 1.5}, "diurnal_floor"),
    "flash_window": ({"flash_windows": [(5.0, 99.0)]}, "flash window"),
    "flash_multiplier": ({"flash_multiplier": 0.5}, "flash_multiplier"),
    "kinds": ({"mix": {"interactive": 1.0, "cinematic": 1.0}}, "unknown traffic kinds"),
    "mix_weight": ({"mix": {"interactive": 0.0}}, "positive total weight"),
    "priority_map": ({"priority_map": {"interactive": "interactive"}}, "priority_map"),
    "n_styles": ({"n_styles": 0}, "n_styles"),
    "zipf": ({"zipf_s": 0.0}, "zipf_s"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_validation_refuses_as_jax_does(case):
    kw, match = BAD_ARGS[case]
    for name in PKGS:
        with pytest.raises(ValueError, match=match):
            model(name, **kw)
    assert "seed" in model("torch").describe()
