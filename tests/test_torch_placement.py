"""PyTorch port, `serve/placement.py` against the JAX package's.

The counterparts of every test of `tests/test_placement.py`, each also
holding the port's output (counts, plans, peak loads, planner states and
switch counts) equal to the JAX module's on the same inputs, and plans of
both on seeded random rate vectors and fleets, ties included.  Pure host
code: no device, no model.
"""

import numpy as np
import pytest

from multihop_offload_tpu.serve import placement as jpl
from multihop_offload_tpu_torch.serve import placement as tpl
from multihop_offload_tpu_torch.serve.placement import (
    PlacementPlan,
    PlacementPlanner,
    allowed_counts,
    peak_device_load,
    plan_assignments,
)


def _same_plan(rates, devices, slots):
    got = plan_assignments(rates, devices, slots)
    assert got == jpl.plan_assignments(rates, devices, slots)
    return got


def _planners(*args, **kw):
    return PlacementPlanner(*args, **kw), jpl.PlacementPlanner(*args, **kw)


def _same_state(p, j):
    assert p.plan.assignments == j.plan.assignments
    assert p.rates == j.rates and p.replans == j.replans and p.devices == j.devices


def test_allowed_counts_are_divisors():
    for slots, cap, want in ((8, 6, [1, 2, 4]), (8, 8, [1, 2, 4, 8]), (4, 2, [1, 2]),
                             (5, 8, [1, 5])):
        assert allowed_counts(slots, cap) == want == jpl.allowed_counts(slots, cap)


def test_greedy_plan_is_deterministic_for_fixed_rates():
    plan = _same_plan([10.0, 1.0], list(range(6)), 8)
    assert plan == ((0, 1, 2, 3), (4, 5))
    assert plan == plan_assignments([10.0, 1.0], list(range(6)), 8)


def test_every_bucket_count_divides_slots():
    for rates in ([1, 1, 1], [9, 3, 1], [0, 0, 5]):
        plan = _same_plan(rates, list(range(8)), 8)
        for devs in plan:
            assert devs and 8 % len(devs) == 0


def test_all_cold_spreads_evenly():
    assert _same_plan([0.0, 0.0], list(range(4)), 4) == ((0, 1), (2, 3))


def test_fleet_smaller_than_ladder_shares_round_robin():
    plan = _same_plan([1.0, 2.0, 3.0], [0, 1], 4)
    assert plan == ((0,), (1,), (0,))
    assert PlacementPlan(plan).buckets_on(0) == [0, 2] == jpl.PlacementPlan(plan).buckets_on(0)


def test_peak_device_load():
    plan = ((0, 1, 2, 3), (4, 5))
    for rates, want in (([10.0, 1.0], 2.5), ([4.0, 8.0], 4.0)):
        got = peak_device_load(plan, rates)
        assert got == pytest.approx(want) and got == jpl.peak_device_load(plan, rates)


def test_planner_stable_under_small_jitter():
    p, j = _planners(2, devices=list(range(6)), slots=8, alpha=1.0)
    for q in (p, j):
        q.observe([100, 10])
    settled = p.replan()
    j.replan()
    assert settled.assignments == ((0, 1, 2, 3), (4, 5))
    _same_state(p, j)
    switches = p.replans
    for a, b in ((105, 10), (95, 11), (102, 9), (98, 10)):
        for q in (p, j):
            q.observe([a, b])
        assert p.replan().assignments == settled.assignments
        j.replan()
        _same_state(p, j)
    assert p.replans == switches


def test_planner_switches_when_clearly_better():
    p, j = _planners(2, devices=list(range(6)), slots=8, alpha=1.0, hysteresis=0.2)
    for rates, want in (([100, 10], ((0, 1, 2, 3), (4, 5))),
                        ([10, 100], ((0, 1), (2, 3, 4, 5)))):
        for q in (p, j):
            q.observe(rates)
        assert p.replan().assignments == want
        j.replan()
        _same_state(p, j)


def test_device_removal_forces_replan():
    p, j = _planners(2, devices=list(range(6)), slots=8, alpha=1.0)
    for q in (p, j):
        q.observe([100, 10])
    before = p.replan()
    j.replan()
    assert before.uses(5)
    after = p.remove_device(5)
    j.remove_device(5)
    _same_state(p, j)
    assert not after.uses(5)
    assert all(devs for devs in after.assignments)
    assert after.assignments == ((0, 1, 2, 3), (4,))
    restored = p.add_device(5)
    j.add_device(5)
    _same_state(p, j)
    assert 5 in p.devices
    assert all(8 % len(devs) == 0 for devs in restored.assignments)


def test_remove_last_device_raises():
    for q in _planners(1, devices=[0], slots=4):
        with pytest.raises(ValueError, match="empty after device removal"):
            q.remove_device(0)


def test_observe_rejects_wrong_arity():
    for q in _planners(2, devices=[0, 1], slots=4):
        with pytest.raises(ValueError, match="3 arrival counts for 2 buckets"):
            q.observe([1, 2, 3])


def test_plan_describe_uses_device_ids():
    class Dev:
        def __init__(self, i):
            self.id = i

    plan = ((Dev(0), Dev(1)), (Dev(2),))
    assert PlacementPlan(plan).describe() == {"0": [0, 1], "1": [2]}
    assert PlacementPlan(plan).describe() == jpl.PlacementPlan(plan).describe()
    # the service's fleet indices render as themselves
    assert PlacementPlan(((0, 1), (2,))).describe() == {"0": [0, 1], "1": [2]}


@pytest.mark.parametrize("seed", range(6))
def test_random_rates_and_fleets_plan_like_jax(seed):
    """Seeded rate vectors (ties and zeros included) over fleets of 1..9
    devices and slot counts with few and many divisors: equal plans, and a
    planner fed the same windows (with a device lost and restored midway)
    keeps the JAX planner's plan, rates and switch count at every step."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n_b = int(rng.integers(1, 5))
        rates = [float(x) for x in rng.choice([0.0, 1.0, 2.0, 3.5, 8.0, 20.0], n_b)]
        devs = list(range(int(rng.integers(1, 10))))
        slots = int(rng.choice([1, 4, 6, 8, 12, 16]))
        _same_plan(rates, devs, slots)
    p, j = _planners(3, devices=list(range(8)), slots=8, alpha=0.5, hysteresis=0.2)
    for step in range(12):
        arrivals = [int(x) for x in rng.poisson([6.0, 2.0, 0.5])]
        for q in (p, j):
            q.observe(arrivals)
        if step == 5:
            victim = p.plan.assignments[0][-1]
            for q in (p, j):
                q.remove_device(victim)
        if step == 9:
            back = 7 if 7 not in p.devices else 0
            for q in (p, j):
                q.add_device(back)
        p.replan()
        j.replan()
        _same_state(p, j)


def test_replans_counter_and_event_like_jax():
    """A switch counts `mho_serve_replans_total` once in the port's own
    registry, as the JAX planner counts it in its."""
    from multihop_offload_tpu.obs.registry import registry as jreg
    from multihop_offload_tpu_torch.obs.registry import registry as treg

    def total(reg):
        return reg().counter("mho_serve_replans_total").total()

    before = (total(treg), total(jreg))
    p, j = _planners(2, devices=list(range(6)), slots=8, alpha=1.0)
    for q in (p, j):
        q.observe([10, 100])
        q.replan()
    assert p.replans == j.replans == 1
    assert total(treg) - before[0] == total(jreg) - before[1] == 1
    assert tpl._RATE_FLOOR == jpl._RATE_FLOOR
