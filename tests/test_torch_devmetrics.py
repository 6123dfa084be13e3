"""PyTorch port of `obs/devmetrics.py` against the JAX module, on the CPU.

The cases of `tests/test_devmetrics.py` that apply to eager torch: the
same observations go through the JAX accumulators (under `jit`, `vmap`
and `scan`) and the port's (a loop over steps with one accumulator per
lane), and both flush into fresh registries.  The flushed values and the
registry series must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multihop_offload_tpu.obs.devmetrics import DevMetrics as JDevMetrics
from multihop_offload_tpu.obs.devmetrics import pow2_buckets as j_pow2_buckets
from multihop_offload_tpu.obs.registry import MetricRegistry as JRegistry
from multihop_offload_tpu_torch.obs.devmetrics import DevMetrics, pow2_buckets
from multihop_offload_tpu_torch.obs.registry import MetricRegistry

BOUNDS = (0.0, 1.0, 2.0, 4.0, 8.0)


def _decl(cls):
    dm = cls()
    c = dm.counter("mho_dev_t_events_total", "events seen")
    g = dm.gauge("mho_dev_t_level", "last level")
    h = dm.histogram("mho_dev_t_depth", BOUNDS, "depth")
    return dm.freeze(), c, g, h


def _series(reg) -> dict:
    snap = reg.snapshot()
    return {name: snap[name]["series"] for name in sorted(snap)}


@pytest.mark.parametrize("hi", [64, 6, 1, 128])
def test_pow2_buckets_ladder(hi):
    assert pow2_buckets(hi) == j_pow2_buckets(hi)
    assert pow2_buckets(64) == (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


def test_lanes_over_steps_flush_like_jax():
    """3 lanes x 7 steps of counter, gauge and histogram updates: the JAX
    scan under vmap and the port's per-lane accumulators flush to the same
    values and the same registry series."""
    lanes, steps, width = 3, 7, 4
    xs = ((np.arange(lanes * steps * width) % 9).astype(np.float32)
          .reshape(lanes, steps, width))
    jdm, C, G, H = _decl(JDevMetrics)
    tdm, *_ = _decl(DevMetrics)

    def body(dev, x):
        dev = jdm.inc(dev, C, x > 0)
        dev = jdm.set(dev, G, jnp.sum(x))
        return jdm.observe(dev, H, x), ()

    @jax.jit
    def run(x):
        return jax.vmap(lambda xl: jax.lax.scan(body, jdm.init(), xl)[0])(x)

    jreg, treg = JRegistry(), MetricRegistry()
    want = jdm.flush(run(jnp.asarray(xs)), reg=jreg)
    dev = tdm.init((lanes,))
    xt = torch.from_numpy(xs)
    for s in range(steps):
        dev = tdm.inc(dev, C, xt[:, s] > 0)
        dev = tdm.set(dev, G, xt[:, s].sum(dim=1))
        dev = tdm.observe(dev, H, xt[:, s])
    got = tdm.flush(dev, reg=treg)
    assert got == want
    assert got[G] == pytest.approx(float(np.mean(xs[:, -1, :].sum(axis=1))))
    assert _series(treg) == _series(jreg)


def test_flush_merges_leading_axes_like_jax():
    """Two windows stacked as replicas (weights masking observations):
    counters and buckets sum, min/max reduce, gauges average, under
    flush-site labels; a second flush accumulates into the same series."""
    jdm, C, G, H = _decl(JDevMetrics)
    tdm, *_ = _decl(DevMetrics)
    outs = []
    for dm, xp, reg in ((jdm, jnp, JRegistry()), (tdm, torch, MetricRegistry())):
        d1 = dm.init()
        d1 = dm.observe(d1, H, xp.asarray([0.0, 0.5, 3.0]), weights=xp.asarray([1, 0, 2]))
        d1 = dm.inc(d1, C, 5)
        d1 = dm.set(d1, G, 2.0)
        d2 = dm.init()
        d2 = dm.observe(d2, H, xp.asarray([9.0, 1.0]))
        d2 = dm.inc(d2, C, xp.asarray([True, False, True]))
        d2 = dm.set(d2, G, 4.0)
        stacked = jax.tree_util.tree_map(lambda a, b, xp=xp: xp.stack([a, b]), d1, d2)
        first = dm.flush(stacked, reg=reg, shard="x")
        dm.flush(stacked, reg=reg, shard="x")
        outs.append((first, _series(reg), reg.counter("mho_dev_t_events_total")
                     .value(shard="x")))
    assert outs[0] == outs[1]
    first = outs[1][0]
    assert first[H] == {"counts": [1, 1, 0, 2, 0, 1], "count": 5, "sum": 16.0,
                        "min": 0.0, "max": 9.0}
    assert first[C] == 7.0 and first[G] == pytest.approx(3.0)
    assert outs[1][2] == 14.0


def test_merge_and_empty_window_like_jax():
    """`merge` of two windows, then an empty window's flush: no min/max."""
    jdm, C, G, H = _decl(JDevMetrics)
    tdm, *_ = _decl(DevMetrics)
    got = []
    for dm, xp, reg in ((jdm, jnp, JRegistry()), (tdm, torch, MetricRegistry())):
        a = dm.observe(dm.inc(dm.init(), C, 2), H, xp.asarray([1.0, 16.0]))
        b = dm.set(dm.observe(dm.init(), H, xp.asarray([-1.0, 4.0])), G, 5.0)
        got.append((dm.flush(dm.merge(a, b), reg=reg), dm.flush(dm.init(), reg=reg),
                    _series(reg)))
    assert got[0] == got[1]
    assert got[1][1][H]["min"] is None and got[1][1][H]["count"] == 0


def test_sim_accumulators_on_a_batch_equal_jax_vmap():
    """The sim's declaration (int32 counters, the pow2 depth histogram)
    updated per lane from (B, M) masks and depths equals JAX's vmap."""
    from multihop_offload_tpu.sim.step import sim_devmetrics as j_sim_dm
    from multihop_offload_tpu.sim.state import SimSpec as JSpec
    from multihop_offload_tpu_torch.sim.state import SimSpec
    from multihop_offload_tpu_torch.sim.step import DM_DROP_CAP, DM_QUEUE_DEPTH
    from multihop_offload_tpu_torch.sim.step import sim_devmetrics

    rng = np.random.default_rng(2)
    depth = rng.integers(0, 70, (4, 5, 40)).astype(np.int32)
    mask = rng.uniform(size=(4, 5, 16)) < 0.3
    jdm, tdm = j_sim_dm(JSpec(8, 8, 4, cap=64)), sim_devmetrics(SimSpec(8, 8, 4, cap=64))
    assert tdm.keys() == jdm.keys()
    assert tdm.buckets_of(DM_QUEUE_DEPTH) == jdm.buckets_of(DM_QUEUE_DEPTH)

    def lane(d, m):
        def body(dev, x):
            return jdm.inc(jdm.observe(dev, DM_QUEUE_DEPTH, x[0]), DM_DROP_CAP, x[1]), ()
        return jax.lax.scan(body, jdm.init(), (d, m))[0]

    want = jdm.flush(jax.jit(jax.vmap(lane))(depth, mask), reg=JRegistry())
    dev = tdm.init((4,))
    for s in range(5):
        dev = tdm.observe(dev, DM_QUEUE_DEPTH, torch.from_numpy(depth[:, s]))
        dev = tdm.inc(dev, DM_DROP_CAP, torch.from_numpy(mask[:, s]))
    assert tdm.flush(dev, reg=MetricRegistry()) == want


def test_declaration_is_frozen_after_init():
    dm = DevMetrics()
    dm.counter("mho_dev_t_a_total")
    dm.init()
    with pytest.raises(RuntimeError):
        dm.counter("mho_dev_t_b_total")
    with pytest.raises(ValueError):
        DevMetrics().histogram("mho_dev_t_h", ())
    with pytest.raises(ValueError, match="duplicate"):
        d = DevMetrics()
        d.counter("x_total", reason="a")
        d.counter("x_total", reason="a")
    with pytest.raises(KeyError):
        dm.inc(dm.init(), "mho_dev_t_missing_total")


def test_observe_bucketed_refuses_a_bucket_mismatch():
    h = MetricRegistry().histogram("mho_t_h", buckets=BOUNDS)
    with pytest.raises(ValueError, match="bucket mismatch"):
        h.observe_bucketed([1, 2], 3.0)
