"""`python -m multihop_offload_tpu_torch.cli.rl --device cpu --smoke`:
JAX's smoke configuration, its gates and the record's keys, on the CPU;
`run_train`'s fleet, simulator and initial rates at float32 under every
`dtype`, and its trainer under the bf16 settings.
"""

import dataclasses
import json
import math

import pytest
import torch

from multihop_offload_tpu_torch.cli import rl as rl_cli
from multihop_offload_tpu_torch.config import Config


# the keys of JAX's smoke record (`cli/rl.py:184-215`) the port keeps: all
# but the TPU target `onchip_gate_*`
JAX_KEYS = {"mode", "platform", "devices", "fleet", "mesh", "nodes", "jobs", "rounds",
            "slots_per_round", "steps", "rho_target", "temperature", "lr", "ent_weight",
            "loss_first", "loss_last", "skipped_updates", "unexpected_retraces",
            "conservation", "delivered_ratio_init", "delivered_ratio_trained", "improved",
            "episodes_per_s", "timed_episodes", "timed_wall_s"}


def test_cli_smoke_on_the_cpu(tmp_path):
    """JAX's smoke configuration; its gates asserted (exact conservation, no
    skipped update) with the port's launch gate; the improvement gate
    evaluated and recorded (at seed 0 it fails: ROADMAP.md Queue 3); the
    record with JAX's keys."""
    out = tmp_path / "rl.json"
    assert rl_cli.main(["--device", "cpu", "--smoke", "--rl_out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert JAX_KEYS <= set(rec) and not any(k.startswith("onchip") for k in rec)
    assert rec["mode"] == "smoke" and rec["platform"] == "cpu"
    assert rec["conservation"]["exact"] and rec["conservation"]["host"]["generated"] > 0
    assert rec["skipped_updates"] == 0 and rec["steady_launches"]
    assert rec["unexpected_retraces"] is None
    assert isinstance(rec["improved"], bool)
    assert rec["improved"] == (rec["delivered_ratio_trained"] > rec["delivered_ratio_init"])
    assert (rec["nodes"], rec["jobs"], rec["fleet"], rec["rounds"], rec["slots_per_round"],
            rec["steps"]) == (8, 3, 4, 2, 100, 20)


# a short run of the smoke preset: 2 steps of 2 rounds x 10 slots
SHORT = dict(rl_cli.SMOKE, rl_steps=2, rl_slots=10)


def _float_dtypes(x) -> set:
    """The dtypes of every floating tensor in a record (nested records and
    containers included)."""
    if isinstance(x, torch.Tensor):
        return {x.dtype} if x.is_floating_point() else set()
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    elif not isinstance(x, (list, tuple)):
        return set()
    return set().union(*(_float_dtypes(v) for v in x)) if x else set()


def _recorded_run(monkeypatch, **kw):
    """`run_train(smoke=True)` of `SHORT` under `Config(**kw)` on the CPU,
    with the trainer it builds and what its evaluator is handed (fleet,
    states, initial rates) recorded."""
    import multihop_offload_tpu_torch.rl as rl

    seen = {}

    class Recorded(rl.RLTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["trainer"] = self

    orig_eval = rl.make_eval

    def make_eval(*a, **k):
        ev = orig_eval(*a, **k)

        def recorded(params, insts, jobss, paramss, states, rates, *rest, **kk):
            seen.update(fleet=(insts, jobss, paramss), states=states, rates=rates)
            return ev(params, insts, jobss, paramss, states, rates, *rest, **kk)

        return recorded

    monkeypatch.setattr(rl, "RLTrainer", Recorded)
    monkeypatch.setattr(rl, "make_eval", make_eval)
    cfg = dataclasses.replace(Config(seed=0, **kw), **SHORT)
    return seen, rl_cli.run_train(cfg, smoke=True, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_fleet_simulator_and_rates_are_float32_at_any_dtype(dtype, monkeypatch):
    """`mho-rl` builds the fleet, the simulator's state and the initial
    rates at float32 whatever `cfg.dtype` is, as JAX's `cli/rl.py` does
    (`make_case`'s default, `RLTrainer(sim_dtype=jnp.float32)`, `rates0`);
    only the model takes `cfg.dtype` (through the precision policy)."""
    seen, _ = _recorded_run(monkeypatch, dtype=dtype)
    tr = seen["trainer"]
    assert _float_dtypes(seen["fleet"]) == {torch.float32}
    assert _float_dtypes(seen["states"]) == {torch.float32} and tr.sim_dtype == torch.float32
    assert seen["rates"].dtype == torch.float32
    want = Config(dtype=dtype).precision_policy("cpu").param_dtype
    assert {p.dtype for p in tr.params.values()} == {want}


@pytest.mark.parametrize("kw", [dict(precision="bf16"), dict(dtype="bfloat16"),
                                dict(precision="auto")], ids=["bf16", "bfloat16", "auto"])
def test_bf16_settings_build_a_trainer_and_step(kw, monkeypatch):
    """The RL path runs under the mixed policy and at a bf16 base (`auto`
    resolves to fp32 on the CPU): the trainer builds under the policy and
    steps, no update skipped, finite losses, the smoke's gates held."""
    seen, rec = _recorded_run(monkeypatch, **kw)
    tr = seen["trainer"]
    pol = Config(**kw).precision_policy("cpu")
    assert tr.steps == SHORT["rl_steps"] and rec["skipped_updates"] == 0
    assert math.isfinite(rec["loss_first"]) and math.isfinite(rec["loss_last"])
    assert rec["conservation"]["exact"] and rec["steady_launches"]
    assert {p.dtype for p in tr.params.values()} == {pol.param_dtype}
    assert {m.dtype for m in tr.opt_state.mu.values()} == {pol.param_dtype}
    layer = tr.model.layers[0]
    assert layer.compute_dtype == (torch.bfloat16 if pol.mixed else None)


@pytest.mark.parametrize("kw", [dict(precision="bf16"), dict(dtype="bfloat16")],
                         ids=["bf16", "bfloat16"])
def test_bf16_fleet_shards_as_in_fp32(kw):
    """`rl_mesh = 2` under the bf16 settings, on `[cpu] * 2`: the lanes roll
    out as on one device (the same rewards and destinations), and the
    mean of the shard means steps the parameters as the one-device mean
    does, to the rounding of the parameters' dtype."""
    from multihop_offload_tpu_torch.parallel.mesh import make_mesh
    from multihop_offload_tpu_torch.rl import RLTrainer

    cfg = dataclasses.replace(Config(seed=0, **kw), **SHORT, rl_temp=1000.0)
    insts, jobss, paramss, spec, _ = rl_cli.build_fleet(cfg, "cpu")
    model = rl_cli.make_rl_model(cfg, insts, jobss)
    one = RLTrainer(cfg, model, spec)
    two = RLTrainer(cfg, model, spec, mesh=make_mesh(2, 1, [torch.device("cpu")] * 2))
    seeds = rl_cli.train_seeds(cfg, 0)
    a = one.train_step(insts, jobss, paramss, seeds)
    b = two.train_step(insts, jobss, paramss, seeds)
    assert torch.equal(a.rewards, b.rewards) and torch.equal(a.dsts, b.dsts)
    assert len(two.devices) == 2 and one.sim_totals == two.sim_totals
    for k, p in one.params.items():
        q = two.params[k]
        assert q.dtype == p.dtype == model.layers[0].kernel.dtype
        ulp = torch.finfo(p.dtype).eps
        torch.testing.assert_close(q.double(), p.double(), rtol=ulp, atol=ulp * 1e-3)


def test_bfloat16_run_saves_and_restores_its_state(tmp_path):
    """A train run at a bf16 base saves its bf16 parameters and Adam moments
    (the integrity checksum hashes bf16 leaves by their 16-bit words, the
    bytes JAX's `bfloat16` arrays hold) and restores them bit for bit; a
    flipped bit changes the checksum."""
    from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

    cfg = dataclasses.replace(Config(seed=0, dtype="bfloat16", model_root=str(tmp_path)),
                              **{**SHORT, "rl_steps": 1})
    rec = rl_cli.run_train(cfg, device="cpu")
    directory, step = rec["checkpoint"]["dir"], rec["checkpoint"]["step"]
    state = ckpt_lib.restore_checkpoint_raw(directory, step)
    leaves = [*state["params"].values(), *state["opt_state"]["mu"].values(),
              *state["opt_state"]["nu"].values()]
    assert {x.dtype for x in leaves} == {torch.bfloat16}
    restored = ckpt_lib.restore_checkpoint(directory, state, step)
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(
        leaves, [*restored["params"].values(), *restored["opt_state"]["mu"].values(),
                 *restored["opt_state"]["nu"].values()]))
    flipped = dict(state, params=dict(state["params"]))
    k = next(iter(flipped["params"]))
    flipped["params"][k] = (flipped["params"][k].view(torch.int16) ^ 1).view(torch.bfloat16)
    assert ckpt_lib.tree_checksum(flipped) != ckpt_lib.tree_checksum(state)
