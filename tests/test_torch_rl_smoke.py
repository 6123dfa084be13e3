"""`python -m multihop_offload_tpu_torch.cli.rl --device cpu --smoke`:
JAX's smoke configuration, its gates and the record's keys, on the CPU.
"""

import json

from multihop_offload_tpu_torch.cli import rl as rl_cli


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


def test_unported_rl_settings_are_refused():
    """What JAX's RL path runs and the port's does not is refused, citing
    the roadmap: a mixed precision policy (`auto` resolves to fp32 on the
    CPU, and runs) and bf16 storage."""
    import pytest
    import torch

    from multihop_offload_tpu_torch.config import Config

    Config(precision="auto").check_rl(torch.device("cpu"))
    for kw in (dict(precision="bf16"), dict(dtype="bfloat16")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Config(**kw).check_rl(torch.device("cpu"))
