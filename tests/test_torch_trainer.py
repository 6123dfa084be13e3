"""PyTorch port, the Trainer driver and its checkpoints, on the CPU in
float64, on a tiny dataset written by the JAX `generate_dataset`:

* against the JAX Trainer at `explore=0`, `batch=6`, `memory_size=32`, 4
  files, 1 epoch, `best_window=2`, dense at 1 pad bucket and sparse at 2,
  params carried from the JAX harness and the JAX replay's indices
  injected (recomputed from each recorded key as `agent/replay.py:164-168`
  draws them): the CSV rows (strings and integers exact, floats within
  rtol 1e-9, `runtime` excluded), the final params (rtol 1e-9), the
  replay losses (rtol 1e-6: stored in float32) and the best step;
* checkpoints: save, latest and restore bit for bit, retention of the
  newest 3, a corrupted integrity sidecar refused, a params mismatch
  raised, an optimizer-structure mismatch restoring the params only;
* resume: a second Trainer through `cli.train.main --device cpu` continues
  the visit counter past every saved step;
* the run log: each `step` event carries its training step's per-episode
  gradient norms and loss moments (rtol 1e-6: accumulated in float32).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from multihop_offload_tpu.train import driver as jd
from multihop_offload_tpu_torch.agent import replay as treplay
from multihop_offload_tpu_torch.agent.train_step import episode_grad_norms
from multihop_offload_tpu_torch.cli import train as cli_train
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models.chebconv import params_from_jax
from multihop_offload_tpu_torch.obs.events import read_events
from multihop_offload_tpu_torch.train import checkpoints as ckpt
from multihop_offload_tpu_torch.train import driver as td
from tests.test_torch_drivers import assert_rows_equal, common, jax_config, read_rows, tiny  # noqa: F401

TRAIN = dict(batch=6, memory_size=32, learning_rate=1e-3, epochs=1, explore=0.0,
             best_window=2)


def jax_indices(key, count: int, capacity: int, batch: int) -> np.ndarray:
    """The JAX replay's sampled slots for `key` (`agent/replay.py:164-168`)."""
    scores = jax.random.uniform(jnp.asarray(key), (capacity,))
    scores = jnp.where(jnp.arange(capacity) < count, scores, -jnp.inf)
    return np.asarray(lax.top_k(scores, batch)[1])


@pytest.mark.parametrize("layout,buckets", [("dense", 1), ("sparse", 2)])
def test_trainer_matches_jax(tiny, tmp_path, monkeypatch, layout, buckets):
    kw = common(tiny, tmp_path, layout=layout, pad_buckets=buckets, **TRAIN)
    jt = jd.Trainer(jax_config(**kw))
    p0 = jax.device_get(jt.variables["params"])
    keys = []
    inner = jt._replay

    def recording(mem, params, opt_state, key):
        keys.append((np.asarray(key), int(mem.count)))
        return inner(mem, params, opt_state, key=key)

    recording.account = inner.account
    jt._replay = recording
    want = read_rows(jt.run(verbose=False))

    indices = iter([jax_indices(k, c, TRAIN["memory_size"], TRAIN["batch"])
                    for k, c in keys])
    monkeypatch.setattr(treplay, "sample_indices",
                        lambda mem, batch, gen=None: torch.tensor(next(indices)))
    tt = td.Trainer(Config(**{**kw, "out": str(tmp_path / "port"),
                              "model_root": str(tmp_path / "port_model")}), device="cpu")
    tt.model.load_state_dict(params_from_jax(p0))
    got = read_rows(tt.run(verbose=False))
    assert len(got) == 4 * 4 * 4 and list(got[0]) == td.TRAIN_COLUMNS == jd.TRAIN_COLUMNS
    assert_rows_equal(got, want)
    assert next(indices, None) is None and len(keys) == len(tt.replay_losses) >= 2
    np.testing.assert_allclose(tt.replay_losses, jt.replay_losses, rtol=1e-6, atol=0)
    final = params_from_jax(jax.device_get(jt.variables["params"]))
    start = params_from_jax(p0)
    for k, v in tt.params().items():
        assert not torch.equal(final[k], start[k])  # the replays moved it
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), rtol=1e-9,
                                   atol=1e-9 * float(final[k].abs().max()))
    assert tt.best_tau == jt.best_tau
    with open(os.path.join(jt.model_dir, "orbax_best", "best.json")) as f:
        jbest = json.load(f)
    with open(os.path.join(tt.model_dir, "torch_best", "best.json")) as f:
        tbest = json.load(f)
    assert tbest["step"] == jbest["step"]
    np.testing.assert_allclose(tbest["rolling_gnn_test_tau"], jbest["rolling_gnn_test_tau"],
                               rtol=1e-9)


def _state(seed: int, count: int = 2):
    g = torch.Generator().manual_seed(seed)
    leaf = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)
    params = {"layers.0.kernel": leaf(2, 4, 8), "layers.0.bias": leaf(8)}
    return {"params": params,
            "opt_state": {"count": count, "mu": {k: leaf(*v.shape) for k, v in params.items()},
                          "nu": {k: leaf(*v.shape) for k, v in params.items()}},
            "step": 0}


def test_checkpoint_round_trip_retention_and_integrity(tmp_path):
    d = str(tmp_path / "torch")
    assert ckpt.latest_step(d) is None and ckpt.restore_checkpoint(d, _state(0)) is None
    for step in (3, 5, 8, 9):
        ckpt.save_checkpoint(d, step, {**_state(step), "step": step},
                             lineage=ckpt.make_lineage("offline", extra={"k": step}))
    assert ckpt.all_steps(d) == [5, 8, 9] and ckpt.latest_step(d) == 9
    assert not os.path.exists(os.path.join(d, "integrity", "3.json"))
    assert ckpt.load_lineage(d)["k"] == 9 and ckpt.load_lineage(d, 5)["source"] == "offline"
    got = ckpt.restore_checkpoint(d, _state(0), 8)
    want = _state(8)
    assert ckpt.tree_checksum(got) == ckpt.tree_checksum({**want, "step": 8})
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v)
    assert int(got["opt_state"]["count"]) == 2 and int(got["step"]) == 8
    with pytest.raises(FileExistsError):
        ckpt.save_checkpoint(d, 9, _state(1))
    # a corrupted sidecar, or none, is refused
    side = os.path.join(d, "integrity", "9.json")
    with open(side) as f:
        rec = json.load(f)
    with open(side, "w") as f:
        json.dump({**rec, "sha256": "0" * 64}, f)
    with pytest.raises(ckpt.IntegrityError):
        ckpt.restore_checkpoint(d, _state(0))
    with open(side, "w") as f:
        f.write("{torn")
    with pytest.raises(ckpt.IntegrityError):
        ckpt.restore_checkpoint_raw(d, 9)
    # a changed state file no longer matches its sidecar
    state = torch.load(os.path.join(d, "5", ckpt.STATE_FILE), weights_only=True)
    state["params"]["layers.0.bias"][0] += 1.0
    torch.save(state, os.path.join(d, "5", ckpt.STATE_FILE))
    with pytest.raises(ckpt.IntegrityError):
        ckpt.restore_checkpoint(d, _state(0), 5)
    # a template of another structure raises ValueError
    other = _state(0)
    other["params"]["layers.0.bias"] = torch.zeros(9, dtype=torch.float64)
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(d, other, 8)


def _trainer(tiny, tmp_path, **kw):
    return td.Trainer(Config(**common(tiny, tmp_path, **{**TRAIN, **kw})), device="cpu")


def test_trainer_restore_params_only_and_mismatch(tiny, tmp_path):
    tr = _trainer(tiny, tmp_path)
    tr.run(verbose=False)
    steps = ckpt.all_steps(tr._ckpt_dir())
    assert steps and ckpt.latest_step(tr._ckpt_dir("best")) is not None
    final = {k: v.clone() for k, v in tr.params().items()}
    count = tr.state.opt.count
    # bit for bit, with the Adam state
    fresh = _trainer(tiny, tmp_path)
    assert fresh.try_restore() == steps[-1]
    assert all(torch.equal(final[k], v) for k, v in fresh.params().items())
    assert fresh.state.opt.count == count > 0
    best = ckpt.all_steps(tr._ckpt_dir("best"))
    assert fresh._resume_step == max(steps + best) + 1
    # an optimizer state of another structure: the params alone come back
    d = tr._ckpt_dir()
    state = ckpt.restore_checkpoint_raw(d)
    state["opt_state"]["schedule_count"] = torch.tensor(7)
    ckpt.save_checkpoint(d, steps[-1] + 10, state)
    again = _trainer(tiny, tmp_path)
    assert again.try_restore() == steps[-1] + 10
    assert all(torch.equal(final[k], v) for k, v in again.params().items())
    assert again.state.opt.count == 0
    # a params mismatch raises
    wide = _trainer(tiny, tmp_path, hidden=16)
    with pytest.raises(ValueError):
        wide.try_restore()


def test_cli_train_resumes_past_every_saved_step(tiny, tmp_path, capsys):
    args = ["--datapath", tiny, "--out", str(tmp_path / "out"), "--model_root",
            str(tmp_path / "model"), "--num_instances", "4", "--batch", "6",
            "--memory_size", "32", "--epochs", "1", "--best_window", "2",
            "--arrival_scale", "0.15", "--dtype", "float64", "--seed", "3",
            "--training_set", "TEST", "--device", "cpu"]
    path = cli_train.main(args)
    first = read_rows(path)
    assert os.path.basename(path) == (
        "aco_training_data_aco_data_ba_tiny_load_0.15_T_1000.csv")
    assert sorted({int(r["fid"]) for r in first}) == [0, 1, 2, 3]
    model_dir = Config(model_root=str(tmp_path / "model"), training_set="TEST").model_dir()
    saved = ckpt.all_steps(os.path.join(model_dir, "torch")) + ckpt.all_steps(
        os.path.join(model_dir, "torch_best"))
    latest = ckpt.latest_step(os.path.join(model_dir, "torch"))
    capsys.readouterr()
    second = read_rows(cli_train.main(args + ["--files_limit", "2"]))
    assert f"resumed from torch step {latest}\n" in capsys.readouterr().out
    nxt = max(saved) + 1
    assert sorted({int(r["fid"]) for r in second}) == [nxt, nxt + 1]


def test_a_new_trainer_numbers_its_visits_past_saved_steps(tiny, tmp_path):
    """A Trainer built on a model directory that already holds steps, with
    no restore, starts its visit counter past them, so no save meets an
    existing step; in a fresh directory it starts at 0, as in JAX."""
    first = _trainer(tiny, tmp_path)
    assert first._resume_step == 0
    first.run(verbose=False)
    saved = ckpt.all_steps(first._ckpt_dir()) + ckpt.all_steps(first._ckpt_dir("best"))
    second = _trainer(tiny, tmp_path)
    assert second._resume_step == max(saved) + 1
    rows = read_rows(second.run(verbose=False, out_dir=str(tmp_path / "second")))
    assert min(int(r["fid"]) for r in rows) == max(saved) + 1
    assert ckpt.latest_step(second._ckpt_dir()) > max(saved)


def test_run_log_step_events_carry_the_step_stats(tiny, tmp_path):
    log_path = str(tmp_path / "run.jsonl")
    tr = _trainer(tiny, tmp_path, obs_log=log_path)
    seen, inner = [], tr._train_step

    def capture(*a, **k):
        seen.append(inner(*a, **k))
        return seen[-1]

    tr._train_step = capture
    tr.run(verbose=False)
    steps = [e for e in read_events(log_path) if e.get("event") == "step"]
    assert len(steps) == len(seen) == 4
    for e, outs in zip(steps, seen):
        lc, lm = outs.loss_critic.float(), outs.loss_mse.float()
        np.testing.assert_allclose(e["grad_norm"], episode_grad_norms(outs.grads).numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            [e["loss_critic_sum"], e["loss_critic_sq_sum"], e["loss_mse_sum"]],
            [float(lc.sum()), float((lc * lc).sum()), float(lm.sum())], rtol=1e-6)
        assert e["nonfinite"] == 0 and len(e["grad_norm"]) == len(lc)
