"""PyTorch port, `mho-serve`'s process wiring on the CPU.

- `GracefulDrain`: `request()`, a real SIGTERM raised in the main thread
  (the JAX class in the same steps reaches the same state), the previous
  handler restored, and a second signal that kills a child process;
- `restore_verified`, `quarantine_step`, `has_verified` and
  `gc_checkpoints` on truncated and bit-flipped steps, each scenario run
  on the JAX package's orbax checkpoints and on the port's, with the same
  step restored, the same steps quarantined and left, and the same
  counters;
- `OffloadService.hot_reload` from the port's ``torch/`` checkpoints: a
  swap between ticks serves exactly what a fresh service built on the new
  checkpoint serves; a wrong shape raises ValueError; NaN weights are
  refused with `mho_canary_rejections_total` and a `canary_reject` event;
  a truncated newest step is quarantined while the last good one serves;
- `prob=True`: each request's answer is the same alone, among 8, in
  another order and at another ladder width, and differs from the greedy
  answer somewhere;
- the CLI as an operator runs it (a subprocess on the CPU): it loads step
  1, hot-reloads step 2 placed while it serves, quarantines a truncated
  step 3, and on SIGTERM answers every admitted request exactly once
  (the run log's `submit` and `decision` hops), records `shutdown` with
  the unserved count, seals the run log terminally and writes the
  Prometheus file.  Its run log holds the event types of the JAX serve
  CLI's log, less those only JAX's `prof` / `memwatch` emit (both sets
  listed below, the JAX set read from a JAX CLI run).
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from multihop_offload_tpu.chaos import faults
from multihop_offload_tpu.obs.registry import registry as jregistry
from multihop_offload_tpu.train import checkpoints as jckpt
from multihop_offload_tpu.utils.signals import GracefulDrain as JDrain
from multihop_offload_tpu_torch.cli import serve as tcli
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.obs import events as tevents
from multihop_offload_tpu_torch.obs.registry import registry as tregistry
from multihop_offload_tpu_torch.serve import workload as twork
from multihop_offload_tpu_torch.train import checkpoints as tckpt
from multihop_offload_tpu_torch.utils.signals import GracefulDrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "SCRATCH800_decay0.99"
SIZES = [10, 16]

# the event types of the JAX serve CLI's run log: what a plain run emits
# (checked against a JAX run below) and what its hot reload, quarantine
# and drain paths emit (`serve/service.py:657`, `train/checkpoints.py:
# quarantine_step`, `cli/serve.py:177`)
JAX_PLAIN_EVENTS = {"manifest", "trace", "tick", "program", "summary"}
JAX_SERVE_EVENTS = JAX_PLAIN_EVENTS | {"hot_reload", "ckpt_quarantine", "shutdown"}
# what the port's serve CLI does not emit on the CPU: `prof_capture` (only
# on an SLO breach with a capture attached) and `watermark` (the CPU has no
# allocator stats, as JAX's CPU backend); `program` it emits since the prof
# layer was ported
JAX_ONLY_EVENTS = {"prof_capture", "watermark"}


# ---- GracefulDrain ----------------------------------------------------------


def test_graceful_drain_request_and_signal_like_jax():
    for cls in (GracefulDrain, JDrain):
        d = cls()
        assert not d.requested and d.signum is None
        d.request()
        assert d.requested and d.signum == signal.SIGTERM
    prev = signal.getsignal(signal.SIGTERM)
    states = []
    for cls in (GracefulDrain, JDrain):
        d = cls().install()
        try:
            signal.raise_signal(signal.SIGTERM)
            states.append((d.requested, d.signum))
        finally:
            d.uninstall()
        assert signal.getsignal(signal.SIGTERM) is prev
    assert states == [(True, int(signal.SIGTERM))] * 2


def test_graceful_drain_second_signal_kills():
    code = ("import signal, time\n"
            "from multihop_offload_tpu_torch.utils.signals import GracefulDrain\n"
            "d = GracefulDrain().install()\n"
            "signal.raise_signal(signal.SIGINT)\n"
            "assert d.requested and d.signum == signal.SIGINT\n"
            "print('drain requested', flush=True)\n"
            "signal.raise_signal(signal.SIGTERM)\n"
            "time.sleep(5)\n"
            "print('survived')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60, env=dict(os.environ, PYTHONPATH=ROOT))
    assert "drain requested" in out.stdout and "survived" not in out.stdout
    assert out.returncode == -signal.SIGTERM


# ---- verified restore and quarantine, JAX against the port ------------------


def _scenario(lib, directory: str, corrupt: str, steps=(1, 2), bad=(2,), pinned=None):
    """Save `steps`, corrupt the files of the steps in `bad` (`truncate`
    or `flip`), then restore_verified; returns what a caller can see."""
    for s in steps:
        lib.save_checkpoint(directory, s, {"params": {"w": np.full((4,), float(s),
                                                                   np.float32)}},
                            lineage=lib.make_lineage("offline"))
    before = [lib.has_verified(directory, s) for s in steps]
    for s in bad:
        for root, _, files in os.walk(os.path.join(directory, str(s))):
            for f in sorted(files):
                p = os.path.join(root, f)
                if os.path.getsize(p):
                    if corrupt == "truncate":
                        faults.truncate_file(p, keep_fraction=0.5)
                    else:
                        faults.bit_flip_file(p, seed=3, flips=32)
    after = [lib.has_verified(directory, s) for s in steps]
    state, step = lib.restore_verified(directory, step=pinned)
    w = None if state is None else float(np.asarray(state["params"]["w"])[0])
    qdir = os.path.join(directory, "quarantine")
    quarantined = sorted(os.listdir(qdir)) if os.path.isdir(qdir) else []
    return {"before": before, "after": after, "step": step, "w": w,
            "quarantined": quarantined, "left": lib.all_steps(directory)}


@pytest.mark.parametrize("corrupt,bad,pinned", [
    ("truncate", (2,), None), ("flip", (2,), None), ("truncate", (1, 2), None),
    ("flip", (1, 2), None), ("truncate", (2,), 1)])
def test_restore_verified_quarantines_like_jax(tmp_path, corrupt, bad, pinned):
    jregistry().reset()
    tregistry().reset()
    want = _scenario(jckpt, str(tmp_path / "orbax"), corrupt, bad=bad, pinned=pinned)
    got = _scenario(tckpt, str(tmp_path / "torch"), corrupt, bad=bad, pinned=pinned)
    assert got == want
    for reg in (jregistry(), tregistry()):
        assert reg.counter("mho_ckpt_quarantined_total").total() == len(want["quarantined"])


def test_gc_checkpoints_like_jax(tmp_path):
    jregistry().reset()
    tregistry().reset()
    out = []
    for lib, d in ((jckpt, str(tmp_path / "orbax")), (tckpt, str(tmp_path / "torch"))):
        for s in (4, 5, 6):
            lib.save_checkpoint(d, s, {"params": {"w": np.zeros(2, np.float32)}},
                                lineage=lib.make_lineage("offline"))
        out.append((lib.gc_checkpoints(d, keep=1), lib.all_steps(d),
                    lib.load_integrity(d, 4), lib.load_integrity(d, 6) is not None))
    assert out[0] == out[1] == ([4, 5], [6], None, True)
    assert jregistry().counter("mho_ckpt_gc_total").total() == \
        tregistry().counter("mho_ckpt_gc_total").total() == 2


# ---- hot reload in the service -----------------------------------------------


def _service(root: str, **kw):
    kw = {"seed": 3, "serve_slots": 4, **kw}
    cfg = Config(serve_deadline_s=60.0, serve_model=MODEL, model_root=root, **kw)
    pool = twork.case_pool(SIZES, per_size=1, seed=0)
    svc, _ = tcli.build_service(cfg, pool=pool, device="cpu")
    return cfg, svc, pool


def _requests(pool, n, seed=1):
    return list(twork.request_stream(pool, n, seed=seed, arrival_scale=0.15))


def _serve(svc, reqs) -> dict:
    out = {}
    for r in reqs:
        assert svc.submit(r)
    for resp in svc.drain():
        assert resp.request_id not in out
        out[resp.request_id] = resp
    assert sorted(out) == sorted(r.request_id for r in reqs)
    return out


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for rid in a:
        for f in ("dst", "is_local", "delay_est", "job_total"):
            np.testing.assert_array_equal(getattr(a[rid], f), getattr(b[rid], f),
                                          err_msg=f"request {rid} {f}")
        assert a[rid].served_by == b[rid].served_by and a[rid].bucket == b[rid].bucket


def _save(directory: str, step: int, params: dict) -> None:
    tckpt.save_checkpoint(directory, step, {"params": params, "step": step},
                          lineage=tckpt.make_lineage("offline"))


def test_hot_reload_swaps_between_ticks_like_a_fresh_service(tmp_path):
    tregistry().reset()
    log_path = str(tmp_path / "run.jsonl")
    log = tevents.RunLog(log_path)
    tevents.set_run_log(log)
    try:
        cfg, svc, pool = _service(str(tmp_path))
        assert svc.executor.loaded_step is None  # no checkpoint yet
        reqs = _requests(pool, 12)
        base = _serve(svc, reqs[:4])
        params = {k: v.clone() * 1.5 for k, v in svc.executor.model.state_dict().items()}
        directory = os.path.join(cfg.model_dir(), "torch")
        _save(directory, 1, params)
        assert svc.hot_reload(cfg.model_dir()) == 1
        assert svc.hot_reload(cfg.model_dir()) is None  # already current
        assert svc.executor.loaded_lineage["source"] == "offline"
        swapped = _serve(svc, reqs[4:])
        _, fresh, _ = _service(str(tmp_path))  # loads step 1 at build
        assert fresh.executor.loaded_step == 1
        _same(swapped, _serve(fresh, reqs[4:]))
        # a service on the committed weights serves what `svc` served
        # before the swap, and not what it serves after
        _, plain, _ = _service(str(tmp_path / "empty"))
        _same(base, _serve(plain, reqs[:4]))
        unswapped = _serve(plain, reqs[4:])
        assert any((unswapped[k].delay_est != swapped[k].delay_est).any() for k in swapped)
        # a truncated newest step: quarantined, step 1 keeps serving
        stage = str(tmp_path / "stage")
        _save(stage, 2, params)
        faults.truncate_file(os.path.join(stage, "2", tckpt.STATE_FILE), 0.5)
        shutil.copy(os.path.join(stage, "integrity", "2.json"),
                    os.path.join(directory, "integrity", "2.json"))
        os.replace(os.path.join(stage, "2"), os.path.join(directory, "2"))
        assert svc.hot_reload(cfg.model_dir()) is None
        assert svc.executor.loaded_step == 1 and tckpt.all_steps(directory) == [1]
        assert os.listdir(os.path.join(directory, "quarantine")) == ["2"]
    finally:
        tevents.set_run_log(None)
        log.close()
    events = list(tevents.read_events(log_path))
    assert [e["step"] for e in events if e["event"] == "hot_reload"] == [1, 1]
    assert [e["step"] for e in events if e["event"] == "ckpt_quarantine"] == [2]
    assert tregistry().counter("mho_serve_hot_reloads_total").total() == 2


def test_hot_reload_refuses_wrong_shape_and_nonfinite(tmp_path):
    tregistry().reset()
    log_path = str(tmp_path / "run.jsonl")
    log = tevents.RunLog(log_path)
    tevents.set_run_log(log)
    try:
        cfg, svc, pool = _service(str(tmp_path))
        live = svc.executor.model.state_dict()
        directory = os.path.join(cfg.model_dir(), "torch")
        nan = {k: v.clone() for k, v in live.items()}
        nan["layers.1.kernel"][0, 0] = float("nan")
        _save(directory, 1, nan)
        reqs = _requests(pool, 4)
        before = _serve(svc, reqs)
        assert svc.hot_reload(cfg.model_dir()) is None
        assert svc.hot_reload(cfg.model_dir()) is None  # refused once, not retried
        assert svc.executor.loaded_step is None
        _same(before, _serve(svc, reqs))
        assert tregistry().counter("mho_canary_rejections_total").value(
            stage="hot_reload", reason="nonfinite_weights") == 1
        wrong = {k: v.clone() for k, v in live.items()}
        wrong["layers.0.kernel"] = torch.zeros(3, 3)
        _save(directory, 2, wrong)
        with pytest.raises(ValueError, match="architecture"):
            svc.hot_reload(cfg.model_dir())
    finally:
        tevents.set_run_log(None)
        log.close()
    rej = [e for e in tevents.read_events(log_path) if e["event"] == "canary_reject"]
    assert [(e["step"], e["stage"], e["reason"]) for e in rej] == \
        [(1, "hot_reload", "nonfinite_weights")]


# ---- prob=True ----------------------------------------------------------------


def test_prob_answers_do_not_depend_on_batching(tmp_path):
    _, svc, pool = _service(str(tmp_path), prob=True, serve_slots=8)
    reqs = [r for r in _requests(pool, 40) if r.sizes[0] <= 10][:8]
    assert len(reqs) == 8
    together = _serve(svc, reqs)
    _, again, _ = _service(str(tmp_path), prob=True, serve_slots=8)
    _same(together, _serve(again, reqs[::-1]))
    alone = {}
    for r in reqs:
        _, one, _ = _service(str(tmp_path), prob=True, serve_slots=8)
        alone.update(_serve(one, [r]))
    _same(together, alone)
    # another ladder width: the occupancy ladder ticks a cold bucket narrower
    _, rag, _ = _service(str(tmp_path), prob=True, serve_slots=8, serve_ragged=True)
    _same(together, _serve(rag, reqs[:3]) | _serve(rag, reqs[3:]))
    # the draws matter: greedy decides differently somewhere
    _, greedy, _ = _service(str(tmp_path), serve_slots=8)
    g = _serve(greedy, reqs)
    assert any((g[k].dst != together[k].dst).any() for k in g)
    # a request's draws depend on (seed, request id) alone
    _, other, _ = _service(str(tmp_path), prob=True, serve_slots=8, seed=4)
    rid = reqs[0].request_id

    def draws(s, r):
        return torch.rand(8, generator=s.request_generator(r))

    assert torch.equal(draws(svc, rid), draws(again, rid))
    assert not torch.equal(draws(svc, rid), draws(other, rid))
    assert not torch.equal(draws(svc, rid), draws(svc, rid + 1))


# ---- the CLI as an operator runs it ----------------------------------------------


def _wait(path: str, pred, proc, timeout: float = 120.0) -> list:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        events = list(tevents.read_events(path))
        if pred(events):
            return events
        if proc.poll() is not None:
            raise AssertionError(f"serve exited early: {proc.communicate()}")
        time.sleep(0.05)
    proc.kill()
    raise AssertionError(f"timed out; last events {[e.get('event') for e in events][-10:]}")


def _steps(events, kind):
    return [e["step"] for e in events if e.get("event") == kind]


def _ticks_after(events, kind) -> int:
    names = [e.get("event") for e in events]
    return names[names.index(kind):].count("tick") if kind in names else 0


@pytest.fixture(scope="module")
def jax_plain_events(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_serve")
    log = str(d / "run.jsonl")
    out = subprocess.run(
        [sys.executable, "-m", "multihop_offload_tpu.cli.serve", "--serve_sizes=10,16",
         "--serve_slots=3", "--serve_requests=6", f"--obs_log={log}",
         f"--model_root={d / 'model'}"],
        cwd=str(d), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return {e["event"] for e in tevents.read_events(log)}


def test_cli_hot_reload_quarantine_and_sigterm_drain(tmp_path, jax_plain_events):
    assert jax_plain_events == JAX_PLAIN_EVENTS
    root = str(tmp_path / "model")
    cfg = Config(model_root=root)
    directory = os.path.join(cfg.model_dir(), "torch")
    from multihop_offload_tpu_torch.models.chebconv import load_model

    params = {k: v.clone() for k, v in load_model(MODEL, device="cpu").state_dict().items()}
    _save(directory, 1, params)
    log, prom = str(tmp_path / "serve.jsonl"), str(tmp_path / "serve.prom")
    n_req = 3000
    proc = subprocess.Popen(
        [sys.executable, "-m", "multihop_offload_tpu_torch.cli.serve", "--device", "cpu",
         "--serve_sizes=10,16", "--serve_slots=3", f"--serve_requests={n_req}",
         f"--serve_model={MODEL}", "--serve_deadline_s=60", f"--obs_log={log}",
         f"--obs_prom={prom}", f"--model_root={root}"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        _wait(log, lambda ev: sum(e.get("event") == "tick" for e in ev) >= 3, proc)
        _save(directory, 2, {k: v * 1.25 for k, v in params.items()})
        _wait(log, lambda ev: 2 in _steps(ev, "hot_reload"), proc)
        # step 3 is truncated before it is renamed into place
        stage = str(tmp_path / "stage")
        _save(stage, 3, params)
        faults.truncate_file(os.path.join(stage, "3", tckpt.STATE_FILE), 0.5)
        shutil.copy(os.path.join(stage, "integrity", "3.json"),
                    os.path.join(directory, "integrity", "3.json"))
        os.replace(os.path.join(stage, "3"), os.path.join(directory, "3"))
        _wait(log, lambda ev: 3 in _steps(ev, "ckpt_quarantine"), proc)
        _wait(log, lambda ev: _ticks_after(ev, "ckpt_quarantine") >= 2, proc)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    summary = json.loads(stdout[stdout.index("{"):])
    assert "checkpoint step 1" in stdout
    # sealed terminally: nothing left at the active path, the chain ends in
    # this run's summary
    assert not os.path.exists(log) and tevents.segment_paths(log)
    events = list(tevents.read_events(log))
    assert events[0]["event"] == "manifest" and events[0]["role"] == "serve"
    assert events[-1]["event"] == "summary"
    assert _steps(events, "hot_reload") == [1, 2]
    assert _steps(events, "ckpt_quarantine") == [3]
    shutdown = [e for e in events if e["event"] == "shutdown"]
    assert len(shutdown) == 1 and shutdown[0]["signum"] == signal.SIGTERM
    assert shutdown[0]["unserved"] > 0
    assert shutdown[0]["unserved"] == n_req - summary["admitted"] - \
        summary["rejected_too_large"] - summary["rejected_invalid"]
    # every admitted request answered exactly once
    hops = [e for e in events if e["event"] == "trace"]
    admitted = [r for e in hops if e["hop"] == "submit" for r in e["request_ids"]]
    answered = [r for e in hops if e["hop"] == "decision" for r in e["request_ids"]]
    assert len(answered) == len(set(answered)) == summary["served"]
    assert sorted(answered) == sorted(admitted) and len(admitted) == summary["admitted"]
    # step 2 served to the end: no dispatch after its reload ran on another step
    t2 = next(e["ts"] for e in events if e["event"] == "hot_reload" and e["step"] == 2)
    later = {e["step"] for e in hops if e["hop"] == "dispatch" and e["ts"] > t2}
    assert later == {2}
    assert tckpt.all_steps(directory) == [1, 2]
    assert os.listdir(os.path.join(directory, "quarantine")) == ["3"]
    text = open(prom).read()
    assert "mho_serve_hot_reloads_total 2" in text and "mho_ckpt_quarantined_total" in text
    types = {e["event"] for e in events}
    assert JAX_SERVE_EVENTS - JAX_ONLY_EVENTS <= types, types
