"""`mho-mesh` — serving across processes, provable on one machine.

Port of `multihop_offload_tpu/cli/mesh.py`:

    python -m multihop_offload_tpu_torch.cli.mesh --smoke [--device cpu] [--out PATH]

`--smoke` forms a real `torch.distributed` group (gloo, through
`multihost.runtime.bootstrap`) out of two local worker processes, each with
its own fleet of two devices (`[cpu] * 2` under `--device cpu`; otherwise
its share of the local cards, or `[cuda:0] * 2` on a machine with one
card), lays the buckets over the hosts with the two-level planner, serves
the same request streams on both sides of the process boundary, and checks
the claims the multihost layer makes:

  * more than one process served traffic, read off the federated
    `host=`-labelled `mho_serve_served_total` counters scraped from each
    worker's live Prometheus endpoint, not off the coordinator's books;
  * decisions are identical to the one-process path: every worker response
    is digested (dst, is_local, served_by) and compared with a one-process
    reference service fed the same stream;
  * kill a whole host: one worker is SIGKILLed mid-run, the planner
    re-plans by force, the survivor serves the victim's buckets with the
    same digests, and every request is conserved;
  * the open-loop bisection (`loadgen.search`) reports a finite sustained
    req/s at the p99 time-in-system SLO.

JAX's `zero_unexpected_retraces_after_recovery` is a compile property
(`obs/jaxhooks.py`); the port compiles nothing, and the record marks it not
applicable.  The record goes to `--out` (default `build/mesh_smoke.json`,
ignored by git).  On the card the coordinator builds every kernel once
before it spawns the workers.

Coordinator <-> worker protocol: JSON lines over the worker's stdin and
stdout, every protocol line prefixed `MHO-MESH ` so other output on stdout
cannot corrupt it.  Workers are `mho-mesh --worker` processes;
`multihost.runtime.worker_env` builds their environment.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

PREFIX = "MHO-MESH "
DEFAULT_OUT = os.path.join("build", "mesh_smoke.json")

# smoke geometry: 2 hosts x 2 devices, 2 buckets, 2 slots each: small
# enough to run in seconds, wide enough that both levels of the planner
# do real work
SMOKE_HOSTS = 2
SMOKE_LOCAL_DEVICES = 2
SMOKE_SEED = 17
WINDOW_1 = 32          # both hosts serving
WINDOW_2 = 24          # after the kill, survivors only
TICK_S = 0.02          # virtual tick interval for window serving
OPEN_LOOP_N = 120      # requests per bisection probe
OPEN_LOOP_SLO_P99_S = 0.25
GROUP_TIMEOUT_S = 60.0  # bring-up, and every collective of the group


def _smoke_config():
    """One Config for every process: the pool, the buckets and the seeded
    fresh-init weights (drawn on a CPU generator, then moved to the device)
    derive from it, so every process holds the same weights and streams."""
    from multihop_offload_tpu_torch.config import Config

    return Config(
        serve_sizes="10,14", serve_buckets=2, serve_slots=2,
        serve_queue_cap=64, serve_deadline_s=60.0,
        serve_replan_ticks=10**9,  # placement is injected, never self-replanned
        seed=SMOKE_SEED,
    )


def _smoke_requests(pool, count: int):
    """The canonical request stream: identical in every process."""
    from multihop_offload_tpu_torch.serve.workload import request_stream

    return list(request_stream(pool, count, seed=SMOKE_SEED))


def _digest(resp) -> str:
    """Decision identity: destination nodes, local/offload flags and which
    path answered.  The float delay estimates are left out: the decision
    is the contract."""
    import numpy as np

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(resp.dst).tobytes())
    h.update(np.ascontiguousarray(resp.is_local).tobytes())
    h.update(resp.served_by.encode())
    return h.hexdigest()[:16]


def _serve_window(service, requests, indices, clock,
                  tick_s: float = TICK_S) -> Dict[str, object]:
    """Submit `requests[i] for i in indices` on the virtual clock, tick to
    completion, return per-request digests and accounting."""
    admitted = 0
    responses = []
    t = clock.now()
    for i in indices:
        t += 0.005
        clock.seek(t)
        if service.submit(requests[i], now=t):
            admitted += 1
    for _ in range(2000):
        if len(responses) >= admitted:
            break
        t += tick_s
        clock.seek(t)
        responses.extend(service.tick(now=t))
    return {
        "offered": len(indices),
        "admitted": admitted,
        "served": len(responses),
        "degraded": sum(1 for r in responses if r.served_by != "gnn"),
        "digests": {str(r.request_id): _digest(r) for r in responses},
    }


def _local_fleet(process_id: int, num_processes: int, device: Optional[str]) -> list:
    """This worker's serving fleet: `[cpu] * 2` when the CPU was asked for;
    else its share of the local cards, each of its two members on a card of
    the share (`[cuda:0] * 2` on a machine with one card)."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * SMOKE_LOCAL_DEVICES
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("mho-mesh: CUDA is not available; pass --device cpu")
    lo, hi = process_id * n // num_processes, (process_id + 1) * n // num_processes
    share = list(range(lo, hi)) or [process_id % n]
    return [torch.device("cuda", share[i % len(share)])
            for i in range(SMOKE_LOCAL_DEVICES)]


# --------------------------------------------------------------------------
# worker
# --------------------------------------------------------------------------

def _send(obj: dict) -> None:
    print(PREFIX + json.dumps(obj), flush=True)


def run_worker(device: Optional[str]) -> int:
    """One mesh process: join the group, serve its buckets on its local
    fleet, answer the coordinator's protocol commands."""
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.loadgen.driver import VirtualClock
    from multihop_offload_tpu_torch.multihost import runtime
    from multihop_offload_tpu_torch.multihost.federation import MetricsEndpoint
    from multihop_offload_tpu_torch.multihost.plan import TwoLevelPlan, local_placement

    rt = runtime.bootstrap(timeout_s=GROUP_TIMEOUT_S)
    fleet = _local_fleet(rt.process_id, rt.num_processes, device)
    # every process's fleet size, exchanged over the group
    sizes = runtime.exchange(len(fleet))
    clock = VirtualClock()
    cfg = _smoke_config()
    service, pool = build_service(cfg, clock=clock, devices=fleet, load_checkpoint=False)
    requests = None  # built lazily: the pool is cheap, requests less so
    endpoint = MetricsEndpoint()
    first = sum(sizes[:rt.process_id])
    _send({"event": "ready", "host": rt.host,
           "process_id": rt.process_id,
           "num_processes": rt.num_processes,
           "metrics_url": endpoint.url,
           # the host's devices by global id (process by process)
           "local_devices": list(range(first, first + len(fleet))),
           "fleet": [str(d) for d in fleet],
           "global_devices": sum(sizes),
           "pid": os.getpid()})
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        cmd = json.loads(line)
        if cmd["cmd"] == "place":
            desc = cmd["plan"]
            n = len(desc)
            plan = TwoLevelPlan(
                hosts=tuple(desc[str(b)]["host"] for b in range(n)),
                devices=tuple(tuple(desc[str(b)]["devices"]) for b in range(n)),
            )
            # the plan's devices, position for position, as fleet indices
            service.executor.set_placement(
                local_placement(plan, rt.host, list(range(len(fleet)))))
            _send({"event": "placed", "host": rt.host,
                   "owned": plan.buckets_on_host(rt.host)})
        elif cmd["cmd"] == "serve":
            if requests is None or len(requests) < int(cmd["total"]):
                requests = _smoke_requests(pool, int(cmd["total"]))
            out = _serve_window(service, requests, cmd["indices"], clock)
            out.update({"event": "served", "host": rt.host,
                        "devices_used": service.executor.last_devices_used})
            _send(out)
        elif cmd["cmd"] == "stop":
            _send({"event": "bye", "host": rt.host})
            break
    endpoint.close()
    # a peer may be dead (the kill drill): leave the group within a limit
    runtime.shutdown(timeout_s=10.0)
    return 0


# --------------------------------------------------------------------------
# coordinator
# --------------------------------------------------------------------------

class _Worker:
    """One spawned worker: its process and a reader thread that filters
    protocol lines into a queue (a slow or chatty worker can never block or
    corrupt the coordinator)."""

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc
        self.lines: "queue.Queue[dict]" = queue.Queue()
        self.stderr_tail: List[str] = []
        threading.Thread(target=self._read_stdout, daemon=True).start()
        threading.Thread(target=self._read_stderr, daemon=True).start()

    def _read_stdout(self):
        for line in self.proc.stdout:
            if line.startswith(PREFIX):
                try:
                    self.lines.put(json.loads(line[len(PREFIX):]))
                except json.JSONDecodeError:
                    pass

    def _read_stderr(self):
        for line in self.proc.stderr:
            self.stderr_tail.append(line.rstrip())
            del self.stderr_tail[:-40]

    def recv(self, timeout_s: float) -> dict:
        try:
            return self.lines.get(timeout=timeout_s)
        except queue.Empty:
            tail = "\n".join(self.stderr_tail[-12:])
            raise TimeoutError(
                f"worker pid {self.proc.pid} silent for {timeout_s}s; "
                f"stderr tail:\n{tail}"
            )

    def send(self, obj: dict) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def kill_hard(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=10)

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                self.send({"cmd": "stop"})
                self.proc.wait(timeout=30)
            except Exception:
                self.proc.kill()
                self.proc.wait(timeout=10)


def _spawn_workers(num_hosts: int, device: Optional[str]) -> List[_Worker]:
    from multihop_offload_tpu_torch.multihost.runtime import free_port, worker_env

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    coordinator = f"127.0.0.1:{free_port()}"
    workers = []
    for pid in range(num_hosts):
        env = worker_env(coordinator, num_hosts, pid)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        argv = [sys.executable, "-m", "multihop_offload_tpu_torch.cli.mesh", "--worker"]
        if device is not None:
            argv += ["--device", str(device)]
        proc = subprocess.Popen(
            argv, env=env, cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        workers.append(_Worker(proc))
    return workers


def _check(record: dict, name: str, ok: bool, detail: str = "") -> bool:
    record["checks"][name] = {"ok": bool(ok), **({"detail": detail} if detail else {})}
    print(f"  [{'ok' if ok else 'FAIL'}] {name}" + (f" — {detail}" if detail else ""))
    return bool(ok)


def run_smoke(out_path: str, device: Optional[str] = None) -> int:
    import torch

    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.loadgen import (
        VirtualClock, arrival_times, max_sustained_rate, poisson,
        run_open_loop,
    )
    from multihop_offload_tpu_torch.multihost.federation import FleetFederation
    from multihop_offload_tpu_torch.multihost.plan import TwoLevelPlanner

    t_wall = time.monotonic()
    cpu = device is not None and torch.device(device).type == "cpu"
    record: dict = {
        "schema": 1,
        "mode": "cpu_two_local_processes" if cpu else "cuda_two_local_processes",
        "hosts": SMOKE_HOSTS,
        "local_devices_per_host": SMOKE_LOCAL_DEVICES,
        "checks": {},
    }
    if not cpu:
        from multihop_offload_tpu_torch.ops import _build

        _build.build_all()  # once here, not in every worker
    ok = True
    workers: List[_Worker] = []
    try:
        # --- bring-up ---------------------------------------------------
        print(f"mesh smoke: spawning {SMOKE_HOSTS} workers "
              f"({SMOKE_LOCAL_DEVICES} devices each)...")
        workers = _spawn_workers(SMOKE_HOSTS, device)
        ready = [w.recv(timeout_s=120.0) for w in workers]
        by_host = {r["host"]: w for r, w in zip(ready, workers)}
        host_table = {r["host"]: r["local_devices"] for r in ready}
        record["bring_up"] = {r["host"]: r for r in ready}
        ok &= _check(
            record, "process_group_formed",
            all(r["num_processes"] == SMOKE_HOSTS for r in ready)
            and all(r["global_devices"]
                    == SMOKE_HOSTS * SMOKE_LOCAL_DEVICES for r in ready),
            f"{len(ready)} processes, "
            f"{ready[0]['global_devices']} global devices",
        )

        # --- two-level placement ----------------------------------------
        cfg = _smoke_config()
        planner = TwoLevelPlanner(cfg.serve_buckets, host_table,
                                  cfg.serve_slots)
        planner.observe([3.0, 2.0])   # distinct rates: deterministic split
        plan = planner.replan()
        record["plan"] = plan.describe()
        hosts_used = set(plan.hosts)
        ok &= _check(record, "plan_spans_hosts", len(hosts_used) > 1,
                     f"buckets over hosts {sorted(hosts_used)}")
        for w in workers:
            w.send({"cmd": "place", "plan": plan.describe()})
        for w in workers:
            w.recv(timeout_s=60.0)

        # --- one-process reference (this process, one device) ------------
        print("building the one-process reference service...")
        clock = VirtualClock()
        ref_service, pool = build_service(cfg, clock=clock, device=device,
                                          load_checkpoint=False)
        total = WINDOW_1 + WINDOW_2
        requests = _smoke_requests(pool, total)
        ref_w1 = _serve_window(ref_service, requests,
                               list(range(WINDOW_1)), clock)
        bucket_of = {
            i: ref_service.buckets.bucket_for(*requests[i].sizes)
            for i in range(total)
        }

        # --- window 1: both hosts serve their own buckets ----------------
        owned = {
            h: [i for i in range(WINDOW_1)
                if plan.host_of(bucket_of[i]) == h]
            for h in host_table
        }
        replies = {}
        for h, w in by_host.items():
            w.send({"cmd": "serve", "indices": owned[h], "total": total})
        for h, w in by_host.items():
            replies[h] = w.recv(timeout_s=120.0)
        record["window_1"] = {
            h: {k: r[k] for k in
                ("offered", "admitted", "served", "degraded", "devices_used")}
            for h, r in replies.items()
        }
        served_hosts = [h for h, r in replies.items() if r["served"] > 0]
        ok &= _check(record, "multi_process_served",
                     len(served_hosts) > 1,
                     f"hosts serving: {sorted(served_hosts)}")
        mesh_digests = {}
        for r in replies.values():
            mesh_digests.update(r["digests"])
        mismatch = [i for i in map(str, range(WINDOW_1))
                    if mesh_digests.get(i) != ref_w1["digests"].get(i)]
        ok &= _check(record, "decisions_bit_identical_w1", not mismatch,
                     f"{WINDOW_1 - len(mismatch)}/{WINDOW_1} digests match")
        ok &= _check(
            record, "conservation_w1",
            sum(r["served"] for r in replies.values()) == WINDOW_1
            and ref_w1["served"] == WINDOW_1,
            f"mesh {sum(r['served'] for r in replies.values())}"
            f"/{WINDOW_1}, ref {ref_w1['served']}/{WINDOW_1}",
        )

        # --- federation: fleet-wide host-labelled series ----------------
        fed = FleetFederation(
            {r["host"]: r["metrics_url"] for r in ready})
        fed.scrape()
        served_by_host = {
            h: fed.registry.counter("mho_serve_served_total").total(host=h)
            for h in host_table
        }
        record["federation"] = {"served_by_host": served_by_host}
        ok &= _check(
            record, "federated_counters_span_hosts",
            sum(1 for v in served_by_host.values() if v > 0) > 1,
            f"mho_serve_served_total by host: {served_by_host}",
        )

        # --- kill a whole host ------------------------------------------
        victim = max(host_table)          # never process 0: it holds the
        survivor_hosts = sorted(set(host_table) - {victim})  # group's store
        print(f"killing {victim} (SIGKILL), replanning onto "
              f"{survivor_hosts}...")
        by_host[victim].kill_hard()
        plan2 = planner.remove_host(victim)
        record["plan_after_loss"] = plan2.describe()
        ok &= _check(
            record, "forced_replan_excludes_victim",
            victim not in set(plan2.hosts),
            f"buckets now on {sorted(set(plan2.hosts))}",
        )
        scrape2 = fed.scrape()
        up_victim = fed.registry.gauge("mho_mesh_host_up").value(host=victim)
        ok &= _check(
            record, "federation_marks_victim_down",
            scrape2.get(victim) is False and up_victim == 0.0,
            f"host_up{{{victim}}}={up_victim}",
        )
        for h in survivor_hosts:
            by_host[h].send({"cmd": "place", "plan": plan2.describe()})
        for h in survivor_hosts:
            by_host[h].recv(timeout_s=60.0)
        w2_ids = list(range(WINDOW_1, total))
        ref_w2 = _serve_window(ref_service, requests, w2_ids, clock)
        owned2 = {
            h: [i for i in w2_ids if plan2.host_of(bucket_of[i]) == h]
            for h in survivor_hosts
        }
        replies2 = {}
        for h in survivor_hosts:
            by_host[h].send({"cmd": "serve", "indices": owned2[h],
                             "total": total})
        for h in survivor_hosts:
            replies2[h] = by_host[h].recv(timeout_s=120.0)
        record["window_2"] = {
            h: {k: r[k] for k in
                ("offered", "admitted", "served", "degraded", "devices_used")}
            for h, r in replies2.items()
        }
        mesh2 = {}
        for r in replies2.values():
            mesh2.update(r["digests"])
        mismatch2 = [str(i) for i in w2_ids
                     if mesh2.get(str(i)) != ref_w2["digests"].get(str(i))]
        ok &= _check(record, "decisions_bit_identical_after_takeover",
                     not mismatch2,
                     f"{len(w2_ids) - len(mismatch2)}/{len(w2_ids)} "
                     "digests match")
        ok &= _check(
            record, "conservation_after_takeover",
            sum(r["served"] for r in replies2.values()) == WINDOW_2,
            f"{sum(r['served'] for r in replies2.values())}/{WINDOW_2} "
            "served by survivors",
        )
        record["checks"]["zero_unexpected_retraces_after_recovery"] = {
            "ok": None, "not_applicable": "a JAX compile property "
            "(obs/jaxhooks.py); the port runs eagerly and compiles nothing"}
        print("  [n/a] zero_unexpected_retraces_after_recovery — the port "
              "compiles nothing")

        # --- open-loop sustained-rate bisection -------------------------
        print("open-loop bisection for sustained req/s at p99 "
              f"<= {OPEN_LOOP_SLO_P99_S}s...")

        def probe(rate: float):
            span = OPEN_LOOP_N / rate
            ats = arrival_times(poisson(rate), span, seed=SMOKE_SEED)
            reqs = _smoke_requests(pool, len(ats))
            return run_open_loop(ref_service, reqs, ats, clock=clock,
                                 tick_interval_s=TICK_S, duration_s=span)

        result = max_sustained_rate(
            probe, lo_rps=10.0, p99_slo_s=OPEN_LOOP_SLO_P99_S,
            max_drop_fraction=0.01, iters=4, max_doublings=5,
        )
        record["open_loop"] = result.to_json()
        record["open_loop"]["note"] = (
            "per-host sustained rate on the reference service, virtual "
            "clock: capacity is structural (slots x buckets / tick), not "
            "host speed")
        finite = (result.sustained_rps > 0
                  and result.sustained_rps == result.sustained_rps)
        ok &= _check(
            record, "open_loop_sustained_finite", finite,
            f"sustained {result.sustained_rps:.1f} req/s at p99 <= "
            f"{OPEN_LOOP_SLO_P99_S}s ({len(result.probes)} probes)",
        )
    finally:
        for w in workers:
            try:
                w.stop()
            except Exception:
                pass

    record["elapsed_s"] = round(time.monotonic() - t_wall, 2)
    record["pass"] = bool(ok)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"mesh smoke: {'PASS' if ok else 'FAIL'} in "
          f"{record['elapsed_s']}s -> {out_path}")
    return 0 if ok else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="mho-mesh", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="two-local-process mesh drill")
    ap.add_argument("--worker", action="store_true",
                    help="internal: run as a spawned mesh worker")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: where every process serves")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"smoke record path (default {DEFAULT_OUT})")
    args = ap.parse_args(argv)
    if args.worker:
        return run_worker(args.device)
    if args.smoke:
        return run_smoke(args.out, args.device)
    ap.error("nothing to do: pass --smoke (or --worker, internal)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
