"""PyTorch port, `multihost/runtime.py`: the process group over
`torch.distributed` (gloo, TCP rendezvous), on the CPU.

* Two local processes bootstrap one group from `worker_env`'s environment
  and each evaluates its shard of the committed paper dataset's files
  (process p takes files p::2, as `scripts/multiprocess_eval.py` shards
  them): only process 0 writes its CSV, and with `csv_write_all_hosts`
  each writes JAX's CSV name in its own directory, the merged rows those
  of one process over all the files.
* A missing coordinator times out with JAX's error, after the retries.
* One process is a no-op; the environment's hints are read as JAX reads
  them (none or weak ones alone: no group; a named coordinator without a
  process count and index: the incomplete-spec error).

Each child process has its own bring-up deadline and the test its own
time limit, so no test waits on a port forever.
"""

import json
import os
import subprocess
import sys

import pytest

from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.multihost import runtime
from multihop_offload_tpu_torch.train import driver as td
from tests.test_torch_drivers import assert_rows_equal, read_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAPER = os.path.join(ROOT, "multihop_offload_tpu_torch", "data", "aco_data_ba_paper")
CSV_NAME = "Adhoc_test_data_aco_data_ba_paper_load_0.15_T_1000.csv"
FILES = 2

_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["MHO_REPO"])
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.multihost.runtime import bootstrap
from multihop_offload_tpu_torch.train.driver import Evaluator

rt = bootstrap(timeout_s=60)
cfg = Config(datapath=os.environ["MHO_DATA"], num_instances=2, arrival_scale=0.15, seed=7,
             out=os.path.join(os.environ["MHO_OUT"], f"proc{rt.process_id}"),
             model_root=os.path.join(os.environ["MHO_OUT"], "model"),
             csv_write_all_hosts=os.environ["MHO_ALL"] == "1")
ev = Evaluator(cfg, device="cpu")
csv = ev.run(file_ids=range(rt.process_id, int(os.environ["MHO_FILES"]), 2), verbose=False)
print("RESULT " + json.dumps({"describe": rt.describe(), "table": rt.host_table(),
                              "is_host0": ev.is_host0, "csv": csv}), flush=True)
"""

_MISSING = r"""
import os, sys
sys.path.insert(0, os.environ["MHO_REPO"])
from multihop_offload_tpu_torch.multihost.runtime import bootstrap

try:
    bootstrap(sys.argv[1], 2, 1, timeout_s=3.0, backoff_s=0.25)
except RuntimeError as e:
    print("ERROR " + str(e), flush=True)
"""


def _run(code, envs, timeout=240, args=()):
    procs = [subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for env in envs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _child_env(tmp_path, coordinator, p, all_hosts):
    env = runtime.worker_env(coordinator, 2, p)
    env.update(MHO_REPO=ROOT, MHO_DATA=PAPER, MHO_OUT=str(tmp_path), MHO_FILES=str(FILES),
               MHO_ALL="1" if all_hosts else "0", CUDA_VISIBLE_DEVICES="")
    return env


@pytest.mark.parametrize("all_hosts", [False, True])
def test_two_processes_bootstrap_and_only_host0_writes(tmp_path, all_hosts):
    coordinator = f"127.0.0.1:{runtime.free_port()}"
    outs = _run(_CHILD, [_child_env(tmp_path, coordinator, p, all_hosts) for p in range(2)])
    res = [json.loads(next(line for line in out.splitlines()
                           if line.startswith("RESULT "))[7:]) for out in outs]
    for p, r in enumerate(res):
        assert r["describe"] == {"host": f"host{p}", "process_id": p, "num_processes": 2,
                                 "coordinator": coordinator, "local_devices": [],
                                 "global_devices": 0}
        assert r["table"] == {"host0": [], "host1": []}
        assert r["is_host0"] == (p == 0)
        assert r["csv"] == os.path.join(str(tmp_path), f"proc{p}", CSV_NAME)
    assert os.path.isfile(res[0]["csv"])
    assert os.path.isfile(res[1]["csv"]) == all_hosts
    if all_hosts:
        # the shards' rows are those of one process over every file
        seq = td.Evaluator(Config(datapath=PAPER, num_instances=2, arrival_scale=0.15, seed=7,
                                  out=str(tmp_path / "seq"),
                                  model_root=str(tmp_path / "model")), device="cpu")
        want = read_rows(seq.run(files_limit=FILES, verbose=False))
        got = sorted(read_rows(res[0]["csv"]) + read_rows(res[1]["csv"]),
                     key=lambda r: [w["filename"] for w in want].index(r["filename"]))
        assert_rows_equal(got, want)


def test_missing_coordinator_times_out_with_jax_error():
    coordinator = f"127.0.0.1:{runtime.free_port()}"
    env = {**os.environ, "MHO_REPO": ROOT}
    (out,) = _run(_MISSING, [env], timeout=120, args=(coordinator,))
    msg = next(line for line in out.splitlines() if line.startswith("ERROR "))[6:]
    assert msg.startswith(f"mesh bootstrap: coordinator {coordinator} unreachable after ")
    assert msg.endswith("attempt(s) over 3s")


HINTS = (*runtime.STRONG_HINTS, "MASTER_PORT", "WORLD_SIZE", "RANK", "TPU_WORKER_HOSTNAMES",
         "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "SLURM_JOB_ID", "SLURM_NTASKS",
         "SLURM_NPROCS", "SLURM_PROCID", "CLOUD_TPU_TASK_ID", runtime.ENV_COORDINATOR,
         runtime.ENV_NUM_PROCESSES, runtime.ENV_PROCESS_ID)


def test_single_process_and_environment_hints(monkeypatch):
    for h in HINTS:
        monkeypatch.delenv(h, raising=False)
    assert runtime.init_distributed() == 0
    rt = runtime.bootstrap()
    assert (rt.process_id, rt.num_processes, rt.coordinator_address) == (0, 1, None)
    assert rt.host == "host0" and rt.is_coordinator
    # weak hints alone assemble no cluster: single process, as in JAX
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "localhost")
    monkeypatch.setenv("SLURM_JOB_ID", "7")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert runtime.init_distributed() == 0
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    monkeypatch.setenv("CLOUD_TPU_TASK_ID", "0")
    assert runtime.init_distributed() == 0
    # a named coordinator with no process count and index is misconfiguration
    monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="no process count and index"):
        runtime.init_distributed()
    monkeypatch.delenv("COORDINATOR_ADDRESS")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="MASTER_PORT"):
        runtime.init_distributed()
    # an incomplete explicit set is the same error
    with pytest.raises(ValueError, match="missing num_processes, process_id"):
        runtime.init_distributed("127.0.0.1:1")
    assert runtime.process_index() == 0 and runtime.process_count() == 1


def test_host_helpers():
    assert runtime.host_name(3) == "host3"
    port = runtime.free_port()
    assert isinstance(port, int) and 0 < port < 65536
    env = runtime.worker_env("127.0.0.1:5", 2, 1, base_env={"KEEP": "1"})
    assert env == {"KEEP": "1", runtime.ENV_COORDINATOR: "127.0.0.1:5",
                   runtime.ENV_NUM_PROCESSES: "2", runtime.ENV_PROCESS_ID: "1"}
    rt = runtime.MeshRuntime(process_id=1, num_processes=2, coordinator_address="c",
                             device_counts=(2, 1))
    assert rt.host_table() == {"host0": [0, 1], "host1": [2]}
    assert rt.describe()["global_devices"] == 3 and not rt.is_coordinator
