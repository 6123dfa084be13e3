"""PyTorch port, a data mesh across processes (`parallel/mesh.py`,
`parallel/data_parallel.py`, `multihost/runtime.py:all_reduce`), on the
CPU.  The counterpart of `tests/test_multiprocess.py`.

Two local processes join one gloo group (`bootstrap` from `worker_env`'s
environment) and lay a 4-slot `data` axis over their two CPU devices each
(`make_mesh(data=4, devices=[cpu] * 2, runtime=rt)`).  Each process passes
its OWN four episodes to `global_batch` and runs one `mean` step of
`make_dp_train_step` in float64:

* both processes report the same losses, job totals and new parameters,
  bit for bit (the gradients and metrics are summed by one all-reduce);
* those equal one process's four-shard step on the concatenated batch
  within 1e-12 (scaled), and JAX's `mean` step on four virtual devices
  within 1e-9, the bar `tests/test_torch_parallel.py` holds the one-process
  step to.

Each child has its own bring-up deadline and the test its own time limit
(under 60 s), so no test waits on a port forever.  A mesh whose graph row
would span processes, and the gather-type steps over a mesh that spans
processes, raise.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.agent import replay as jreplay
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.parallel import data_parallel as jdp
from multihop_offload_tpu.parallel import make_mesh as j_make_mesh
from multihop_offload_tpu_torch.agent import replay as treplay
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.multihost import runtime
from multihop_offload_tpu_torch.parallel import data_parallel as tdp
from multihop_offload_tpu_torch.parallel import make_mesh
from multihop_offload_tpu_torch.parallel.mesh import Mesh
from tests.test_torch_layouts import FP_FN, models, paired_batch, synthetic
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NETS = [(14, 1), (18, 2), (22, 3), (26, 4)]
LR = 1e-2

_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["MHO_REPO"])
import torch
from multihop_offload_tpu_torch._records import slice_records
from multihop_offload_tpu_torch.agent import replay
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models import chebconv
from multihop_offload_tpu_torch.multihost.runtime import bootstrap, shutdown
from multihop_offload_tpu_torch.parallel import global_batch, make_mesh
from multihop_offload_tpu_torch.parallel.data_parallel import make_dp_train_step

rt = bootstrap(timeout_s=30)
pid = rt.process_id
d = torch.load(os.path.join(os.environ["MHO_DIR"], "inputs.pt"), weights_only=False)
per = d["insts"].adj.shape[0] // rt.num_processes
# this process's OWN episodes: true data parallelism, not replicated work
insts = slice_records(d["insts"], pid * per, (pid + 1) * per)
jobs = slice_records(d["jobs"], pid * per, (pid + 1) * per)
mesh = make_mesh(data=4, devices=[torch.device("cpu")] * 2, runtime=rt)
assert mesh.shape == {"data": 4, "graph": 1} and mesh.spans_processes, mesh
assert mesh.local_rows == [2 * pid, 2 * pid + 1], mesh.local_rows
shards = global_batch(mesh, jobs)
assert [s.src.shape[0] for s in shards] == [per // 2] * 2
model = chebconv.ChebNet(num_layer=3, hidden=8, k=2, dtype=torch.float64)
model.load_state_dict(d["state"])
opt = replay.make_optimizer(Config(learning_rate=float(os.environ["MHO_LR"])))
state = opt.init({k: p.detach() for k, p in model.named_parameters()})
step = make_dp_train_step(model, opt, mesh, mode="mean")
params, state, metrics = step(model, state, insts, jobs, None, 0.0)
torch.save({"params": params, "metrics": metrics, "count": state.count},
           os.path.join(os.environ["MHO_DIR"], f"out{pid}.pt"))
print(f"PROC {pid} OK", flush=True)
shutdown()
"""


@pytest.fixture(scope="module")
def batch():
    bi, bj, ti, tj, pad = paired_batch([synthetic(n, s) for n, s in NETS], "dense",
                                       per_network=2, seed=4)
    jmodel, variables, tmodel = models(2, 3, 8, pad, "dense")
    return bi, bj, ti, tj, jmodel, variables, tmodel


def _run_children(tmp_path, timeout=55):
    env0 = {**os.environ, "MHO_REPO": ROOT, "MHO_DIR": str(tmp_path), "MHO_LR": str(LR)}
    coord = f"127.0.0.1:{runtime.free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD],
                              env=runtime.worker_env(coord, 2, i, base_env=env0),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"PROC {i} OK" in out, out[-3000:]
    return [torch.load(tmp_path / f"out{i}.pt", weights_only=False) for i in range(2)]


def _scaled(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def test_two_processes_share_one_mean_step(batch, tmp_path):
    bi, bj, ti, tj, jmodel, variables, tmodel = batch
    torch.save({"insts": ti, "jobs": tj, "state": tmodel.state_dict()},
               tmp_path / "inputs.pt")
    a, b = _run_children(tmp_path)
    # the same update and the same metrics on both processes, bit for bit
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for k in ("loss_critic", "loss_mse", "job_total"):
        assert torch.equal(a["metrics"][k], b["metrics"][k]), k
    assert a["count"] == b["count"] == 1

    # one process, four shards, the concatenated batch
    model = copy.deepcopy(tmodel)
    opt = treplay.make_optimizer(Config(learning_rate=LR))
    state = opt.init({k: p.detach() for k, p in model.named_parameters()})
    step = tdp.make_dp_train_step(model, opt, make_mesh(data=4, devices=[CPU] * 4))
    params, _, metrics = step(model, state, ti, tj, None, 0.0)
    for k, p in params.items():
        assert _scaled(a["params"][k], p) <= 1e-12, k
    for k in ("loss_critic", "loss_mse"):
        assert _scaled(a["metrics"][k], metrics[k]) <= 1e-12, k
    assert _scaled(a["metrics"]["job_total"], metrics["job_total"]) <= 1e-12

    # JAX's mean step on four virtual devices, the same batch and weights
    jopt = jreplay.make_optimizer(JConfig(learning_rate=LR))
    keys = jax.random.split(jax.random.PRNGKey(1), ti.adj.shape[0])
    jstep = jdp.make_dp_train_step(jmodel, jopt, j_make_mesh(data=4, graph=1,
                                                            devices=jax.devices()[:4]),
                                   mode="mean", fp_fn=FP_FN)
    v_j, _, m_j = jstep(variables, jopt.init(variables["params"]), bi, bj, keys,
                        jnp.asarray(0.0, jnp.float64))
    for k, p in a["params"].items():
        _, i, leaf = k.split(".")
        want = np.asarray(v_j["params"][f"cheb_{i}"][leaf])
        np.testing.assert_allclose(p.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max(), err_msg=k)
    np.testing.assert_allclose(float(a["metrics"]["loss_critic"]),
                               float(m_j["loss_critic"]), rtol=1e-9)
    np.testing.assert_allclose(a["metrics"]["job_total"].numpy(),
                               np.asarray(m_j["job_total"]), rtol=1e-9)


def test_spanning_meshes_refuse_what_they_cannot_do(batch):
    """A graph row may not cross processes; the gather-type steps refuse a
    mesh that spans processes; `all_reduce` outside a group is the tensor."""
    grid = np.empty((2, 2), dtype=object)
    grid[:] = [[CPU, CPU], [CPU, CPU]]
    with pytest.raises(ValueError, match="graph row of the mesh spans processes"):
        Mesh(grid, owners=np.array([[0, 1], [0, 1]]), process=0)
    grid = np.empty((4, 1), dtype=object)
    grid[:, 0] = [CPU] * 4
    mesh = Mesh(grid, owners=np.array([[0], [0], [1], [1]]), process=1)
    assert mesh.spans_processes and mesh.local_rows == [2, 3]
    assert mesh.data_devices() == [CPU, CPU]
    _, _, _, _, _, _, tmodel = batch
    opt = treplay.make_optimizer(Config())
    with pytest.raises(ValueError, match="spans processes"):
        tdp.make_dp_train_step(tmodel, opt, mesh, mode="replay")
    with pytest.raises(ValueError, match="spans processes"):
        tdp.make_dp_eval_step(tmodel, mesh)
    x = torch.arange(3.0)
    assert runtime.all_reduce(x) is x
    one = make_mesh(data=2, devices=[CPU] * 2)
    assert not one.spans_processes and one.local_rows == [0, 1]
