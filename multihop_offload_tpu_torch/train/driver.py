"""Training and evaluation drivers.

Port of `multihop_offload_tpu/train/driver.py` (`:53-1035`): the
(baseline, local, GNN) evaluation triple, the training step, and the
Trainer and Evaluator file loops that `cli/train.py` and `cli/test.py` run
(the reference's `AdHoc_train.py` / `AdHoc_test.py` workflow).  Per network
file, its `num_instances` job sets go through every method in one batched
call (the file's instance repeated along the batch axis), as the JAX
drivers vmap them.  Gradients are remembered in the same step; the replay
update is the only weight update.  The CSVs have the reference's schema
and the JAX column order (`TRAIN_COLUMNS`, `TEST_COLUMNS`), written with
the standard library's `csv`, NaN as an empty field as pandas writes it.

Draws: the numpy generators are the JAX drivers' (instances, job sets,
the epoch permutation, the fresh-init probes), in the same order.  The
JAX keys become torch generators: the harness's `gen` (the training
step's exploration and the replay's sampling) and, in the Evaluator, one
generator per file keyed on (seed, fid) in place of `_file_keys`.  So the
two packages agree at `explore=0`, `prob=False` with the replay indices
injected.  The `runtime` column is the wall time of a file's methods per
instance, net of the overlapped build of the next file, as in the JAX
drivers.

Both drivers take the APSP route of `cfg.apsp_impl` (JAX `:212-221`,
`ops.minplus.resolve_apsp`; `'xla'`, the default, squares at every N;
`self.apsp_path` names the path at the dataset's pad) and run under the
precision policy of `cfg.precision` (JAX `:107-115,219-221`): job sets stored at its `storage_dtype`, the model at
its dtypes, the APSP of every method in its compute dtype, and, in the
Trainer, `forward_backward` under it (K4's bf16 forward and transposed
walk, K6 or K2 in bf16, K1 on fp32 on the card) with parameters, stored
gradients, Adam moments and checkpoints in fp32 whatever the policy, so a
bf16 run resumes an fp32 checkpoint and the reverse.

A model directory that holds a `checkpoint` file is read as the
reference's TF-format weights (`models/tf_import.py`) in place of a fresh
init, as the JAX harness does (`:65-77`); a load error prints and falls
back to the fresh init, as there.

Data parallelism (JAX `:165-198`, `parallel/`): the drivers take `devices`
(None: every local CUDA device, or the one CPU device on the CPU; an
explicit list may repeat a device) and lay `cfg.mesh_data` of them (0:
all) out as a `data` mesh.  With more than one, the Trainer pads each
file's episodes to a multiple of the mesh and shards them, pads kept out
of the replay by `valid` (`:664-686`), and the Evaluator shards whole
files, `cfg.file_batch` a device (`:951-1010`).  `mesh_graph > 1` raises,
as in JAX.  Process 0 (`multihost.runtime.process_index`) writes the CSVs,
run logs and checkpoints; with `csv_write_all_hosts` every Evaluator
process writes its own CSV.

The rest of JAX's knobs: `cfg.fp_impl` picks the fixed-point core of
every method and of the training step (JAX `:222-227`,
`ops.fixed_point.resolve_fixed_point`; `self.fp_path` reports it); the
Trainer trains with `cfg.dropout` (JAX `:209,248`: each episode's masks
from its own stream, on one device and on the data mesh; evaluation stays
deterministic); its one-device step accumulates JAX's `DM_*` device
metrics (`agent.train_step.train_devmetrics`) and flushes them into
`last_devmetrics` at the step's sync (JAX `:230-271,706-710`; on the data
mesh they stay host-observed, as there); and `cfg.tb_logdir` gets the
replay loss, exploration and MSE loss as TensorBoard scalars from process
0 (`train.tb_logging.ScalarLogger`, JAX `:627,779-782`).
"""

from __future__ import annotations

import collections
import csv
import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from multihop_offload_tpu_torch import obs
from multihop_offload_tpu_torch._device import resolve_device, synchronize
from multihop_offload_tpu_torch._phases import phase
from multihop_offload_tpu_torch._records import cat_records, slice_records
from multihop_offload_tpu_torch.agent.actor import build_ext_features
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.agent.replay import (
    AdamState,
    GradReplay,
    adam_init,
    replay_apply,
    replay_init,
    replay_last,
    replay_remember,
)
from multihop_offload_tpu_torch.agent.train_step import (
    episode_grad_norms,
    forward_backward,
    step_devmetrics,
    train_devmetrics,
)
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.env.policies import baseline_policy, local_policy
from multihop_offload_tpu_torch.graphs.instance import stack_instances
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import SparseSupport
from multihop_offload_tpu_torch.models.chebconv import (
    ensure_alive_output_multi,
    make_model,
    params_from_jax,
)
from multihop_offload_tpu_torch.models.tf_import import load_reference_checkpoint
from multihop_offload_tpu_torch.multihost.runtime import local_devices, process_index
from multihop_offload_tpu_torch.ops.fixed_point import resolve_fixed_point
from multihop_offload_tpu_torch.ops.minplus import resolve_apsp
from multihop_offload_tpu_torch.obs import prof as obs_prof
from multihop_offload_tpu_torch.obs.spans import span
from multihop_offload_tpu_torch.parallel.data_parallel import (
    make_file_dp_train_step,
    make_files_eval_step,
    make_sharded_eval_step,
)
from multihop_offload_tpu_torch.parallel.mesh import canonical_device, make_mesh
from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib
from multihop_offload_tpu_torch.train.data import DatasetCache, sample_jobsets
from multihop_offload_tpu_torch.train.metrics import instance_metrics
from multihop_offload_tpu_torch.train.tb_logging import ScalarLogger
from multihop_offload_tpu_torch.utils.durable import atomic_write_json, load_json

TRAIN_COLUMNS = [
    "fid", "filename", "seed", "num_nodes", "m", "num_mobile", "num_servers",
    "num_relays", "num_jobs", "n_instance", "method", "runtime", "gap_2_bl",
    "gnn_bl_ratio", "tau", "congest_jobs",
]
TEST_COLUMNS = [
    "filename", "seed", "num_nodes", "m", "num_mobile", "num_servers",
    "num_relays", "num_jobs", "n_instance", "Algo", "runtime", "tau",
    "congest_jobs", "gnn_bl_ratio", "gap_2_bl",
]


@torch.no_grad()
def eval_methods(model, inst, jobs, gen=None, device=None, layout=None,
                 prob: bool = False, compat_diagonal_bug: bool = False,
                 precision=None, apsp_impl: str = "xla", fp_fn=None, support=None):
    """Per-job delays (B, J) of the baseline, local and GNN methods on a
    batch of requests, on `device` (default CUDA), under `layout` (default
    dense) and the `precision` policy's APSP (None: fp32) on the route of
    `apsp_impl` (`ops.minplus.resolve_apsp`).  The baseline
    and local methods are greedy; the GNN samples its decision when `prob`
    (draws from `gen`: a generator, or a list of them over equal shares of
    the batch) and reads the reference's cycled diagonal under
    `compat_diagonal_bug` (JAX `train/driver.py:283-303`).  `fp_fn` is
    every method's fixed-point core (`ops.fixed_point.resolve_fixed_point`;
    None: the layout's own); `support` replaces the GNN's default support."""
    dev = resolve_device(device)
    inst, jobs = inst.to(dev), jobs.to(dev)
    with phase("baseline"):
        bl = baseline_policy(inst, jobs, gen, layout=layout, precision=precision,
                             apsp_impl=apsp_impl, fp_fn=fp_fn).job_total
    with phase("local"):
        loc = local_policy(inst, jobs, layout=layout, fp_fn=fp_fn).job_total
    with phase("gnn"):
        gnn = forward_env(model, inst, jobs, gen, prob=prob,
                          compat_diagonal_bug=compat_diagonal_bug, device=dev,
                          layout=layout, precision=precision,
                          apsp_impl=apsp_impl, fp_fn=fp_fn, support=support)[0].job_total
    return bl, loc, gnn


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step besides the model."""

    opt: AdamState
    mem: GradReplay


@dataclasses.dataclass
class TrainReport:
    job_total: torch.Tensor    # (B, J) empirical delays of the episodes' decisions
    loss_critic: torch.Tensor  # (B,)
    loss_mse: torch.Tensor     # (B,)
    replayed: bool             # whether the replay update ran
    replay_loss: torch.Tensor  # () mean sampled critic loss (NaN if not replayed)
    skipped: int               # non-finite samples skipped by the replay


def train_init(model, cfg: Config, device=None) -> TrainState:
    """Adam state and an empty gradient replay for `model`, on `device`."""
    dev = resolve_device(device)
    params = {k: p.detach().to(dev) for k, p in model.named_parameters()}
    return TrainState(opt=adam_init(params), mem=replay_init(params, cfg.memory_size))


def train_forward(model, state: TrainState, inst, jobs, cfg: Config,
                  gen: torch.Generator | None = None, explore: float | None = None,
                  device=None, precision=None, fp_fn=None):
    """Batched `forward_backward` under `cfg.layout`, `cfg.apsp_impl` and the
    `precision` policy's APSP (None: fp32), with the fixed-point core
    `fp_fn` and, where `cfg.dropout > 0`, dropout masks drawn from `gen`,
    every episode's gradient remembered in `state.mem` (JAX
    `gnn_train_step`, `:243-279`).  Returns the step's `TrainStepOutput`."""
    dev = resolve_device(device)
    outs = forward_backward(
        model.to(dev), inst, jobs, gen,
        explore=cfg.explore if explore is None else explore, prob=cfg.prob,
        mse_weight=cfg.mse_weight, critic_weight=cfg.critic_weight, layout=cfg.layout,
        device=dev, compat_diagonal_bug=cfg.compat_diagonal_bug, precision=precision,
        apsp_impl=cfg.apsp_impl, fp_fn=fp_fn, dropout=cfg.dropout > 0)
    replay_remember(state.mem, outs.grads, outs.loss_critic, outs.loss_mse)
    return outs


def train_replay(model, state: TrainState, cfg: Config,
                 gen: torch.Generator | None = None):
    """One replay of `cfg.batch` stored gradients through Adam, written
    into `model`'s parameters (JAX `_replay`, `:312-315`).  The caller
    ensures `state.mem.count >= cfg.batch`.  Returns (mean sampled critic
    loss as a tensor, samples skipped as non-finite)."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    params, state.opt, loss, skipped = replay_apply(
        state.mem, params, state.opt, cfg.batch, lr=cfg.learning_rate,
        decay=cfg.learning_decay, clipnorm=cfg.clipnorm, max_norm=cfg.max_norm,
        gen=gen)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    return loss, skipped


def train_step(model, state: TrainState, inst, jobs, cfg: Config,
               gen: torch.Generator | None = None, explore: float | None = None,
               device=None, precision=None, fp_fn=None) -> TrainReport:
    """One training step on a batch of B episodes, on `device` (default
    CUDA), under the `precision` policy (None: fp32; the model carries its
    own dtypes): `train_forward`, then, once `cfg.batch` gradients are
    stored, `train_replay`.  `explore` defaults to `cfg.explore`; `gen`
    feeds the exploration draws and the replay's sampling."""
    dev = resolve_device(device)
    outs = train_forward(model, state, inst, jobs, cfg, gen, explore, dev, precision, fp_fn)
    replay_loss = torch.full((), float("nan"), device=dev)
    skipped = 0
    replayed = state.mem.count >= cfg.batch
    if replayed:
        replay_loss, skipped = train_replay(model, state, cfg, gen)
    return TrainReport(job_total=outs.delays.job_total, loss_critic=outs.loss_critic,
                       loss_mse=outs.loss_mse, replayed=replayed, replay_loss=replay_loss,
                       skipped=skipped)


def _step_stats(grads: dict, loss_critic, loss_mse) -> dict:
    """The step's per-episode gradient norms and loss moments, device
    tensors until the caller's sync: `grad_norm` (B,) and `moments`
    (critic loss sum, its sum of squares, MSE loss sum, non-finite
    episodes)."""
    lc = loss_critic.to(torch.float32)
    lm = loss_mse.to(torch.float32)
    return {"grad_norm": episode_grad_norms(grads),
            "moments": torch.stack([lc.sum(), (lc * lc).sum(), lm.sum(),
                                    (~torch.isfinite(lc) | ~torch.isfinite(lm)).sum()])}


def _step_fields(stats: dict) -> dict:
    """`_step_stats` as the run log's `step` event fields (host values)."""
    lc, lc2, lm, bad = stats["moments"].cpu().tolist()
    return {"grad_norm": stats["grad_norm"].cpu().tolist(), "loss_critic_sum": lc,
            "loss_critic_sq_sum": lc2, "loss_mse_sum": lm, "nonfinite": int(bad)}


# ---- the file loops -------------------------------------------------------


def _pad_leading(tree, size: int):
    """Pad a batched record's leading axis up to `size` by repeating the
    last row (JAX `:528-539`)."""
    b = tree.src.shape[0] if hasattr(tree, "src") else tree.adj.shape[0]
    if b >= size:
        return tree
    return cat_records([tree] + [slice_records(tree, b - 1, b)] * (size - b))


def _load_reference_params(model, model_dir: str, dtype) -> bool:
    """Load the reference-format TF weights of `model_dir` into `model`,
    cast to `dtype`, when the directory holds a `checkpoint` file (JAX
    `_init_params`, `:65-77`: the auto-resume of `AdHoc_train.py:62-65`).
    A load error is printed and the fresh init kept, as in JAX.  Returns
    whether weights were loaded."""
    if not (model_dir and os.path.isfile(os.path.join(model_dir, "checkpoint"))):
        return False
    try:
        tree = load_reference_checkpoint(model_dir, dtype=np.float64)
        print(f"loaded reference-format weights from {model_dir}")  # print-ok(operator feedback at startup)
    except Exception as e:
        print(f"unable to load {model_dir}: {e}")  # print-ok(operator feedback at startup)
        return False
    model.load_state_dict({k: v.to(dtype) for k, v in params_from_jax(tree).items()})
    return True


class _Harness:
    """Shared model / optimizer / data plumbing of Trainer and Evaluator
    (JAX `_Harness`, `:80-449`), on `device` (default CUDA), under the
    precision policy of `cfg.precision` resolved for that device (JAX
    `:110-143`): the model at its dtypes, instances and job sets stored at
    the policy's `storage_dtype`, the APSP in its compute dtype on the route
    of `cfg.apsp_impl` (`self.apsp_path`: the path at the dataset's pad).

    `memory_size=0` skips the gradient replay (the Evaluator never
    replays).  The model directory's TF-format weights are loaded when it
    holds a `checkpoint` file (`_load_reference_params`); otherwise the
    fresh init is probed with real features from four files spread over
    the dataset, and its output unit's sign flipped when it is dead
    (`ensure_alive_output_multi`).

    The data mesh (JAX `:165-198`): `devices` (None: every local CUDA
    device, `device` first, or `[device]` on the CPU) holds the
    candidates; `cfg.mesh_data` of them (0: all) make `n_dp`, an explicit
    `mesh_data` above their count and `mesh_graph > 1` raise JAX's errors,
    and `mesh` is the `data` mesh over the first `n_dp` (JAX builds one
    only where `n_dp` or `eval_chunk` is above 1; a mesh of one device
    runs the one-device paths' calls)."""

    def __init__(self, cfg: Config, datapath: Optional[str] = None,
                 memory_size: Optional[int] = None, device=None, devices=None):
        self.cfg = cfg
        self.model_dir = cfg.model_dir()
        if device is None and devices is not None:
            device = devices[0]
        self.precision = cfg.precision_policy("cuda" if device is None else device)
        self.device = resolve_device(device)
        self.dtype = self.precision.param_dtype       # parameters
        self.store = self.precision.storage_dtype     # instances and job sets
        self.layout = resolve_layout(cfg.layout)
        self.data = DatasetCache.load(cfg, datapath, storage_dtype=self.store)
        _, self.apsp_path = resolve_apsp(cfg.apsp_impl, self.data.pad.n)
        self.fp_fn, self.fp_path = resolve_fixed_point(cfg.fp_impl, self.data.pad.l)
        # the one-device step's device metrics, flushed at its sync
        self.devmetrics = train_devmetrics()
        self.last_devmetrics: Optional[dict] = None
        self.model = make_model(cfg, layout=self.layout, policy=self.precision,
                                generator=torch.Generator().manual_seed(cfg.seed))
        loaded = _load_reference_params(self.model, self.model_dir, self.dtype)
        if not loaded and len(self.data):
            ensure_alive_output_multi(self.model, self._probes())
        # the one-device programs in the prof layer (JAX `:305-316`); the
        # data-parallel steps stay unwrapped, as in JAX
        self._step_program = obs_prof.wrap("train/step",
                                           lambda *a: self._train_step(*a))
        self._eval_program = obs_prof.wrap("train/eval",
                                           lambda *a: self._eval_methods(*a))
        self._replay_program = obs_prof.wrap("train/replay", lambda: self._replay())
        self.model.to(self.device)
        params = self.params()
        self.state = TrainState(opt=adam_init(params), mem=None if memory_size == 0 else
                                replay_init(params, memory_size or cfg.memory_size))
        self.rng = np.random.default_rng(cfg.seed)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._resume_step = self._next_free_step()
        # multi-process runs share a filesystem: only process 0 writes CSVs,
        # run logs and checkpoints
        self.is_host0 = process_index() == 0
        local = self._mesh_candidates(devices)
        if cfg.mesh_data > len(local):
            raise ValueError(
                f"mesh_data={cfg.mesh_data} exceeds the {len(local)} local "
                "devices — an explicit request is honored or refused, never "
                "silently clamped")
        if cfg.mesh_graph > 1:
            raise ValueError(
                "the Trainer/Evaluator drivers shard only the 'data' axis; "
                "mesh_graph>1 applies to the library paths "
                "(parallel.make_dp_train_step / parallel.ring)")
        self.n_dp = max(1, cfg.mesh_data if cfg.mesh_data > 0 else len(local))
        self.mesh = make_mesh(data=self.n_dp, graph=1, devices=local[: self.n_dp])
        self._build_dp_steps()

    @property
    def eval_chunk(self) -> int:
        """Files per Evaluator call: `cfg.file_batch` a device, times the
        mesh (read at each run, so a changed `file_batch` applies)."""
        return self.n_dp * max(1, self.cfg.file_batch)

    def _mesh_candidates(self, devices) -> list:
        if devices is not None:
            return [canonical_device(d) for d in devices]
        if self.device.type == "cpu":
            return [self.device]
        home = canonical_device(self.device)
        return [home] + [d for d in local_devices() if d != home]

    def _build_dp_steps(self) -> None:
        """The mesh's steps (JAX `_build_dp_steps`, `:321-341`): the
        Trainer's per-file step over the `data` axis, and the evaluation
        triple sharded by episodes and by whole files."""
        cfg = self.cfg
        self._train_step_dp = make_file_dp_train_step(
            self.model, self.mesh, dropout=cfg.dropout > 0, prob=cfg.prob,
            critic_weight=cfg.critic_weight, mse_weight=cfg.mse_weight,
            layout=cfg.layout, precision=self.precision,
            compat_diagonal_bug=cfg.compat_diagonal_bug, apsp_impl=cfg.apsp_impl,
            fp_fn=self.fp_fn)

        def methods(model, inst, jobs, gen):
            return eval_methods(model, inst, jobs, gen, device=jobs.src.device,
                                layout=self.layout, prob=cfg.prob,
                                compat_diagonal_bug=cfg.compat_diagonal_bug,
                                precision=self.precision, apsp_impl=cfg.apsp_impl,
                                fp_fn=self.fp_fn)

        self._eval_methods_dp = make_sharded_eval_step(methods, self.mesh)
        self._eval_files_dp = make_files_eval_step(methods, self.mesh)

    def _next_seeds(self) -> list:
        """One generator seed per data shard, drawn from `self.gen` (JAX
        draws `next_keys(bp)` on this path)."""
        return torch.randint(0, 2 ** 62, (self.n_dp,), generator=self.gen,
                             device=self.gen.device).tolist()

    def _probes(self) -> list:
        """(features, raw support, mask) of one job set on each of four
        files, drawn from `default_rng(cfg.seed)` as the JAX harness draws
        them (`:134-162`), on the CPU."""
        cfg = self.cfg
        probe_rng = np.random.default_rng(cfg.seed)
        n = len(self.data)
        probes = []
        for fid in sorted({0, n // 3, 2 * n // 3, n - 1}):
            inst = stack_instances([self.data.instance(fid, probe_rng)])
            jobs, _ = sample_jobsets(
                self.data.records[fid], self.data.pad_of(fid), 1, probe_rng,
                cfg.arrival_scale, ul=cfg.ul_data, dl=cfg.dl_data, dtype=self.store,
                index_dtype=self.layout.index_dtype)
            if self.layout.sparse:
                ext = inst.sparse.ext
                sup = SparseSupport(edges=ext, diag=torch.zeros(
                    inst.ext_mask.shape, dtype=self.dtype), csr=inst.sparse.ext_csr)
            else:
                sup = inst.adj_ext
            probes.append((build_ext_features(inst, jobs), sup, inst.ext_mask))
        return probes

    def params(self) -> dict:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def _load_params(self, params: dict) -> None:
        self.model.load_state_dict({k: v.to(self.dtype) for k, v in params.items()})

    def _on_device(self, builds):
        """The batch of a list of (rec, inst, jobsets, counts) builds: each
        file's instance repeated for its job sets, on the device."""
        b = self.cfg.num_instances
        insts = [inst.to(self.device) for _, inst, _, _ in builds]
        inst = stack_instances([i for i in insts for _ in range(b)])
        jobs = cat_records([js for _, _, js, _ in builds]).to(self.device)
        return inst, jobs

    # ---- the step closures (JAX `_build_steps`, `:206-318`) --------------

    def _train_step(self, inst, jobs, explore: float):
        """`train_forward` under the harness's policy: the step's
        `TrainStepOutput`."""
        return train_forward(self.model, self.state, inst, jobs, self.cfg, self.gen,
                             explore, self.device, self.precision, self.fp_fn)

    def _eval_methods(self, inst, jobs, gen):
        cfg = self.cfg
        return eval_methods(self.model, inst, jobs, gen, device=self.device,
                            layout=self.layout, prob=cfg.prob,
                            compat_diagonal_bug=cfg.compat_diagonal_bug,
                            precision=self.precision, apsp_impl=cfg.apsp_impl,
                            fp_fn=self.fp_fn)

    def _replay(self):
        """`train_replay`: (mean sampled critic loss, skipped) as host values."""
        loss, skipped = train_replay(self.model, self.state, self.cfg, self.gen)
        return float(loss), int(skipped)

    # ---- checkpoints (JAX `:347-449`) -------------------------------------

    def _ckpt_dir(self, which: str = "latest") -> str:
        return os.path.join(self.model_dir, "torch_best" if which == "best" else "torch")

    def _next_free_step(self) -> int:
        """The visit counter's start: past every step saved in `torch/` and
        `torch_best/`, so no save ever meets an existing step (0 in a fresh
        model directory, as in JAX)."""
        return max(ckpt_lib.all_steps(self._ckpt_dir())
                   + ckpt_lib.all_steps(self._ckpt_dir("best")), default=-1) + 1

    def _state(self, step: int) -> dict:
        opt = self.state.opt
        return {"params": self.params(),
                "opt_state": {"count": opt.count, "mu": dict(opt.mu), "nu": dict(opt.nu)},
                "step": step}

    def save(self, step: int) -> None:
        """The resume checkpoint of file visit `step` (unique per save: the
        Trainer passes its visit counter); process 0 only."""
        if not self.is_host0:
            return
        ckpt_lib.save_checkpoint(self._ckpt_dir(), step, self._state(step),
                                 lineage=ckpt_lib.make_lineage("offline", cfg=self.cfg))

    def save_best(self, step: int, tau: float) -> None:
        """The best-so-far checkpoint (rolling GNN-test tau), in its own
        directory so retention of the resume chain never evicts it;
        process 0 only."""
        if not self.is_host0:
            return
        directory = self._ckpt_dir("best")
        ckpt_lib.save_checkpoint(directory, step, self._state(step),
                                 lineage=ckpt_lib.make_lineage(
                                     "offline", cfg=self.cfg,
                                     extra={"rolling_gnn_test_tau": tau}))
        atomic_write_json(os.path.join(directory, "best.json"),
                          {"step": step, "rolling_gnn_test_tau": tau})

    def try_restore(self, which: str = "latest") -> Optional[int]:
        """Restore params and Adam state from the newest `which` ("latest"
        or "best") checkpoint; None when there is none.  A checkpoint whose
        optimizer state differs in structure restores its params alone
        (fresh Adam state); a params mismatch raises.  Training resumes
        with its visit counter past every step on disk."""
        directory = self._ckpt_dir(which)
        step = ckpt_lib.latest_step(directory)
        if step is None:
            return None
        try:
            restored = ckpt_lib.restore_checkpoint(directory, self._state(0), step)
        except ValueError:
            restored = ckpt_lib.restore_checkpoint_raw(directory, step)
            saved = restored.get("params") if isinstance(restored, dict) else None
            if not isinstance(saved, dict) or (ckpt_lib.leaf_shapes(saved)
                                               != ckpt_lib.leaf_shapes(self.params())):
                raise
            print("checkpoint optimizer state does not match current config; "  # print-ok(operator feedback on restore)
                  "restored params only (fresh optimizer state)")
            self._load_params(saved)
        else:
            self._load_params(restored["params"])
            o = restored["opt_state"]
            self.state.opt = AdamState(
                count=int(o["count"]),
                mu={k: v.to(self.device) for k, v in o["mu"].items()},
                nu={k: v.to(self.device) for k, v in o["nu"].items()})
        self._resume_step = self._next_free_step()
        return step


class _Prefetcher:
    """One-deep host/device pipeline over a work list (JAX `:452-493`):
    `current()` gives the prepared item; after the device work of an item
    is queued, `prefetch_next()` builds the next one while the card runs
    (CUDA launches are asynchronous) and returns the build's seconds; after
    the item's rows are flushed, `raise_deferred()` re-raises a failed
    build.  Items are built in list order, so the draw order is the
    sequential loop's."""

    def __init__(self, items, build, enabled: bool):
        self.items, self.build, self.enabled = list(items), build, enabled
        self.idx = 0
        self.err = None
        self._prepared = build(self.items[0])[0] if enabled and self.items else None

    def current(self):
        if not self.enabled:
            return self.build(self.items[self.idx])[0]
        return self._prepared

    def prefetch_next(self) -> float:
        self.idx += 1
        if not self.enabled or self.idx >= len(self.items):
            return 0.0
        try:
            self._prepared, secs = self.build(self.items[self.idx])
            return secs
        except Exception as e:  # deferred: the caller flushes first
            self.err = e
            return 0.0

    def raise_deferred(self) -> None:
        if self.err is not None:
            raise self.err


def _cell(v):
    """A CSV field as pandas writes it: NaN empty, floats by repr."""
    if isinstance(v, float) and math.isnan(v):
        return ""
    return v


def write_csv(path: str, columns, rows, append: bool = False) -> None:
    with open(path, "a" if append else "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        if not append:
            w.writerow(columns)
        for r in rows:
            w.writerow([_cell(r[c]) for c in columns])


class _CsvFlusher:
    """Per-file CSV flushing that appends only the new rows (JAX
    `:496-525`): crash-safe at every file boundary, O(total rows)."""

    def __init__(self, path: str, columns, enabled: bool = True):
        self.path, self.columns, self.enabled = path, columns, enabled
        self.written = 0

    def flush(self, rows) -> None:
        if not self.enabled or (self.written and len(rows) <= self.written):
            return
        write_csv(self.path, self.columns, rows[self.written:], append=self.written > 0)
        self.written = len(rows)


def _rows(rec, counts, metrics_per_method, runtime, fid, ni_offset=0,
          algo_col="method", fid_col=True):
    rows = []
    for method, (tau, congest, gap, ratio) in metrics_per_method.items():
        for ni in range(len(counts)):
            row = {
                "filename": rec.filename,
                "seed": rec.seed,
                "num_nodes": rec.topo.n,
                "m": rec.m,
                "num_servers": rec.num_servers,
                "num_relays": rec.num_relays,
                "num_mobile": rec.topo.n - rec.num_servers - rec.num_relays,
                "num_jobs": int(counts[ni]),
                "n_instance": ni + ni_offset,
                algo_col: method,
                "runtime": runtime,
                "tau": float(tau[ni]),
                "congest_jobs": int(congest[ni]),
                "gap_2_bl": float(gap[ni]),
                "gnn_bl_ratio": float(ratio[ni]),
            }
            if fid_col:
                row["fid"] = fid
            rows.append(row)
    return rows


def _method_metrics(totals_by_method, baseline_totals, masks, t_max):
    """Every method's per-instance metrics in one device computation and
    one host fetch: {method: (tau, congest_jobs, gap_2_bl, ratio_2_bl)}."""
    names = list(totals_by_method)
    ms = [instance_metrics(totals_by_method[n], baseline_totals, masks, t_max)
          for n in names]
    host = torch.stack([torch.stack([m.tau, m.congest_jobs.to(m.tau.dtype), m.gap_2_bl,
                                     m.ratio_2_bl]) for m in ms]).cpu().numpy()
    return {n: (host[i, 0], host[i, 1].astype(np.int64), host[i, 2], host[i, 3])
            for i, n in enumerate(names)}


def _dataset_tag(cfg: Config) -> str:
    return os.path.normpath(cfg.datapath).split(os.sep)[-1]


class Trainer(_Harness):
    """The `bash/train.sh` -> `AdHoc_train.py` workflow (JAX `:592-806`):
    `Trainer(cfg, device=None, devices=None)`."""

    def _build_file(self, fid):
        """Host-side file prep; consumes `self.rng` in the sequential
        loop's order."""
        cfg = self.cfg
        t0 = time.perf_counter()  # nondet-ok(input-wait and step wall time is a measurement)
        with span("train/build"):
            rec = self.data.records[fid]
            inst = self.data.instance(fid, self.rng)
            jobsets, counts = sample_jobsets(
                rec, self.data.pad_of(fid), cfg.num_instances, self.rng,
                cfg.arrival_scale, ul=cfg.ul_data, dl=cfg.dl_data, dtype=self.store,
                index_dtype=self.layout.index_dtype)
        return (rec, inst, jobsets, counts), time.perf_counter() - t0  # nondet-ok(same measurement)

    def run(self, epochs: Optional[int] = None, files_limit: Optional[int] = None,
            out_dir: Optional[str] = None, verbose: bool = True) -> str:
        cfg = self.cfg
        if files_limit is None:
            files_limit = cfg.files_limit
        out_dir = out_dir or cfg.out
        os.makedirs(out_dir, exist_ok=True)
        csv_path = os.path.join(
            out_dir, f"aco_training_data_{_dataset_tag(cfg)}_load_"
                     f"{cfg.arrival_scale:.2f}_T_{cfg.T}.csv")
        rows = []
        train_csv = _CsvFlusher(csv_path, TRAIN_COLUMNS, enabled=self.is_host0)
        explore = cfg.explore
        losses = []
        self.replay_losses = []  # every replay's mean sampled critic loss
        best_roll = collections.deque(maxlen=max(cfg.best_window, 1))
        # a resumed run must not let a worse window overwrite the best
        self.best_tau = float("inf")
        best = load_json(os.path.join(self._ckpt_dir("best"), "best.json"))
        if best is not None:
            self.best_tau = float(best["rolling_gnn_test_tau"])
        gidx = self._resume_step
        tb = ScalarLogger(cfg.tb_logdir if self.is_host0 else None)
        runlog = obs.start_run(cfg, role="train") if self.is_host0 else None
        b = cfg.num_instances
        bp = -(-b // self.n_dp) * self.n_dp  # the episode batch the mesh divides

        for epoch in range(epochs if epochs is not None else cfg.epochs):
            order = self.rng.permutation(len(self.data))
            if files_limit:
                order = order[:files_limit]
            pf = _Prefetcher(order, self._build_file, cfg.prefetch)
            for fid in order:
                rec, inst, jobsets, counts = pf.current()
                t0 = time.perf_counter()  # nondet-ok(input-wait and step wall time is a measurement)
                with span("train/step"):
                    inst_b, jobs = self._on_device([(rec, inst, jobsets, counts)])
                    if self.n_dp > 1:
                        # pad the episode batch to a mesh-divisible width; the
                        # valid mask keeps pad episodes out of the replay
                        inst_p, jobs_p = _pad_leading(inst_b, bp), _pad_leading(jobs, bp)
                        valid = torch.arange(bp, device=self.device, dtype=torch.long) < b
                        _, gnn_train, loss_c, loss_m = self._train_step_dp(
                            self.model, self.state.mem, inst_p, jobs_p, self._next_seeds(),
                            valid, explore)
                        bl, loc, gnn_test = self._eval_methods_dp(
                            self.model, inst_p, jobs_p, self._next_seeds())
                        gnn_train, loss_c, loss_m, bl, loc, gnn_test = (
                            x[:b] for x in (gnn_train, loss_c, loss_m, bl, loc, gnn_test))
                        grads = replay_last(self.state.mem, min(b, cfg.memory_size))
                    else:
                        td0 = time.perf_counter()  # nondet-ok(input-wait and step wall time is a measurement)
                        outs = self._step_program(inst_b, jobs, explore)
                        grads, loss_c, loss_m = outs.grads, outs.loss_critic, outs.loss_mse
                        gnn_train = outs.delays.job_total
                        dev_m = step_devmetrics(self.devmetrics, grads, loss_c, loss_m,
                                                self.device)
                        bl, loc, gnn_test = self._eval_program(inst_b, jobs, self.gen)
                    stats = _step_stats(grads, loss_c, loss_m) if runlog is not None else None
                    next_build_s = pf.prefetch_next()
                    synchronize(self.device)
                    if self.n_dp <= 1:
                        # the train and eval window up to the sync goes to
                        # train/step; eval gets its call only (JAX `:699-707`)
                        self._step_program.account(time.perf_counter() - td0)  # nondet-ok(same measurement)
                        self._eval_program.account(0.0)
                        # the step's device accumulators, fetched at the sync
                        # just paid for
                        self.last_devmetrics = self.devmetrics.flush(dev_m)
                wall = time.perf_counter() - t0  # nondet-ok(same measurement)
                runtime = max(wall - next_build_s, 0.0) / (4 * b)

                with span("train/metrics"):
                    metrics = _method_metrics(
                        {"baseline": bl, "local": loc, "GNN": gnn_train,
                         "GNN-test": gnn_test}, bl, jobs.mask, float(cfg.T))
                rows += _rows(rec, counts, metrics, runtime, gidx)

                # best-checkpoint tracking on the rolling GNN-test tau
                if cfg.best_window > 0:
                    best_roll.append(float(np.nanmean(metrics["GNN-test"][0])))
                    roll = float(np.mean(best_roll))
                    if len(best_roll) == cfg.best_window and roll < self.best_tau:
                        self.best_tau = roll
                        self.save_best(gidx, roll)
                        if runlog is not None:
                            runlog.emit("checkpoint", step=gidx, kind="best",
                                        rolling_tau=roll, source="offline")

                # replay: the only weight update (`AdHoc_train.py:187`)
                loss = float("nan")
                if self.state.mem.count >= cfg.batch:
                    with span("train/replay", block=True):
                        tr0 = time.perf_counter()  # nondet-ok(input-wait and step wall time is a measurement)
                        loss, nskip = self._replay_program()
                        # the host pull of the loss is the sync boundary
                        self._replay_program.account(time.perf_counter() - tr0)  # nondet-ok(same measurement)
                    if nskip:
                        obs.registry().counter(
                            "mho_refit_skipped_updates_total",
                            "optimizer updates skipped on non-finite grads",
                        ).inc(nskip, phase="replay")
                    self.replay_losses.append(loss)
                losses.append(loss)

                if np.isfinite(loss):
                    self.save(gidx)
                    if runlog is not None:
                        runlog.emit("checkpoint", step=gidx, kind="latest", source="offline")
                    explore = float(np.clip(explore * cfg.explore_decay, 0.0, 1.0))
                    if verbose:
                        print(f"{gidx} Loss: {np.nanmean(losses):.2f}, "  # print-ok(verbose console)
                              f"explore: {explore:.4f}")
                    if tb.active:
                        tb.log_scalar("replay_loss", loss, gidx)
                        tb.log_scalar("explore", explore, gidx)
                        tb.log_scalar("mse_loss", float(torch.nanmean(loss_m)), gidx)
                    losses = []
                if runlog is not None:
                    runlog.emit("step", epoch=epoch, gidx=gidx, fid=int(fid),
                                wall_s=round(wall, 6), build_s=round(next_build_s, 6),
                                runtime=round(runtime, 6),
                                loss=(loss if np.isfinite(loss) else None),
                                explore=round(explore, 6), **_step_fields(stats))
                gidx += 1
                train_csv.flush(rows)
                pf.raise_deferred()
            if runlog is not None:
                runlog.emit("epoch", epoch=epoch, files=len(order), gidx=gidx)
        # a later run() continues the visit counter, never reusing a step
        self._resume_step = gidx
        tb.close()
        obs.finish_run(runlog)
        return csv_path


class Evaluator(_Harness):
    """The `bash/test.sh` -> `AdHoc_test.py` workflow, no weight updates
    (JAX `:809-1035`)."""

    def __init__(self, cfg: Config, datapath: Optional[str] = None, device=None,
                 devices=None):
        super().__init__(cfg, datapath, memory_size=0, device=device, devices=devices)

    def _file_rng(self, fid: int) -> np.random.Generator:
        """Per-file workload RNG keyed by (seed, fid): the same workloads
        however files are ordered or batched."""
        return np.random.default_rng((self.cfg.seed, fid))

    def _file_seed(self, fid: int) -> int:
        """Per-file generator seed keyed by (seed, fid), in place of the JAX
        `_file_keys`: `prob=True` draws do not depend on the file order, on
        `file_batch` or on the device a file is evaluated on."""
        return int(np.random.SeedSequence((self.cfg.seed, fid)).generate_state(1)[0])

    def _file_gen(self, fid: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self._file_seed(fid))

    def _build_file(self, fid: int):
        """Host-side prep of file `fid`, shared by both loops, so that
        `file_batch > 1` and `== 1` draw the same workloads."""
        cfg = self.cfg
        t0 = time.perf_counter()  # nondet-ok(input-wait and step wall time is a measurement)
        with span("eval/build"):
            rec = self.data.records[fid]
            frng = self._file_rng(fid)
            inst = self.data.instance(fid, frng)
            jobsets, counts = sample_jobsets(
                rec, self.data.pad_of(fid), cfg.num_instances, frng,
                cfg.arrival_scale, ul=cfg.ul_data, dl=cfg.dl_data, dtype=self.store,
                index_dtype=self.layout.index_dtype)
        return (rec, inst, jobsets, counts), time.perf_counter() - t0  # nondet-ok(same measurement)

    def run(self, files_limit: Optional[int] = None, out_dir: Optional[str] = None,
            verbose: bool = True, file_ids=None) -> str:
        """Evaluate the test set and write the reference-schema CSV.
        `file_ids` picks a subset of files (the sequential loop, as in
        JAX; e.g. ``range(p, n, 2)`` for process p of a two-process file
        shard); otherwise `eval_chunk > 1` evaluates same-bucket chunks of
        files, sharded over the mesh.  Process 0 writes the CSV and the run
        log, and with `csv_write_all_hosts` every process writes its own."""
        cfg = self.cfg
        out_dir = out_dir or cfg.out
        os.makedirs(out_dir, exist_ok=True)
        csv_path = os.path.join(
            out_dir, f"Adhoc_test_data_{_dataset_tag(cfg)}_load_"
                     f"{cfg.arrival_scale:.2f}_T_{cfg.T}.csv")
        n_files = min(len(self.data), files_limit or len(self.data))
        write = self.is_host0 or cfg.csv_write_all_hosts
        runlog = obs.start_run(cfg, role="eval") if write else None
        if file_ids is None and self.eval_chunk > 1:
            self._run_files_batched(n_files, verbose, csv_path if write else None, runlog)
        else:
            fids = ([f for f in file_ids if 0 <= f < n_files]
                    if file_ids is not None else list(range(n_files)))
            if file_ids is not None and not fids:
                raise ValueError(
                    f"file_ids selects no files: every id is outside [0, {n_files})")
            eval_csv = _CsvFlusher(csv_path, TEST_COLUMNS, enabled=write)
            rows = []
            b = cfg.num_instances
            pf = _Prefetcher(fids, self._build_file, cfg.prefetch)
            for i, fid in enumerate(fids):
                build = pf.current()
                rec, _, jobsets, counts = build
                t0 = time.perf_counter()  # nondet-ok(input-wait and step wall time is a measurement)
                with span("eval/step"):
                    inst_b, jobs = self._on_device([build])
                    bl, loc, gnn = self._eval_program(inst_b, jobs, self._file_gen(fid))
                    next_build_s = pf.prefetch_next()
                    synchronize(self.device)
                wall = time.perf_counter() - t0  # nondet-ok(same measurement)
                runtime = max(wall - next_build_s, 0.0) / (3 * b)
                metrics = _method_metrics({"baseline": bl, "local": loc, "GNN": gnn},
                                          bl, jobs.mask, float(cfg.T))
                rows += _rows(rec, counts, metrics, runtime, fid, algo_col="Algo",
                              fid_col=False)
                if verbose and i % 50 == 0:
                    print(f"[{i + 1}/{len(fids)}] {rec.filename} "  # print-ok(verbose console)
                          f"({wall:.3f}s for {3 * b} evals)")
                if runlog is not None:
                    runlog.emit("step", fid=fid, wall_s=round(wall, 6),
                                build_s=round(next_build_s, 6), runtime=round(runtime, 6))
                eval_csv.flush(rows)
                pf.raise_deferred()
        obs.finish_run(runlog)
        return csv_path

    def _run_files_batched(self, n_files: int, verbose: bool, csv_path, runlog):
        """`eval_chunk` same-bucket files per call, dealt to the mesh's
        devices `file_batch` a device (`make_files_eval_step`); each
        device's files are stacked into one batch of requests, each file's
        draws from its own generator (JAX `_run_files_dp`, `:949-1035`; a
        bucket's last chunk is simply shorter, with no padding files).
        Rows are rewritten in file order after every chunk, when
        `csv_path` is given."""
        cfg = self.cfg
        b = cfg.num_instances
        chunk_size = self.eval_chunk
        by_bucket: dict = {}
        for fid in range(n_files):
            by_bucket.setdefault(self.data.bucket_of[fid], []).append(fid)
        chunks = [(bucket, fids[c0:c0 + chunk_size])
                  for bucket, fids in sorted(by_bucket.items())
                  for c0 in range(0, len(fids), chunk_size)]

        def build_chunk(bucket_chunk):
            t0 = time.perf_counter()  # nondet-ok(input-wait and step wall time is a measurement)
            builds = [self._build_file(fid)[0] for fid in bucket_chunk[1]]
            return builds, time.perf_counter() - t0  # nondet-ok(same measurement)

        rows_by_fid = {}
        done = 0
        pf = _Prefetcher(chunks, build_chunk, cfg.prefetch)
        for bucket, chunk in chunks:
            builds = pf.current()
            t0 = time.perf_counter()  # nondet-ok(input-wait and step wall time is a measurement)
            with span("eval/step"):
                bl, loc, gnn = self._eval_files_dp(
                    self.model, [bd[1] for bd in builds], [bd[2] for bd in builds],
                    [self._file_seed(f) for f in chunk])
                next_build_s = pf.prefetch_next()
                synchronize(self.device)
            wall = time.perf_counter() - t0  # nondet-ok(same measurement)
            runtime = max(wall - next_build_s, 0.0) / (3 * b * len(chunk))
            for d, fid in enumerate(chunk):
                s = slice(d * b, (d + 1) * b)
                mask = builds[d][2].mask.to(bl.device)
                metrics = _method_metrics({"baseline": bl[s], "local": loc[s], "GNN": gnn[s]},
                                          bl[s], mask, float(cfg.T))
                rows_by_fid[fid] = _rows(builds[d][0], builds[d][3], metrics, runtime, fid,
                                         algo_col="Algo", fid_col=False)
            done += len(chunk)
            if verbose:
                print(f"[{done}/{n_files}] bucket {bucket} chunk of {len(chunk)} "  # print-ok(verbose console)
                      f"({wall:.3f}s, chunk {chunk_size} on {self.n_dp} devices)")
            if runlog is not None:
                runlog.emit("step", bucket=bucket, files=len(chunk), done=done,
                            wall_s=round(wall, 6), build_s=round(next_build_s, 6),
                            runtime=round(runtime, 6))
            if csv_path is not None:
                write_csv(csv_path, TEST_COLUMNS,
                          [r for f in sorted(rows_by_fid) for r in rows_by_fid[f]])
            pf.raise_deferred()
