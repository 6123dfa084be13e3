"""Multi-device training and eval steps over the (data, graph) mesh.

Port of `multihop_offload_tpu/parallel/data_parallel.py`.  Episodes
(network instances) shard over the `data` axis; within each data shard the
distance-matrix work can shard over that shard's `graph` row through the
ring APSP (`parallel.ring.sharded_apsp`).

Each process drives its own data shards of the mesh
(`parallel/collectives.py`; a mesh may span processes, below).  The factories
take JAX's arguments and return steps with JAX's signatures, the port's
model in place of JAX's `variables`: a step reads its parameters from the
model it is given.  Each data shard runs on its device (the first of its
graph row) with a replica of the model there, a copy of the factory's
model made at the step's first call and refreshed from the step's model
at every call: the counterpart of JAX's replicated `variables`.  Shards
on one device share one replica (the step's model itself on the model's
device).  Each shard calls `forward_backward` or
`forward_env` on its slice of the episodes, so every kernel of those paths
is launched once per shard.  The shards are issued one after another; on
distinct cards a shard's kernels run while the host issues the next
shard's, as far as the path does not wait on its card.

Two update rules:
  * `mode="mean"` -- synchronous data parallelism: each shard's
    per-episode gradients are averaged, the shard means averaged over
    `data` (`pmean`), then one step of the port's Adam
    (`agent.replay.Adam`) and `apply_max_norm_constraint(params, 1.0)`;
    the new parameters are written into the model and every replica;
  * `mode="replay"` -- the reference's gradient-replay semantics: every
    shard's per-episode gradients are gathered in device order and
    remembered in that order (`valid` keeps pad episodes out); the replay
    update itself (`agent.replay.replay_apply`) stays a separate call.

A mesh may span processes (`parallel.mesh.make_mesh(..., runtime=)`):
each process then drives the data shards it owns, on the batch it passes
(`global_batch`), and the `mean` step reduces across processes after the
local mean: each process's shard mean, weighted by its shard count, summed
over the group (`multihost.runtime.all_reduce`, one call a step for the
gradients, both losses and the gathered job totals) and divided by the
data-axis size.  Every process then applies the same update and reports
the same metrics.  The steps that gather over `data` (`replay`, the eval
steps, the file step) refuse such a mesh.

The JAX steps take per-episode PRNG keys.  The port's take `seeds`: one
int per data shard (per file for `make_files_eval_step`), from which the
shard makes its generator on its device; None draws from the device's
default generator.  `dropout` (JAX `:64-82,146-161`) trains each shard's
episodes on dropout masks drawn from the shard's generator, one stream an
episode (`agent.train_step.forward_backward`'s `dropout`); it needs
`seeds`.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch

from multihop_offload_tpu_torch._records import cat_records
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.agent.replay import (
    apply_max_norm_constraint,
    replay_remember,
)
from multihop_offload_tpu_torch.agent.train_step import forward_backward
from multihop_offload_tpu_torch.graphs.instance import stack_instances
from multihop_offload_tpu_torch.multihost.runtime import all_reduce
from multihop_offload_tpu_torch.parallel.collectives import copy_to, gather, mean_to
from multihop_offload_tpu_torch.parallel.mesh import Mesh, shard_batch
from multihop_offload_tpu_torch.parallel.ring import sharded_apsp

def _graph_apsp_fn(mesh: Mesh, d: int):
    """Ring APSP over data shard `d`'s graph row when the `graph` axis is
    nontrivial, else None."""
    if mesh.shape["graph"] > 1:
        devices = mesh.graph_devices(d)
        return lambda w: sharded_apsp(w, devices)
    return None


def _local_only(mesh: Mesh, what: str) -> None:
    if mesh.spans_processes:
        raise ValueError(f"{what} gathers over 'data' within one process; over a mesh "
                         "that spans processes use make_dp_train_step(mode='mean')")


def _reduce_processes(mesh: Mesh, means: dict, totals: torch.Tensor) -> tuple:
    """The data-axis means and the gathered job totals over every process:
    each process's local means weighted by its shard count and its totals
    placed at its rows of the global batch, summed over the group in one
    `all_reduce`, the means then divided by the data-axis size.  Returns
    (means, totals) at global width."""
    k, n = len(mesh.local_rows), mesh.shape["data"]
    per = totals.shape[0] // k
    names = list(means)
    dt = means[names[0]].dtype
    glob = totals.new_zeros((n * per,) + tuple(totals.shape[1:]), dtype=dt)
    r0 = mesh.local_rows[0] * per
    glob[r0:r0 + k * per] = totals.to(dt)
    flat = all_reduce(torch.cat([means[m].reshape(-1).to(dt) * k for m in names]
                                + [glob.reshape(-1)]))
    out, at = {}, 0
    for m in names:
        size = means[m].numel()
        out[m] = (flat[at:at + size] / n).reshape(means[m].shape).to(means[m].dtype)
        at += size
    return out, flat[at:].reshape(glob.shape).to(totals.dtype)


class _Replicas:
    """One model per data shard: the step's model on its own device, else
    a copy of `template` (the step's model when None) per distinct device,
    refreshed from the step's model."""

    def __init__(self, mesh: Mesh, template=None):
        self.devices = mesh.data_devices()
        self.template = template
        self._copies: dict = {}

    def sync(self, model) -> list:
        """Each shard's model, every copy's parameters set to `model`'s."""
        home = next(model.parameters()).device
        out = []
        for dev in self.devices:
            if dev == home:
                out.append(model)
                continue
            if dev not in self._copies:
                self._copies[dev] = copy.deepcopy(self.template or model).to(dev)
            out.append(self._copies[dev])
        with torch.no_grad():
            for rep in self._copies.values():
                for p, q in zip(rep.parameters(), model.parameters()):
                    p.copy_(copy_to(q.detach(), p.device))
        return out


def _generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def _shard_gens(seeds: Optional[Sequence[int]], devices) -> list:
    if seeds is None:
        return [None] * len(devices)
    if len(seeds) != len(devices):
        raise ValueError(f"{len(seeds)} seeds for {len(devices)} data shards")
    return [_generator(s, d) for s, d in zip(seeds, devices)]


def _per_device(mesh: Mesh, replicas: _Replicas, fb_kwargs: dict):
    """The per-shard `forward_backward`: (model, insts, jobs, seeds,
    explore) -> one `TrainStepOutput` per data shard."""
    fb_kwargs = dict(fb_kwargs)
    apsp_fn = fb_kwargs.pop("apsp_fn", None)  # None: the ring when `graph` > 1
    devices = mesh.data_devices()

    def run(model, insts, jobs, seeds, explore):
        models = replicas.sync(model)
        outs = []
        for d, (m, i, j, g) in enumerate(zip(models, shard_batch(insts, devices),
                                             shard_batch(jobs, devices),
                                             _shard_gens(seeds, devices))):
            outs.append(forward_backward(m, i, j, g, explore=explore, device=devices[d],
                                         apsp_fn=apsp_fn or _graph_apsp_fn(mesh, d),
                                         **fb_kwargs))
        return outs

    return run


def _gather_and_remember(outs, mem, valid):
    """Gather every shard's episode gradients and losses in device order on
    the buffer's device and append them to the ring buffer: the reference's
    gradient-replay semantics on a mesh.  `valid` (None or a (B,) bool
    mask over the gathered episodes) keeps pad episodes out of the buffer.
    Returns (mem, totals, lc, lm), each gathered to full batch width."""
    dev = mem.loss_critic.device
    cat = lambda xs: gather(xs, dev, tiled=True)
    grads = {k: cat([o.grads[k] for o in outs]) for k in mem.grads}
    lc = cat([o.loss_critic for o in outs])
    lm = cat([o.loss_mse for o in outs])
    totals = cat([o.delays.job_total for o in outs])
    if valid is None:
        replay_remember(mem, grads, lc, lm)
    else:
        keep = torch.nonzero(valid.to(dev)).squeeze(1)
        replay_remember(mem, {k: g.index_select(0, keep) for k, g in grads.items()},
                        lc.index_select(0, keep), lm.index_select(0, keep))
    return mem, totals, lc, lm


def make_file_dp_train_step(model, mesh: Mesh, dropout: bool = False, **fb_kwargs):
    """Replay-semantics training step for ONE file: the episode batch (the
    file's instance repeated, and its job sets) shards over `data`.  This
    is the Trainer's multi-device path: callers pad the episode batch to a
    device-divisible width and pass `valid` to keep pad episodes out of the
    replay buffer.  `fb_kwargs` forward to `forward_backward` (prob,
    critic_weight, mse_weight, layout, precision, apsp_impl, apsp_fn,
    compat_diagonal_bug, ...).

    Signature: step(model, mem, inst, jobs, seeds, valid, explore)
    -> (mem, job_totals, loss_critic, loss_mse), all at full batch width.
    """
    _local_only(mesh, "the file step")
    per_device = _per_device(mesh, _Replicas(mesh, model), dict(fb_kwargs, dropout=dropout))

    def step(model, mem, inst, jobs, seeds, valid, explore):
        return _gather_and_remember(per_device(model, inst, jobs, seeds, explore), mem, valid)

    return step


def _sharded_eval(eval_fn, mesh: Mesh, deal, template=None):
    """A step(model, *args) calling `eval_fn(replica, *shard)` for each
    shard `deal(devices, *args)` yields (None: no work for that shard),
    its output tuples gathered in shard order on the model's device."""
    _local_only(mesh, "an eval step")
    replicas = _Replicas(mesh, template)
    devices = mesh.data_devices()

    def step(model, *args):
        models = replicas.sync(model)
        home = next(model.parameters()).device
        outs = [eval_fn(m, *shard) for m, shard in zip(models, deal(devices, *args))
                if shard is not None]
        return tuple(gather([o[k] for o in outs], home, tiled=True)
                     for k in range(len(outs[0])))

    return step


def make_sharded_eval_step(eval_fn, mesh: Mesh):
    """Shard a per-file eval closure's episode batch over `data`.

    `eval_fn(model, inst, jobs, gen)` must return a tuple of (B_local, ...)
    tensors (the drivers' baseline/local/GNN totals) on the shard's device;
    the returned step(model, inst, jobs, seeds) takes the full batch and
    gathers every output to full width on the model's device."""

    def deal(devices, inst, jobs, seeds):
        return zip(shard_batch(inst, devices), shard_batch(jobs, devices),
                   _shard_gens(seeds, devices))

    return _sharded_eval(eval_fn, mesh, deal)


def make_files_eval_step(eval_fn, mesh: Mesh):
    """Shard WHOLE files over `data`: step(model, insts, jobs, seeds) takes
    one unbatched instance, one (B, ...) job-set batch and one seed per
    file, deals the files out in order, ceil(files / shards) a shard (the
    last shards may get fewer, or none), and calls `eval_fn(model, inst,
    jobs, gens)` once per shard on its files' requests (each instance
    repeated for its job sets, one generator per file).  Outputs are
    gathered in file order on the model's device."""

    def deal(devices, insts, jobs, seeds):
        n = len(devices)
        per = -(-len(insts) // n)
        for d, dev in enumerate(devices):
            files = range(d * per, min((d + 1) * per, len(insts)))
            if not files:
                yield None
                continue
            js = [jobs[f].to(dev) for f in files]
            inst = stack_instances([insts[f].to(dev) for f, j in zip(files, js)
                                    for _ in range(j.src.shape[0])])
            yield inst, cat_records(js), [_generator(seeds[f], dev) for f in files]

    return _sharded_eval(eval_fn, mesh, deal)


def make_dp_train_step(model, optimizer, mesh: Mesh, mode: str = "mean",
                       dropout: bool = False, **fb_kwargs):
    """Batched episode step with the episode batch sharded over `data`:
    `mean`: step(model, opt_state, insts, jobs, seeds, explore) ->
    (params, opt_state, metrics), the new parameters also written into the
    model and every replica; `replay`: step(model, mem, insts, jobs, seeds,
    explore) -> (mem, metrics).  `optimizer` is an `agent.replay.Adam`
    (`make_optimizer(cfg)`).

    The batch axis length must be divisible by the data-axis size.
    `fb_kwargs` forward to `forward_backward`."""
    replicas = _Replicas(mesh, model)
    per_device = _per_device(mesh, replicas, dict(fb_kwargs, dropout=dropout))

    if mode == "mean":

        def step(model, opt_state, insts, jobs, seeds, explore):
            outs = per_device(model, insts, jobs, seeds, explore)
            home = next(model.parameters()).device
            params = {k: p.detach() for k, p in model.named_parameters()}
            means = {k: mean_to([o.grads[k].mean(0) for o in outs], home) for k in params}
            means["loss_critic"] = mean_to([o.loss_critic.mean() for o in outs], home)
            means["loss_mse"] = mean_to([o.loss_mse.mean() for o in outs], home)
            totals = gather([o.delays.job_total for o in outs], home, tiled=True)
            if mesh.spans_processes:
                means, totals = _reduce_processes(mesh, means, totals)
            grads = {k: means[k] for k in params}
            params, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_max_norm_constraint(params, 1.0)
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(params[k])
            replicas.sync(model)
            metrics = {"loss_critic": means["loss_critic"], "loss_mse": means["loss_mse"],
                       "job_total": totals}
            return params, opt_state, metrics

        step.replicas = replicas  # the copies on the mesh's other devices
        return step

    if mode == "replay":
        _local_only(mesh, "the replay step")

        def step(model, mem, insts, jobs, seeds, explore):
            outs = per_device(model, insts, jobs, seeds, explore)
            mem, totals, lc, lm = _gather_and_remember(outs, mem, None)
            return mem, {"loss_critic": lc, "loss_mse": lm, "job_total": totals}

        return step

    raise ValueError(f"unknown mode {mode!r}")


def make_dp_eval_step(model, mesh: Mesh, **env_kwargs):
    """Data-parallel policy evaluation (inference): step(model, insts,
    jobs, seeds) -> the job totals of the sharded episode batch, gathered
    on the model's device.  `env_kwargs` forward to `forward_env`."""
    devices = mesh.data_devices()

    def one(m, inst, jobs, gen, d):
        return (forward_env(m, inst, jobs, gen, device=devices[d],
                            apsp_fn=_graph_apsp_fn(mesh, d), **env_kwargs)[0].job_total,)

    def deal(devs, insts, jobs, seeds):
        return zip(shard_batch(insts, devs), shard_batch(jobs, devs),
                   _shard_gens(seeds, devs), range(len(devs)))

    inner = _sharded_eval(one, mesh, deal, model)
    return lambda model, insts, jobs, seeds: inner(model, insts, jobs, seeds)[0]


def make_multichip_train_step(model, optimizer, mesh: Mesh):
    """The full multi-device training step: episode batch over `data`,
    ring-sharded APSP over `graph`, mean update."""
    return make_dp_train_step(model, optimizer, mesh, mode="mean")
