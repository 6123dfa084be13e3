"""Gradient-replay memory and the optimizer of record.

Port of `multihop_offload_tpu/agent/replay.py`.  The replay stores
*gradients*, one per episode, in a ring buffer with a leading capacity
axis; `replay_apply` samples `batch` of them and applies them one after
another with Adam.

Optimizer parity with the JAX chain (`make_optimizer`: optax `_clip_by_leaf_norm`
then `adam`): Keras `clipnorm` clips each leaf's gradient norm on its own,
Adam uses eps = 1e-7 with bias correction, the learning rate decays as
`exponential_decay(transition_steps=100)` when `learning_decay != 1`, and
the Keras `max_norm` constraint follows every update, with norms over
axis 0 exactly as the JAX code takes them (for a (k, in, out) kernel that
is the k axis).  Adam is a plain function over explicit state
(`AdamState`) over lists of leaves with `torch._foreach_*` ops, so a
replay launches a few dozen kernels per sample; the step count and the
skip decisions are host values (one host sync per replay).

Buffers are updated in place (`replay_remember` writes the addressed
slots of the preallocated ring), which the JAX version does functionally.
"""

from __future__ import annotations

import dataclasses

import torch

from multihop_offload_tpu_torch._phases import phase

KERAS_EPS = 1e-7
B1, B2 = 0.9, 0.999


@dataclasses.dataclass
class GradReplay:
    grads: dict                # name -> (M, *shape)
    loss_critic: torch.Tensor  # (M,) float32
    loss_mse: torch.Tensor     # (M,) float32
    count: int                 # filled slots
    ptr: int                   # next write position


@dataclasses.dataclass
class AdamState:
    count: int  # updates applied (skipped samples not counted)
    mu: dict    # name -> first moment
    nu: dict    # name -> second moment


def replay_init(params: dict, capacity: int) -> GradReplay:
    dev = next(iter(params.values())).device
    return GradReplay(
        grads={k: torch.zeros((capacity,) + p.shape, dtype=p.dtype, device=dev)
               for k, p in params.items()},
        loss_critic=torch.zeros((capacity,), dtype=torch.float32, device=dev),  # fp32-island(loss statistics)
        loss_mse=torch.zeros((capacity,), dtype=torch.float32, device=dev),  # fp32-island(loss statistics)
        count=0, ptr=0)


@phase("replay_remember")
def replay_remember(mem: GradReplay, grads: dict, loss_critic: torch.Tensor,
                    loss_mse: torch.Tensor) -> GradReplay:
    """Append a batch of B episodes (leaves (B, *shape), losses (B,)) in
    order, with deque(maxlen=capacity) semantics: the same buffer as B
    single appends."""
    capacity = mem.loss_critic.shape[0]
    b = loss_critic.shape[0]
    keep = min(b, capacity)        # only the last `capacity` appends survive
    first = b - keep
    dev = mem.loss_critic.device
    slots = (mem.ptr + first + torch.arange(keep, device=dev, dtype=torch.long)) % capacity
    for k, buf in mem.grads.items():
        buf.index_copy_(0, slots, grads[k][first:].to(buf.dtype))
    mem.loss_critic.index_copy_(0, slots, loss_critic[first:].to(mem.loss_critic.dtype))
    mem.loss_mse.index_copy_(0, slots, loss_mse[first:].to(mem.loss_mse.dtype))
    mem.count = min(mem.count + b, capacity)
    mem.ptr = (mem.ptr + b) % capacity
    return mem


def replay_last(mem: GradReplay, n: int) -> dict:
    """The last `n` remembered gradients (n <= capacity), oldest first."""
    capacity = mem.loss_critic.shape[0]
    slots = (mem.ptr - n + torch.arange(n, device=mem.loss_critic.device, dtype=torch.long)) % capacity
    return {k: g.index_select(0, slots) for k, g in mem.grads.items()}


def adam_init(params: dict) -> AdamState:
    return AdamState(count=0, mu={k: torch.zeros_like(p) for k, p in params.items()},
                     nu={k: torch.zeros_like(p) for k, p in params.items()})


def decayed_lr(count: int, lr: float, decay: float) -> float:
    """optax `exponential_decay(lr, transition_steps=100, decay)` at update
    `count` (0-based), or the constant `lr` when `decay == 1`.  The decayed
    rate is computed in float32, as optax computes it from its int32 step
    count."""
    if decay == 1.0:
        return lr
    f32 = torch.float32  # fp32-island(optax's decayed rate is float32 from its int32 count)
    rate = torch.tensor(lr, dtype=f32) * torch.pow(
        torch.tensor(decay, dtype=f32), torch.tensor(count, dtype=f32) / 100.0)
    return rate.item()


def clip_by_leaf_norm(grads: list, max_norm: float) -> list:
    """Keras `clipnorm`: scale each leaf down to norm `max_norm`."""
    norms = torch.stack(torch._foreach_norm(grads))
    scales = torch.where(norms > max_norm, max_norm / (norms + 1e-16), 1.0)
    return [g * sc for g, sc in zip(grads, scales.unbind())]


def adam_step(params: list, grads: list, mu: list, nu: list, count: int, lr: float):
    """One Adam update (optax `scale_by_adam` with eps=1e-7, then
    `scale_by_learning_rate`) of lists of leaves, `count` updates before
    it: returns (params, mu, nu), new lists."""
    mu = torch._foreach_add(torch._foreach_mul(mu, B1), torch._foreach_mul(grads, 1 - B1))
    nu = torch._foreach_add(torch._foreach_mul(nu, B2),
                            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2))
    t = count + 1
    mu_hat = torch._foreach_div(mu, 1 - B1 ** t)
    den = torch._foreach_sqrt(torch._foreach_div(nu, 1 - B2 ** t))
    torch._foreach_add_(den, KERAS_EPS)
    step = torch._foreach_div(mu_hat, den)
    return torch._foreach_add(params, torch._foreach_mul(step, -lr)), mu, nu


@dataclasses.dataclass(frozen=True)
class Adam:
    """The optimizer of record as a value (JAX `make_optimizer`, `:108-122`):
    Keras `clipnorm` per leaf, then Adam with the decayed rate.  `update`
    takes one gradient per parameter (no batch axis) and returns the new
    parameters and state; it skips nothing (the replay's non-finite skip is
    `replay_apply`'s)."""

    lr: float = 1e-4
    decay: float = 1.0
    clipnorm: float = 1.0

    def init(self, params: dict) -> AdamState:
        return adam_init(params)

    def update(self, grads: dict, state: AdamState, params: dict) -> tuple:
        names = list(params)
        g = clip_by_leaf_norm([grads[k] for k in names], self.clipnorm)
        p, mu, nu = adam_step([params[k] for k in names], g, [state.mu[k] for k in names],
                              [state.nu[k] for k in names], state.count,
                              decayed_lr(state.count, self.lr, self.decay))
        return dict(zip(names, p)), AdamState(count=state.count + 1, mu=dict(zip(names, mu)),
                                              nu=dict(zip(names, nu)))


def make_optimizer(cfg) -> Adam:
    """`Adam` with a Config's `learning_rate`, `learning_decay` and
    `clipnorm`."""
    return Adam(lr=cfg.learning_rate, decay=cfg.learning_decay, clipnorm=cfg.clipnorm)


def apply_max_norm_constraint(params: dict, max_value: float) -> dict:
    """Keras `max_norm(axis=0)` on every leaf: w * clip(n, 0, max) / (eps + n)
    with n the norms over axis 0."""
    return dict(zip(params, _max_norm(list(params.values()), max_value)))


def _max_norm(leaves: list, max_value: float) -> list:
    norms = torch._foreach_sqrt([torch.sum(w * w, dim=0, keepdim=True) for w in leaves])
    scale = torch._foreach_div(torch._foreach_clamp_max(norms, max_value),
                               torch._foreach_add(norms, KERAS_EPS))
    return [w * sc for w, sc in zip(leaves, scale)]


def sample_indices(mem: GradReplay, batch: int, gen: torch.Generator | None = None):
    """`batch` filled slots drawn uniformly without replacement: the top
    scores of uniform draws over the filled prefix, as the JAX Gumbel top-k
    draws them (with torch's random numbers)."""
    capacity = mem.loss_critic.shape[0]
    dev = mem.loss_critic.device
    scores = torch.rand((capacity,), generator=gen,
                        device=gen.device if gen is not None else "cpu").to(dev)
    filled = torch.arange(capacity, device=dev, dtype=torch.long) < mem.count
    scores = torch.where(filled, scores, -torch.inf)
    return torch.topk(scores, batch).indices


@phase("replay_apply")
def replay_apply(mem: GradReplay, params: dict, opt: AdamState, batch: int,
                 lr: float = 1e-4, decay: float = 1.0,
                 clipnorm: float = 1.0, max_norm: float = 1.0,
                 gen: torch.Generator | None = None, idx: torch.Tensor | None = None):
    """Apply `batch` stored gradients one after another (indices `idx`, or
    drawn with `gen`).  The caller ensures `mem.count >= batch`.

    A sample whose stored loss or gradient is not finite is skipped and
    counted: params and Adam state pass through untouched.  The finiteness
    of all samples is read at once, the replay's one host sync.  Returns
    (params, state, mean critic loss of the finite samples as a tensor (NaN
    when none), number skipped)."""
    if idx is None:
        idx = sample_indices(mem, batch, gen)
    idx = idx.to(mem.loss_critic.device)
    names = list(params)
    sampled = [mem.grads[k].index_select(0, idx) for k in names]
    losses = mem.loss_critic.index_select(0, idx)
    ok = torch.isfinite(losses)
    for g in sampled:
        ok = ok & torch.isfinite(g.flatten(1)).all(dim=1)
    ok = ok.tolist()
    p = [params[k] for k in names]
    mu = [opt.mu[k] for k in names]
    nu = [opt.nu[k] for k in names]
    count = opt.count
    for s, good in enumerate(ok):
        if not good:
            continue
        g = clip_by_leaf_norm([leaf[s] for leaf in sampled], clipnorm)
        p, mu, nu = adam_step(p, g, mu, nu, count, decayed_lr(count, lr, decay))
        p = _max_norm(p, max_norm)
        count += 1
    fin = torch.isfinite(losses)
    nfin = fin.sum()
    mean = torch.where(fin, losses, 0.0).sum() / nfin.clamp_min(1)
    mean = torch.where(nfin > 0, mean, torch.nan)
    return (dict(zip(names, p)),
            AdamState(count=count, mu=dict(zip(names, mu)), nu=dict(zip(names, nu))),
            mean, len(ok) - sum(ok))
