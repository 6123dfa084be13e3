"""Chebyshev-polynomial spectral graph convolutions as `nn.Module`s.

Port of `multihop_offload_tpu/models/chebconv.py`.  The kernel keeps the flax layout (k, in, out), so
`params_from_jax` copies a flax parameter tree as it is.  The feature
product ``x @ W_k`` stays `torch.matmul` (cuBLAS on the card), as the JAX
package leaves it to XLA.

The support propagation is a hook (`propagate`, `:54`, `:72-81`): the
dense layout's (E, E) @ (E, F) `torch.matmul`, or under the sparse layout
`ops.chebconv.chebconv_propagate` over a `layouts.sparse.SparseSupport`
(K4 on the card, its plain version on the CPU).  `make_model(cfg, layout)`
picks it (`:257-294`).  At K = 1 a layer never propagates.

Mixed precision (`precision.PrecisionPolicy`, JAX `:42-90`): with a
`compute_dtype` the layer narrows x, the support and its kernel to it, the
Chebyshev recursion runs in it, and each feature product accumulates in
`accum_dtype` (fp32): bf16 operands widened to fp32, which is what XLA's
``preferred_element_type`` product computes (``torch.matmul`` of two bf16
tensors would round its output to bf16).  Parameters stay `param_dtype`.
Under autograd the `.to` casts give the kernel's gradient as JAX's
transpose of its `preferred_element_type` product gives it: the fp32
product rounded to the bf16 operand, then widened to the fp32 parameter;
the sparse propagate's backward is K4's bf16 transposed walk.

Without a compute dtype the feature products take the promoted dtype of
their operands, as `jnp.matmul` does: bf16 parameters (the identity
policy at `dtype=bfloat16`) against float32 features (the RL fleet's)
compute in float32, and the kernel's gradient is rounded back to bf16.

Parameters may carry a leading batch axis, one copy per episode (kernel
(B, k, in, out), bias (B, out)): `torch.matmul` broadcasts
(B, E, F) @ (B, F, C), so one backward over a batch of independent
episodes gives each episode's own gradient (`agent.train_step` swaps them
in with `torch.func.functional_call`).

Dropout (JAX `:101,125`: an `nn.Dropout` before every layer): the model
carries the rate; `forward(x, support, masks)` takes one keep mask a
layer, each shaped like that layer's input, and computes
`torch.where(mask, x / keep, 0)` as flax's `lax.select(mask, x /
keep_prob, 0)` does (a rate of 0 leaves x as it is, 1 zeroes it).
`dropout_masks(b, e, gens)` draws them, `rand < keep` as flax's
`bernoulli(key, keep_prob)`, each episode's from its own generator, layer
by layer; a test feeds JAX's masks in through `masks`.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import SparseSupport
from multihop_offload_tpu_torch.ops.chebconv import chebconv_propagate
from multihop_offload_tpu_torch.ops.sparse import COO
from multihop_offload_tpu_torch.precision import island_dtype


class ChebConv(nn.Module):
    """One Chebyshev graph-convolution layer: sum_k T_k(A~) X W_k + b."""

    def __init__(self, in_features: int, channels: int, k: int = 1,
                 bias_init: float = 0.0, dtype=torch.float32,  # fp32-island(params: bf16 loses small updates)
                 generator: torch.Generator | None = None, propagate=None,
                 compute_dtype=None, accum_dtype=None):
        super().__init__()
        self.k = k
        self.propagate = propagate  # (support, x) -> support @ x; None: matmul
        # None: everything in the input dtype (the identity policy)
        self.compute_dtype = compute_dtype
        self.accum_dtype = accum_dtype
        kernel = torch.empty((k, in_features, channels), dtype=dtype)
        # glorot uniform over (in, out) per order, as flax's variance_scaling
        # (1.0, fan_avg, uniform, in_axis=-2, out_axis=-1) draws it
        fan_in, fan_out = in_features * k, channels * k
        limit = math.sqrt(3.0 * 2.0 / (fan_in + fan_out))
        kernel.uniform_(-limit, limit, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.full((channels,), bias_init, dtype=dtype))

    def forward(self, x: torch.Tensor, support) -> torch.Tensor:
        prop = self.propagate or torch.matmul
        # kernel (k, in, out) or per episode (B, k, in, out)
        kernel = self.kernel
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
            support = cast_support(support, self.compute_dtype)
            kernel = kernel.to(self.compute_dtype)
            acc = self.accum_dtype

            def feat_mm(t, w):
                # narrow operands, wide accumulation: bf16 x bf16 products
                # are exact in fp32, summed in fp32, never rounded to bf16
                return torch.matmul(t.to(acc), w.to(acc))
        else:
            def feat_mm(t, w):
                # `jnp.matmul` promotes mixed operands (bf16 parameters under
                # `dtype=bfloat16` against float32 features: f32), torch
                # refuses them; no-op casts where the dtypes agree
                wide = torch.promote_types(t.dtype, w.dtype)
                return torch.matmul(t.to(wide), w.to(wide))
        w = [kernel.select(-3, i) for i in range(self.k)]
        t_prev2 = x
        out = feat_mm(t_prev2, w[0])
        if self.k > 1:
            t_prev = prop(support, x)
            out = out + feat_mm(t_prev, w[1])
            for i in range(2, self.k):
                t_cur = 2.0 * prop(support, t_prev) - t_prev2
                out = out + feat_mm(t_cur, w[i])
                t_prev2, t_prev = t_prev, t_cur
        return out + self.bias.unsqueeze(-2)


def cast_support(support, dtype):
    """A dense support, or a `SparseSupport`'s values and diagonal, in
    `dtype` (its indices and CSR index unchanged)."""
    if isinstance(support, SparseSupport):
        e = support.edges
        return SparseSupport(
            edges=COO(rows=e.rows, cols=e.cols, vals=e.vals.to(dtype), shape=e.shape),
            diag=support.diag.to(dtype), csr=support.csr)
    if isinstance(support, COO):
        return COO(rows=support.rows, cols=support.cols, vals=support.vals.to(dtype),
                   shape=support.shape)
    return support.to(dtype)


class ChebNet(nn.Module):
    """The actor stack: ChebConv(hidden, leaky_relu) x (num_layer - 1) ->
    ChebConv(1, relu).  Input (..., E, 4) features, (..., E, E) support.
    The output layer's bias starts at 0.1, as the JAX model's does (a zero
    bias leaves a relu output dead at birth for about half of all seeds).
    `dropout` is the rate of the masks `forward` takes."""

    def __init__(self, num_layer: int = 5, hidden: int = 32, k: int = 1,
                 leaky_alpha: float = 0.2, dtype=torch.float32,  # fp32-island(params: bf16 loses small updates)
                 generator: torch.Generator | None = None, propagate=None,
                 compute_dtype=None, accum_dtype=None, dropout: float = 0.0):
        super().__init__()
        self.k = k
        self.num_layer = num_layer
        self.dropout = float(dropout)
        self.widths = [4] + [hidden] * (num_layer - 1) + [1]
        self.leaky_alpha = leaky_alpha
        self.propagate = propagate
        widths = self.widths
        self.layers = nn.ModuleList(
            ChebConv(widths[i], widths[i + 1], k,
                     bias_init=0.1 if i == num_layer - 1 else 0.0,
                     dtype=dtype, generator=generator, propagate=propagate,
                     compute_dtype=compute_dtype, accum_dtype=accum_dtype)
            for i in range(num_layer)
        )

    def dropout_masks(self, b: int, e: int, gens, device=None) -> list:
        """Keep masks (B, E, in_i) for every layer, episode b's drawn from
        `gens[b]` (`rand < keep`, layer after layer)."""
        keep = 1.0 - self.dropout
        per_ep = [[torch.rand((e, w), generator=g, device=device) < keep
                   for w in self.widths[:-1]] for g in gens[:b]]
        return [torch.stack([m[i] for m in per_ep]) for i in range(self.num_layer)]

    def forward(self, x: torch.Tensor, support, masks=None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            if masks is not None and self.dropout > 0.0:
                keep = 1.0 - self.dropout
                zero = torch.zeros((), dtype=x.dtype, device=x.device)
                x = zero.expand_as(x) if keep == 0.0 else torch.where(masks[i], x / keep, zero)
            x = layer(x, support)
            x = (F.relu(x) if i == self.num_layer - 1
                 else F.leaky_relu(x, self.leaky_alpha))
        return x


def chebyshev_support(adj: torch.Tensor, mask: torch.Tensor | None = None,
                      dtype=None) -> torch.Tensor:
    """Rescaled Laplacian 2 L_sym / lmax - I at lmax = 2, with
    L_sym = I - D^-1/2 A D^-1/2, masked so padded rows stay zero.  Any
    leading batch axes.  The `laplacian` fp32 island: built at >= fp32 and
    narrowed once to `dtype` (default: the adjacency's own dtype)."""
    out_dtype = adj.dtype if dtype is None else dtype
    adj = adj.to(island_dtype(adj.dtype))
    deg = adj.sum(dim=-1)
    pos = deg > 0
    inv_sqrt = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, deg, 1.0)), 0.0)
    a_norm = adj * inv_sqrt.unsqueeze(-1) * inv_sqrt.unsqueeze(-2)
    valid = pos if mask is None else (mask & pos)
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device) \
        * valid.to(adj.dtype).unsqueeze(-2)
    lap = eye - a_norm
    return (lap - eye).to(out_dtype)  # (2 / lmax) * lap is lap itself at lmax = 2


@torch.no_grad()
def ensure_alive_output(model: ChebNet, feats, support, mask=None) -> ChebNet:
    """Data-dependent init fixup for the dead-relu-at-birth pathology
    (JAX `models/chebconv.py:188-215`): if the probe emits zero on every
    valid slot, negate the output layer's kernel and bias in place.
    `mask` marks the probe's valid rows (padded rows see zero features and
    emit relu(bias) > 0)."""
    return ensure_alive_output_multi(model, [(feats, support, mask)])


@torch.no_grad()
def ensure_alive_output_multi(model: ChebNet, probes) -> ChebNet:
    """`ensure_alive_output` over several probes (JAX `:218-256`): the
    init must be alive on every probe.  `probes` are (feats, support, mask)
    triples with any leading batch axes; a probe is alive when some valid
    slot's output is positive.  The output layer's sign is flipped when
    that makes every probe alive; when neither sign does, the sign alive
    on more probes is kept with a warning, and a unit dead on all probes
    under both signs raises.  Returns `model`, changed in place."""
    probes = [(f, s, torch.ones(f.shape[:-1], dtype=torch.bool, device=f.device)
               if m is None else m) for (f, s, m) in probes]

    def alive_count() -> int:
        return sum(bool(((model(f, s)[..., 0] > 0) & m).any()) for (f, s, m) in probes)

    last = model.layers[model.num_layer - 1]

    def flip() -> None:
        last.kernel.neg_()
        last.bias.neg_()

    n_orig = alive_count()
    if n_orig == len(probes):
        return model
    flip()
    n_flip = alive_count()
    if n_flip == len(probes):
        return model
    if max(n_orig, n_flip) == 0:
        raise RuntimeError("output unit dead on all probes under both signs")
    import warnings

    if n_orig >= n_flip:
        flip()
    warnings.warn(
        f"output unit alive on only {max(n_orig, n_flip)}/{len(probes)} probe graphs "
        "under the better kernel sign; proceeding (gradients flow on the alive graphs)",
        RuntimeWarning, stacklevel=2)
    return model


def layout_propagate(layout=None):
    """The `propagate` hook of a layout: None (dense matmul) or the edge-list
    propagate of the sparse layout."""
    return chebconv_propagate if resolve_layout(layout).sparse else None


def _policy_dtypes(policy, dtype) -> dict:
    """ChebNet's dtype arguments under `policy` (None: the identity policy
    at `dtype`): params at `param_dtype`, and under the mixed policy the
    compute and accumulation dtypes."""
    if policy is None:
        return {"dtype": dtype}
    out = {"dtype": policy.param_dtype}
    if policy.mixed:
        out.update(compute_dtype=policy.compute_dtype, accum_dtype=policy.accum_dtype)
    return out


def make_model(cfg: Config, dtype=torch.float32,  # fp32-island(params: bf16 loses small updates)
               generator: torch.Generator | None = None, layout=None,
               policy=None) -> ChebNet:
    """The actor stack for `cfg`, with glorot weights from `generator`, for
    `layout` (default `cfg.layout`), under the precision `policy` (a
    `precision.PrecisionPolicy`; None: the identity policy at `dtype`).
    Parameters do not depend on the layout or the policy's compute dtype:
    the same weights load either way."""
    return ChebNet(num_layer=cfg.num_layer, hidden=cfg.hidden, k=cfg.cheb_k,
                   leaky_alpha=cfg.leaky_relu_alpha, generator=generator,
                   propagate=layout_propagate(layout or cfg.layout),
                   dropout=cfg.dropout, **_policy_dtypes(policy, dtype))


def params_from_jax(tree) -> dict:
    """A `ChebNet` state_dict from a flax parameter tree of numpy arrays:
    ``{"params": {"cheb_i": {"kernel": (k, in, out), "bias": (out,)}}}``
    or the inner ``params`` dict itself."""
    params = tree.get("params", tree)
    state = {}
    for i in range(len(params)):
        layer = params[f"cheb_{i}"]
        state[f"layers.{i}.kernel"] = torch.from_numpy(np.array(layer["kernel"]))
        state[f"layers.{i}.bias"] = torch.from_numpy(np.array(layer["bias"]))
    return state


WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "data", "weights.npz")


def load_weights(name: str, path: str = WEIGHTS_PATH) -> dict:
    """The flax parameter tree (numpy) of a committed model in `path`.

    `data/weights.npz` holds the ``params`` of two checkpoints of the JAX
    package (`scripts/export_torch_port_data.py` made it): the model of
    record ``SCRATCH800_decay0.99`` (K=1, 5 layers, width 32) and
    ``SPECTRAL_K2`` (K=2); and ``LARGE_K3_init``, the random K=3 initial
    parameters of `scripts/large_scale_demo.py`."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            model, layer, leaf = key.split("/")
            if model == name:
                params.setdefault(layer, {})[leaf] = z[key]
    if not params:
        raise KeyError(f"no model '{name}' in {path}")
    return {"params": params}


def load_model(name: str, dtype=torch.float32, device=None, layout=None,  # fp32-island(params: bf16 loses small updates)
               policy=None) -> ChebNet:
    """A `ChebNet` shaped like the committed model `name`, with its weights,
    on `device` (default CUDA), for `layout` (default dense), under the
    precision `policy` (None: the identity policy at `dtype`)."""
    params = load_weights(name)["params"]
    k, _, hidden = params["cheb_0"]["kernel"].shape
    dts = _policy_dtypes(policy, dtype)
    model = ChebNet(num_layer=len(params), hidden=int(hidden), k=int(k),
                    propagate=layout_propagate(layout), **dts)
    model.load_state_dict({key: val.to(dts["dtype"]) for key, val
                           in params_from_jax(params).items()})
    return model.to(resolve_device(device))
