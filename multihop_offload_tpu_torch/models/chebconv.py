"""Chebyshev-polynomial spectral graph convolutions as `nn.Module`s.

Port of `multihop_offload_tpu/models/chebconv.py` (fp32/fp64 identity
precision, no dropout).  The kernel keeps the flax layout (k, in, out), so
`params_from_jax` copies a flax parameter tree as it is.  The feature
product ``x @ W_k`` stays `torch.matmul` (cuBLAS on the card), as the JAX
package leaves it to XLA.

The support propagation is a hook (`propagate`, `:54`, `:72-81`): the
dense layout's (E, E) @ (E, F) `torch.matmul`, or under the sparse layout
`ops.chebconv.chebconv_propagate` over a `layouts.sparse.SparseSupport`
(K4 on the card, its plain version on the CPU).  `make_model(cfg, layout)`
picks it (`:257-294`).  At K = 1 a layer never propagates.

Parameters may carry a leading batch axis, one copy per episode (kernel
(B, k, in, out), bias (B, out)): `torch.matmul` broadcasts
(B, E, F) @ (B, F, C), so one backward over a batch of independent
episodes gives each episode's own gradient (`agent.train_step` swaps them
in with `torch.func.functional_call`).
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
from multihop_offload_tpu_torch.ops.chebconv import chebconv_propagate


class ChebConv(nn.Module):
    """One Chebyshev graph-convolution layer: sum_k T_k(A~) X W_k + b."""

    def __init__(self, in_features: int, channels: int, k: int = 1,
                 bias_init: float = 0.0, dtype=torch.float32,
                 generator: torch.Generator | None = None, propagate=None):
        super().__init__()
        self.k = k
        self.propagate = propagate  # (support, x) -> support @ x; None: matmul
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
        w = [self.kernel.select(-3, i) for i in range(self.k)]
        t_prev2 = x
        out = torch.matmul(t_prev2, w[0])
        if self.k > 1:
            t_prev = prop(support, x)
            out = out + torch.matmul(t_prev, w[1])
            for i in range(2, self.k):
                t_cur = 2.0 * prop(support, t_prev) - t_prev2
                out = out + torch.matmul(t_cur, w[i])
                t_prev2, t_prev = t_prev, t_cur
        return out + self.bias.unsqueeze(-2)


class ChebNet(nn.Module):
    """The actor stack: ChebConv(hidden, leaky_relu) x (num_layer - 1) ->
    ChebConv(1, relu).  Input (..., E, 4) features, (..., E, E) support.
    The output layer's bias starts at 0.1, as the JAX model's does (a zero
    bias leaves a relu output dead at birth for about half of all seeds)."""

    def __init__(self, num_layer: int = 5, hidden: int = 32, k: int = 1,
                 leaky_alpha: float = 0.2, dtype=torch.float32,
                 generator: torch.Generator | None = None, propagate=None):
        super().__init__()
        self.k = k
        self.num_layer = num_layer
        self.leaky_alpha = leaky_alpha
        self.propagate = propagate
        widths = [4] + [hidden] * (num_layer - 1) + [1]
        self.layers = nn.ModuleList(
            ChebConv(widths[i], widths[i + 1], k,
                     bias_init=0.1 if i == num_layer - 1 else 0.0,
                     dtype=dtype, generator=generator, propagate=propagate)
            for i in range(num_layer)
        )

    def forward(self, x: torch.Tensor, support) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, support)
            x = (F.relu(x) if i == self.num_layer - 1
                 else F.leaky_relu(x, self.leaky_alpha))
        return x


def chebyshev_support(adj: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Rescaled Laplacian 2 L_sym / lmax - I at lmax = 2, with
    L_sym = I - D^-1/2 A D^-1/2, masked so padded rows stay zero.  Any
    leading batch axes."""
    deg = adj.sum(dim=-1)
    pos = deg > 0
    inv_sqrt = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, deg, 1.0)), 0.0)
    a_norm = adj * inv_sqrt.unsqueeze(-1) * inv_sqrt.unsqueeze(-2)
    valid = pos if mask is None else (mask & pos)
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device) \
        * valid.to(adj.dtype).unsqueeze(-2)
    lap = eye - a_norm
    return lap - eye  # (2 / lmax) * lap is lap itself at lmax = 2


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


def make_model(cfg: Config, dtype=torch.float32,
               generator: torch.Generator | None = None, layout=None) -> ChebNet:
    """The actor stack for `cfg`, with glorot weights from `generator`, for
    `layout` (default `cfg.layout`).  Parameters do not depend on the
    layout: the same weights load either way."""
    return ChebNet(num_layer=cfg.num_layer, hidden=cfg.hidden, k=cfg.cheb_k,
                   leaky_alpha=cfg.leaky_relu_alpha, dtype=dtype,
                   generator=generator,
                   propagate=layout_propagate(layout or cfg.layout))


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


def load_model(name: str, dtype=torch.float32, device=None, layout=None) -> ChebNet:
    """A `ChebNet` shaped like the committed model `name`, with its weights,
    on `device` (default CUDA), for `layout` (default dense)."""
    params = load_weights(name)["params"]
    k, _, hidden = params["cheb_0"]["kernel"].shape
    model = ChebNet(num_layer=len(params), hidden=int(hidden), k=int(k),
                    dtype=dtype, propagate=layout_propagate(layout))
    model.load_state_dict({key: val.to(dtype) for key, val
                           in params_from_jax(params).items()})
    return model.to(resolve_device(device))
