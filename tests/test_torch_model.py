"""PyTorch port, models/: ChebNet against the flax ChebNet in float64.

`params_from_jax` on a `ChebNet.init` tree; forwards for K=1 and K=2 within
1e-12; the committed weight file equal to `restore_checkpoint_raw` of the
checkpoints it was taken from.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.models.chebconv import chebyshev_support as jcheb_support
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models import chebconv as tcheb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph(rng, e, p=0.15):
    a = np.triu((rng.uniform(size=(e, e)) < p).astype(np.float64), 1)
    a = a + a.T
    mask = np.ones(e, bool)
    mask[-3:] = False
    a[~mask] = 0
    a[:, ~mask] = 0
    return a, mask


@pytest.mark.parametrize("k,layers,hidden", [(1, 3, 8), (2, 2, 8), (3, 3, 6)])
def test_chebnet_forward_matches_flax(k, layers, hidden):
    rng = np.random.default_rng(k)
    e = 30
    a, mask = _graph(rng, e)
    x = rng.uniform(-1, 3, (2, e, 4))
    jmodel = JChebNet(num_layer=layers, hidden=hidden, k=k,
                      param_dtype=jnp.float64)
    sup = np.asarray(jcheb_support(jnp.asarray(a), jnp.asarray(mask)))
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(k),
                                           jnp.asarray(x[0]), jnp.asarray(sup)))
    expect = np.stack([np.asarray(jmodel.apply(variables, jnp.asarray(xb),
                                               jnp.asarray(sup)))
                       for xb in x])

    tmodel = tcheb.ChebNet(num_layer=layers, hidden=hidden, k=k,
                           dtype=torch.float64)
    tmodel.load_state_dict(tcheb.params_from_jax(variables))
    tsup = tcheb.chebyshev_support(torch.from_numpy(a), torch.from_numpy(mask))
    np.testing.assert_allclose(tsup.numpy(), sup, rtol=1e-12, atol=1e-15)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), tsup.expand(2, e, e)).numpy()
    assert got.shape == (2, e, 1)
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-14)


def test_make_model_shapes_follow_config():
    cfg = Config(num_layer=3, hidden=8, cheb_k=2)
    model = tcheb.make_model(cfg, dtype=torch.float64,
                             generator=torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {
        "layers.0.kernel": (2, 4, 8), "layers.0.bias": (8,),
        "layers.1.kernel": (2, 8, 8), "layers.1.bias": (8,),
        "layers.2.kernel": (2, 8, 1), "layers.2.bias": (1,),
    }
    assert float(model.layers[2].bias.detach()) == pytest.approx(0.1)


def test_committed_weights_equal_checkpoints():
    import importlib.util

    from multihop_offload_tpu.train.checkpoints import restore_checkpoint_raw

    spec = importlib.util.spec_from_file_location(
        "export_torch_port_data",
        os.path.join(ROOT, "scripts", "export_torch_port_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, path in mod.CHECKPOINTS.items():
        params = restore_checkpoint_raw(os.path.join(ROOT, path))["params"]
        committed = tcheb.load_weights(name)["params"]
        assert sorted(committed) == sorted(params)
        for layer, leaves in params.items():
            for leaf, val in leaves.items():
                got = committed[layer][leaf]
                assert got.dtype == np.asarray(val).dtype
                np.testing.assert_array_equal(got, np.asarray(val))
    k1 = tcheb.load_model("SCRATCH800_decay0.99", device="cpu")
    k2 = tcheb.load_model("SPECTRAL_K2", device="cpu")
    assert (k1.k, k1.num_layer, k2.k) == (1, 5, 2)
    assert k1.layers[0].kernel.shape == (1, 4, 32)
