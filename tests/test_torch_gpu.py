"""PyTorch port on the card: each CUDA kernel against its plain version.

Marked `gpu`; every test takes the `cuda` fixture, which skips when no CUDA
card is present (decided inside the fixture, so every collecting worker
sees the same tests).  This file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import math

import numpy as np
import pytest
import torch

from multihop_offload_tpu_torch.env.apsp import apsp_minplus
from multihop_offload_tpu_torch.ops import fixed_point as tfp
from multihop_offload_tpu_torch.ops import minplus as tmp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _weights(rng, b, n, p):
    w = np.full((b, n, n), np.inf, dtype=np.float32)
    for k in range(b):
        iu, ju = np.where(np.triu(rng.uniform(size=(n, n)) < p, 1))
        vals = rng.uniform(0.1, 5.0, iu.size).astype(np.float32)
        w[k, iu, ju] = w[k, ju, iu] = vals
    return torch.from_numpy(w)


@pytest.mark.parametrize("b,n", [(3, 7), (5, 37), (4, 112), (2, 256), (1, 300)])
def test_minplus_kernel_bit_identical(cuda, b, n):
    w = _weights(np.random.default_rng(n), b, n, 3.0 / n).to(cuda)
    before = tmp.minplus_closure_cuda.launches
    got = apsp_minplus(w)
    expect = apsp_minplus(w.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), expect)
    # the same schedule as apsp_minplus: ceil(log2(N-1)) squarings at most
    # (more squarings can still lower an entry by an ulp: fp addition is
    # not associative, so the closure is not a fixed point bit for bit)
    iters = max(1, math.ceil(math.log2(max(n - 1, 2))))
    plain = tmp.minplus_closure_plain(
        torch.where(torch.eye(n, dtype=torch.bool, device=cuda), 0.0, w), iters)
    assert torch.equal(got, plain)
    assert tmp.minplus_closure_cuda.launches > before


def test_minplus_kernel_leaves_input_and_stops_early(cuda):
    w = _weights(np.random.default_rng(1), 4, 64, 0.2).to(cuda)
    d = torch.where(torch.eye(64, dtype=torch.bool, device=cuda), 0.0, w)
    keep = d.clone()
    counter0 = (0 if tmp.minplus_closure_cuda.executed is None
                else int(tmp.minplus_closure_cuda.executed))
    out = tmp.minplus_closure_cuda(d, 30)
    torch.cuda.synchronize()
    assert torch.equal(d, keep)
    assert torch.equal(out, tmp.minplus_closure_plain(d, 30))
    ran = int(tmp.minplus_closure_cuda.executed) - counter0
    assert 4 <= ran < 4 * 30  # converged matrices skip the rest of the schedule


@pytest.mark.parametrize("b,l", [(2, 24), (64, 216), (4, 504), (1, 928)])
def test_fixed_point_kernel_matches_plain(cuda, b, l):
    rng = np.random.default_rng(l)
    a = np.triu((rng.uniform(size=(b, l, l)) < 8.0 / l).astype(np.float32), 1)
    a = a + np.swapaxes(a, 1, 2)
    rates = rng.uniform(30, 70, (b, l)).round().astype(np.float32)
    lam = rng.uniform(0, 60, (b, l)).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (a, rates, a.sum(1), lam)]
    before = tfp.fixed_point_cuda.launches
    got = tfp.fixed_point(*args)
    expect = tfp.fixed_point_plain(*args)
    torch.cuda.synchronize()
    assert tfp.fixed_point_cuda.launches == before + 1
    rel = ((got - expect).abs() / expect.abs()).max().item()
    assert rel <= 1e-5, rel


def test_fixed_point_kernel_checks_operands(cuda):
    x = torch.zeros((1, 8, 8), device=cuda)
    with pytest.raises(TypeError):
        tfp.fixed_point_cuda(x.double(), x[:, 0].double(), x[:, 0].double(),
                             x[:, 0].double())
    with pytest.raises(ValueError):
        tfp.fixed_point_cuda(x, x[:, 0], x[:, 0], x[:, :4, 0])
    with pytest.raises(ValueError):
        tfp.fixed_point_cuda(x.transpose(1, 2), x[:, 0], x[:, 0], x[:, 0])
    big = torch.zeros((1, 929, 929), device=cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        tfp.fixed_point_cuda(big, big[:, 0], big[:, 0], big[:, 0])


def test_eval_methods_card_matches_cpu(cuda):
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.train.driver import eval_methods

    inst, jobs, _ = request_batch(load_cases("paper")[2:6], 2, seed=1,
                                  device="cpu")
    model = load_model("SCRATCH800_decay0.99", device="cpu")
    cpu = eval_methods(model, inst, jobs, device="cpu")
    card = eval_methods(model, inst, jobs, device=cuda)
    m = jobs.mask
    for c, g in zip(cpu, card):
        assert torch.isfinite(g.cpu()[m]).all()
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=0)
