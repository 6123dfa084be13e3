"""PyTorch port, the bf16 APSP kernels' arithmetic against its definition
and against the JAX package on the CPU.

K2 and K3 in bf16 (`csrc/minplus_bf16.cu`, `csrc/blocked_fw_bf16.cu`) take
each candidate as one packed `__hadd2`, the correctly rounded bf16 sum, and
one `__hmin2`.  Their plain versions, which the kernels are held to bit for
bit on the card, add in bf16 as the CPU does.  Bars:

* on bf16 pairs of every exponent (subnormals, zeros and infinities
  included), the CPU's bf16 add and the fp32 add rounded once to bf16 both
  equal the correctly rounded exact sum: the float64 sum (exact or within
  one rounding at 53 bits, which 53 >= 2 * 8 + 2 makes innocuous) rounded
  to nearest-even at bf16's 8 bits, subnormals at bf16's smallest quantum
  and overflow to infinity;
* `minplus_closure_plain` and `blocked_fw_plain` in bf16 against the TPU
  kernels `minplus_power_kernel_call` and `blocked_fw_call` in interpret
  mode on the same bf16 input, compiled with excess precision off
  (`strict_jit`), bit for bit at (2, 128) and (1, 256).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from multihop_offload_tpu.ops.minplus import blocked_fw_call, minplus_power_kernel_call
from multihop_offload_tpu_torch.ops import minplus as tmp
from tests.test_torch_bf16_backward import bits, strict_jit
from tests.test_torch_ops import _weights
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

BF = jnp.bfloat16
_MIN_EXP = -126   # bf16's smallest normal exponent (fp32's)
_BITS = 8         # bf16's significant bits
_OVERFLOW = 2.0 ** 128


def _bf16(pattern: np.ndarray) -> torch.Tensor:
    """bf16 values from their 16-bit patterns."""
    return torch.from_numpy(np.asarray(pattern, np.uint16).astype(np.int16)).view(torch.bfloat16)


def _patterns(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().astype(np.uint16)


def rne_bf16(s: np.ndarray) -> np.ndarray:
    """float64 values rounded to nearest-even at bf16's precision, as
    float64: 8 significant bits for a normal result, the quantum 2^-133
    below 2^-126, +-inf from the halfway point past the largest finite."""
    s = np.asarray(s, np.float64)
    mag = np.abs(s)
    _, e = np.frexp(mag)  # mag = m 2^e, 0.5 <= m < 1
    quantum = np.ldexp(1.0, np.maximum(e - 1, _MIN_EXP) - (_BITS - 1))
    with np.errstate(invalid="ignore"):
        r = np.rint(mag / quantum) * quantum  # np.rint: ties to even
    r = np.where(np.isinf(mag), np.inf, np.where(mag == 0, 0.0, r))
    r = np.where(r >= _OVERFLOW, np.inf, r)
    return np.copysign(r, s)


def _check_sums(a: np.ndarray, b: np.ndarray) -> None:
    """The three sums of the bf16 patterns `a` and `b` (no NaN, no inf +
    -inf) are the same bits."""
    ta, tb = _bf16(a), _bf16(b)
    want = torch.from_numpy(rne_bf16(ta.double().numpy() + tb.double().numpy()))
    want = _patterns(want.to(torch.bfloat16))  # exact: every value is a bf16
    cpu = _patterns(ta + tb)
    widened = _patterns((ta.float() + tb.float()).to(torch.bfloat16))
    bad = np.flatnonzero((cpu != want) | (widened != want))
    assert bad.size == 0, (
        f"{bad.size} sums differ, first: {hex(a.flat[bad[0]])} + {hex(b.flat[bad[0]])}: "
        f"cpu {hex(cpu.flat[bad[0]])}, fp32 rounded {hex(widened.flat[bad[0]])}, "
        f"correctly rounded {hex(want.flat[bad[0]])}")


def _pattern(sign: int, exponent: int, mantissa: int) -> int:
    return (sign << 15) | (exponent << 7) | mantissa


# a bf16 of any sign and exponent field (0: zero and subnormals; 255: inf,
# its mantissa dropped so that no NaN is drawn)
bf16_patterns = st.builds(
    lambda s, e, m: _pattern(s, e, 0 if e == 255 else m),
    st.integers(0, 1), st.integers(0, 255), st.integers(0, 127))


@settings(max_examples=3000, deadline=None, derandomize=True, database=None)
@given(bf16_patterns, bf16_patterns)
def test_bf16_add_is_the_correctly_rounded_sum(a, b):
    """What the packed kernels' `__hadd2` computes, the plain versions'
    bf16 add computes: the correctly rounded sum, on pairs drawn over every
    exponent field."""
    inf_pair = {a & 0x7FFF, b & 0x7FFF} == {0x7F80} and (a ^ b) & 0x8000
    if not inf_pair:
        _check_sums(np.array([a]), np.array([b]))


def test_bf16_add_is_the_correctly_rounded_sum_on_every_pattern():
    """Every non-NaN bf16 against one operand of each sign and exponent
    field (the mantissas from a seed): 65,282 x 512 sums, the carries
    into a new exponent, the subnormal range and the overflow to +-inf
    among them; inf + -inf (NaN) left out."""
    every = np.arange(1 << 16, dtype=np.uint32)
    nan = ((every & 0x7F80) == 0x7F80) & ((every & 0x7F) != 0)
    finite_or_inf = every[~nan].astype(np.uint16)
    rng = np.random.default_rng(17)
    others = np.array([_pattern(s, e, 0 if e == 255 else int(rng.integers(0, 128)))
                       for s in (0, 1) for e in range(256)], np.uint16)
    assert finite_or_inf.size == 65282 and others.size == 512
    for chunk in np.array_split(others, 16):
        a = np.repeat(finite_or_inf[None, :], chunk.size, axis=0)
        b = np.repeat(chunk[:, None], finite_or_inf.size, axis=1)
        inf_pair = ((a & 0x7FFF) == 0x7F80) & ((b & 0x7FFF) == 0x7F80) & ((a ^ b) >= 0x8000)
        _check_sums(a[~inf_pair], b[~inf_pair])


def _symmetric_bf16(b: int, n: int):
    """(b, n, n) symmetric distances (an edge with probability 4 / n, U(0.1,
    5), +inf elsewhere, zero diagonal) from `default_rng(n)`, narrowed to
    bf16 for torch and for JAX."""
    w = _weights(np.random.default_rng(n), b, n, 4.0 / n).astype(np.float32)
    for k in range(b):
        np.fill_diagonal(w[k], 0.0)
    t = torch.from_numpy(w).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(BF)


@pytest.mark.parametrize("kernel", ["minplus", "blocked_fw"])
@pytest.mark.parametrize("b,n", [(2, 128), (1, 256)])
def test_plain_bf16_bit_identical_to_the_jax_kernel(kernel, b, n):
    """The plain versions the bf16 kernels are held to equal the TPU kernels
    in interpret mode on bf16, bit for bit: `minplus_closure_plain` over
    ceil(log2(N - 1)) squarings (its early stop changes nothing: a squaring
    that changes nothing is a fixed point) against
    `minplus_power_kernel_call`, and `blocked_fw_plain` on 128 tiles
    against `blocked_fw_call`."""
    d, jd = _symmetric_bf16(b, n)
    if kernel == "minplus":
        iters = math.ceil(math.log2(n - 1))
        assert iters == tmp.squaring_count(n)
        got = tmp.minplus_closure_plain(d, iters)
        want = strict_jit(lambda x: minplus_power_kernel_call(x, iters, interpret=True), jd)
        wide = tmp.minplus_closure_plain(d.float(), iters).to(torch.bfloat16)
    else:
        got = tmp.blocked_fw_plain(d)
        want = strict_jit(lambda x: blocked_fw_call(x, interpret=True), jd)
        wide = tmp.blocked_fw_plain(d.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(bits(got), bits(want))
    # paths of several hops: each hop's rounding shows against the float32
    # closure narrowed once
    assert not torch.equal(got, wide)
