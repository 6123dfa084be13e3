"""PyTorch port, the Trainer under the bf16 precision policy against the JAX
Trainer on the CPU, on the tiny dataset of `tests/test_torch_drivers.py`
at a float32 base: the parity harness of `test_trainer_matches_jax`
(`explore=0`, `batch=6`, `memory_size=32`, 4 files, 1 epoch, params
carried from the JAX harness, the JAX replay's indices injected), dense at
1 pad bucket and sparse at 2.

Bars (bf16 carries an 8-bit mantissa; the two packages round the same
values, but in places in another order):
* `baseline` and `local` rows: `congest_jobs` identical and `tau` within
  1e-2 relative on every row; `GNN` and `GNN-test` rows the same on >= 99%;
* replay losses within 1e-2 relative;
* final params: ||p_port - p_jax|| <= 0.05 ||p_jax - p0|| over all leaves;
* parameters, Adam moments and checkpoints stay float32, and a bf16
  Trainer resumes an fp32 Trainer's checkpoint bit for bit, and the
  reverse.

The JAX programs are compiled with excess precision off (`strict_xla`, see
`tests/test_torch_bf16_backward.py`): XLA's CPU compiler otherwise drops
bf16 roundings that the JAX program writes.
"""

import jax
import numpy as np
import pytest
import torch

from multihop_offload_tpu.train import driver as jd
from multihop_offload_tpu_torch.agent import replay as treplay
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models.chebconv import params_from_jax
from multihop_offload_tpu_torch.train import checkpoints as ckpt
from multihop_offload_tpu_torch.train import driver as td
from tests.test_torch_bf16_backward import strict_xla  # noqa: F401
from tests.test_torch_drivers import common, jax_config, read_rows, tiny  # noqa: F401
from tests.test_torch_trainer import TRAIN, jax_indices

RTOL = 1e-2
AGREEMENT_FLOOR = 0.99
PARAM_DRIFT = 0.05  # ||p_port - p_jax|| over ||p_jax - p0||


def bf16_kw(tiny, tmp_path, **kw):
    return {**common(tiny, tmp_path, **{**TRAIN, **kw}), "dtype": "float32",
            "precision": "bf16"}


def _norm(tree: dict) -> float:
    return float(np.sqrt(sum(float((v.double() ** 2).sum()) for v in tree.values())))


def row_agreement(got, want) -> dict:
    """Per method, the share of rows with identical `congest_jobs` and
    `tau` within `RTOL` relative (the rows in the same order)."""
    ok, n = {}, {}
    for g, w in zip(got, want):
        assert (g["fid"], g["filename"], g["method"], g["num_jobs"], g["n_instance"]) == (
            w["fid"], w["filename"], w["method"], w["num_jobs"], w["n_instance"])
        a, b = float(g["tau"]), float(w["tau"])
        m = g["method"]
        n[m] = n.get(m, 0) + 1
        ok[m] = ok.get(m, 0) + int(g["congest_jobs"] == w["congest_jobs"]
                                   and abs(a - b) <= RTOL * abs(b))
    return {m: ok[m] / n[m] for m in n}


@pytest.mark.parametrize("layout,buckets", [("dense", 1), ("sparse", 2)])
def test_trainer_bf16_matches_jax(tiny, tmp_path, monkeypatch, strict_xla, layout,  # noqa: F811
                                  buckets):
    kw = bf16_kw(tiny, tmp_path, layout=layout, pad_buckets=buckets)
    jt = jd.Trainer(jax_config(**kw))
    assert jt.precision.mixed
    p0 = jax.device_get(jt.variables["params"])
    keys = []
    inner = jt._replay

    def recording(mem, params, opt_state, key):
        keys.append((np.asarray(key), int(mem.count)))
        return inner(mem, params, opt_state, key=key)

    recording.account = inner.account
    jt._replay = recording
    want = read_rows(jt.run(verbose=False))

    indices = iter([jax_indices(k, c, TRAIN["memory_size"], TRAIN["batch"])
                    for k, c in keys])
    monkeypatch.setattr(treplay, "sample_indices",
                        lambda mem, batch, gen=None: torch.tensor(next(indices)))
    tt = td.Trainer(Config(**{**kw, "out": str(tmp_path / "port"),
                              "model_root": str(tmp_path / "port_model")}), device="cpu")
    assert tt.precision.mixed and tt.store == torch.bfloat16
    tt.model.load_state_dict(params_from_jax(p0))
    got = read_rows(tt.run(verbose=False))
    assert len(got) == len(want) == 4 * 4 * 4 and list(got[0]) == td.TRAIN_COLUMNS
    share = row_agreement(got, want)
    assert share["baseline"] == share["local"] == 1.0, share
    assert share["GNN"] >= AGREEMENT_FLOOR and share["GNN-test"] >= AGREEMENT_FLOOR, share
    assert next(indices, None) is None and len(keys) == len(tt.replay_losses) >= 2
    np.testing.assert_allclose(tt.replay_losses, jt.replay_losses, rtol=RTOL, atol=0)
    final = params_from_jax(jax.device_get(jt.variables["params"]))
    start = params_from_jax(p0)
    port = tt.params()
    moved = _norm({k: final[k].double() - start[k].double() for k in final})
    drift = _norm({k: port[k].double() - final[k].double() for k in final})
    assert moved > 0 and drift <= PARAM_DRIFT * moved, (drift, moved)
    # fp32 wherever the policy keeps it: params, Adam moments, checkpoints
    assert all(p.dtype == torch.float32 for p in port.values())
    assert all(v.dtype == torch.float32 for v in tt.state.opt.mu.values())
    assert all(v.dtype == torch.float32 for v in tt.state.opt.nu.values())
    saved = ckpt.restore_checkpoint_raw(tt._ckpt_dir())
    for part in (saved["params"], saved["opt_state"]["mu"], saved["opt_state"]["nu"]):
        assert all(v.dtype == torch.float32 for v in part.values())


def test_bf16_and_fp32_trainers_resume_each_others_checkpoints(tiny, tmp_path):
    """A Trainer under bf16 restores an fp32 Trainer's checkpoint bit for
    bit and trains on from it; an fp32 Trainer restores the bf16 one's."""
    kw = bf16_kw(tiny, tmp_path, layout="sparse")
    fp32 = td.Trainer(Config(**{**kw, "precision": "fp32"}), device="cpu")
    fp32.run(files_limit=2, verbose=False)
    saved = {k: v.clone() for k, v in fp32.params().items()}
    bf16 = td.Trainer(Config(**kw), device="cpu")
    assert bf16.precision.mixed and not fp32.precision.mixed
    step = bf16.try_restore()
    assert step == ckpt.latest_step(fp32._ckpt_dir())
    assert all(torch.equal(saved[k], v) for k, v in bf16.params().items())
    assert bf16.state.opt.count == fp32.state.opt.count
    bf16.run(files_limit=2, verbose=False, out_dir=str(tmp_path / "bf16"))
    trained = {k: v.clone() for k, v in bf16.params().items()}
    assert not all(torch.equal(saved[k], v) for k, v in trained.items())
    back = td.Trainer(Config(**{**kw, "precision": "fp32"}), device="cpu")
    assert back.try_restore() == ckpt.latest_step(bf16._ckpt_dir()) > step
    assert all(torch.equal(trained[k], v) for k, v in back.params().items())
