"""PyTorch port of TensorBoard scalar logging (`train/tb_logging.py`,
written without TensorFlow) and of the Trainer's device metrics, against
the JAX package on the CPU, float64.

* The event file's frames: the `brain.Event:2` header, then one record a
  scalar, each length and payload under its masked CRC-32C (read back
  here with the port's own wire decoder, no TensorFlow).
* The Trainer (JAX's replay indices injected, as `tests/test_torch_trainer.py`
  injects them) and `mho-serve` (the same closed-loop request stream)
  with `tb_logdir` set: read back through TensorFlow, the port's files
  give JAX's `ScalarLogger` files' (tag, step) sequence, values within
  1e-6 relative (the serving latencies, wall-clock readings, are held to
  their tags and steps only).  The TensorFlow side skips where
  TensorFlow is absent.
* `last_devmetrics`: JAX's six `DM_*` keys, the counters within 1e-9 of
  JAX's Trainer on the same files, weights and replay draws, the
  gradient-norm histogram's counts equal and its float32 sum, min and max
  within 4 float32 ulps (both packages take the norms in float32).
"""

import glob
import os
import struct

import jax
import numpy as np
import pytest
import torch

from multihop_offload_tpu.agent import train_step as jts
from multihop_offload_tpu.train import driver as jd
from multihop_offload_tpu_torch.agent import replay as treplay
from multihop_offload_tpu_torch.agent import train_step as tts
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models import tf_bundle
from multihop_offload_tpu_torch.models.chebconv import params_from_jax
from multihop_offload_tpu_torch.train import driver as td
from multihop_offload_tpu_torch.train.tb_logging import FILE_VERSION, ScalarLogger
from tests.test_torch_drivers import common, jax_config, tiny  # noqa: F401
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_trainer import jax_indices

TRAIN = dict(batch=6, memory_size=32, learning_rate=1e-3, epochs=1, explore=0.0,
             best_window=0, layout="dense")
FILES = 3
LATENCY_TAGS = ("serve/latency_p50_ms", "serve/latency_p99_ms")


def _frames(path):
    """(payload, ...) of a TFRecord file, every CRC checked."""
    data = open(path, "rb").read()
    out, pos = [], 0
    while pos < len(data):
        head = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        assert tf_bundle.mask_crc(tf_bundle.crc32c(head)) == crc
        payload = data[pos + 12:pos + 12 + n]
        (crc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        assert tf_bundle.mask_crc(tf_bundle.crc32c(payload)) == crc
        out.append(payload)
        pos += 16 + n
    return out


def _fields(buf):
    return {field: value for field, _, value in tf_bundle.proto_fields(buf)}


def test_event_file_frames_decode(tmp_path):
    tb = ScalarLogger(str(tmp_path / "tb"))
    assert tb.active and not ScalarLogger("").active and not ScalarLogger(None).active
    tb.log_scalar("replay_loss", 1.25, 0)
    tb.log_scalar("serve/served", 7, 300)
    tb.close()
    (path,) = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*.v2"))
    header, *events = _frames(path)
    assert _fields(header)[3] == FILE_VERSION.encode()
    got = []
    for ev in events:
        f = _fields(ev)
        value = _fields(_fields(f[5])[1])
        tensor = _fields(value[8])
        assert tensor[1] == 1 and tensor[2] == b""               # DT_FLOAT, shape ()
        assert _fields(_fields(value[9])[1])[1] == b"scalars"
        got.append((value[1].decode(), f.get(2, 0), struct.unpack("<f", tensor[4])[0]))
    assert got == [("replay_loss", 0, 1.25), ("serve/served", 300, 7.0)]
    # a bad logdir raises
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        ScalarLogger(str(blocker / "tb"))


def _tf_scalars(logdir):
    """(tag, step, value) of every scalar event in `logdir`, read by TF."""
    tf = pytest.importorskip("tensorflow")
    out = []
    for path in sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*"))):
        for e in tf.compat.v1.train.summary_iterator(path):
            for v in e.summary.value:
                out.append((v.tag, int(e.step), float(tf.make_ndarray(v.tensor))))
    return out


@pytest.fixture(scope="module")
def trainers(tiny, tmp_path_factory):
    """The JAX and the port's Trainer on the same files, weights and replay
    draws, each writing TensorBoard scalars."""
    tmp = tmp_path_factory.mktemp("tb_trainer")
    kw = common(tiny, tmp, files_limit=FILES, tb_logdir=str(tmp / "jax_tb"), **TRAIN)
    jt = jd.Trainer(jax_config(**kw))
    p0 = jax.device_get(jt.variables["params"])
    keys = []
    inner = jt._replay

    def recording(mem, params, opt_state, key):
        keys.append((np.asarray(key), int(mem.count)))
        return inner(mem, params, opt_state, key=key)

    recording.account = inner.account
    jt._replay = recording
    jt.run(verbose=False)
    indices = iter([jax_indices(k, c, TRAIN["memory_size"], TRAIN["batch"])
                    for k, c in keys])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treplay, "sample_indices",
                   lambda mem, batch, gen=None: torch.tensor(next(indices)))
        tt = td.Trainer(Config(**{**kw, "out": str(tmp / "port"),
                                  "model_root": str(tmp / "port_model"),
                                  "tb_logdir": str(tmp / "port_tb")}), device="cpu")
        tt.model.load_state_dict(params_from_jax(p0))
        tt.run(verbose=False)
    assert next(indices, None) is None and len(keys) >= 2
    return jt, tt, str(tmp / "jax_tb"), str(tmp / "port_tb")


def test_trainer_devmetrics_match_jax(trainers):
    jt, tt, _, _ = trainers
    names = (jts.DM_GRAD_NORM, jts.DM_LOSS_CRITIC_SUM, jts.DM_LOSS_CRITIC_SQ,
             jts.DM_LOSS_MSE_SUM, jts.DM_EPISODES, jts.DM_NONFINITE)
    assert names == (tts.DM_GRAD_NORM, tts.DM_LOSS_CRITIC_SUM, tts.DM_LOSS_CRITIC_SQ,
                     tts.DM_LOSS_MSE_SUM, tts.DM_EPISODES, tts.DM_NONFINITE)
    want, got = jt.last_devmetrics, tt.last_devmetrics
    assert set(got) == set(want) == set(names)
    for key in names[1:]:
        assert got[key] == pytest.approx(want[key], rel=1e-9, abs=0), key
    assert got[jts.DM_EPISODES] == 4 and got[jts.DM_NONFINITE] == 0
    hg, hw = got[jts.DM_GRAD_NORM], want[jts.DM_GRAD_NORM]
    assert hg["counts"] == hw["counts"] and hg["count"] == hw["count"] == 4
    # the norms are float32 in both packages by declaration (JAX `:100-110`,
    # an fp32 island): each sums its squares in float32 in its own order,
    # so they agree to float32's resolution, a few ulps
    for f in ("sum", "min", "max"):
        assert hg[f] == pytest.approx(hw[f], rel=4 * 2.0 ** -23, abs=0), f
    # the same declaration: buckets and help texts
    dj, dt = jts.train_devmetrics(), tts.train_devmetrics()
    assert dt.buckets_of(tts.DM_GRAD_NORM) == dj.buckets_of(jts.DM_GRAD_NORM)
    assert [d.help for d in dt._decls.values()] == [d.help for d in dj._decls.values()]


def test_trainer_scalars_match_jax(trainers):
    _, _, jdir, tdir = trainers
    want, got = _tf_scalars(jdir), _tf_scalars(tdir)
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    assert {t for t, _, _ in want} == {"replay_loss", "explore", "mse_loss"}
    for (tag, step, g), (_, _, w) in zip(got, want):
        assert g == pytest.approx(w, rel=1e-6, abs=0), (tag, step)


def test_serve_scalars_match_jax(tmp_path):
    pytest.importorskip("tensorflow")
    from multihop_offload_tpu.cli import serve as j_serve
    from multihop_offload_tpu_torch.cli import serve as t_serve

    # a deadline past any compile: no request degrades on a slow first tick
    flags = ["--serve_sizes=10,16", "--serve_slots=3", "--serve_requests=8", "--seed=2",
             "--serve_deadline_s=1000000"]
    j_serve.main(flags + [f"--tb_logdir={tmp_path / 'jax'}",
                          f"--model_root={tmp_path / 'jm'}"])
    t_serve.main(flags + ["--device", "cpu", f"--tb_logdir={tmp_path / 'port'}",
                          f"--model_root={tmp_path / 'tm'}"])
    want, got = _tf_scalars(str(tmp_path / "jax")), _tf_scalars(str(tmp_path / "port"))
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    assert {"serve/served", "serve/queue_depth", "serve/dispatches"} <= {t for t, _, _ in got}
    for (tag, step, g), (_, _, w) in zip(got, want):
        if tag not in LATENCY_TAGS:
            assert g == pytest.approx(w, rel=1e-6, abs=0), (tag, step)
