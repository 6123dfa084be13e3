"""PyTorch port, the reference's TF checkpoints without TensorFlow
(`models/tf_bundle.py`, `models/tf_import.py`) and the drivers that load
them, against TensorFlow and the JAX package on the CPU:

* reading: `read_bundle` returns what `tf.train.load_checkpoint` returns,
  key for key, dtype, shape and bits (the object graph's bytes too), on the
  JAX package's `save_reference_checkpoint` at K = 1, 2, 3, on a float32
  `tf.train.Checkpoint.save` with its `save_counter` and `checkpoint` file,
  on a `SaveV2` bundle of thousands of float32 / float64 / int32 / int64 /
  string tensors whose index spans several data blocks, and on a bundle of
  five data shards;
* writing: the port's `.index` and `.data` byte-identical to the JAX
  package's (TF's `BundleWriter`) and to `SaveV2` on the same tensors, and
  read back by TF, by the JAX package's `load_reference_checkpoint` and by
  `tf.train.Checkpoint.read(...).assert_consumed()`;
* the committed fixture equals a fresh `export_torch_port_data.py --tf`
  and reads back as `weights.npz`;
* a flipped data byte, a flipped index byte and a truncated index raise;
  `_checkpoint_prefix` and the two errors as in JAX;
* the drivers (float64): the Evaluator and the Trainer load a TF-format
  model directory with no alive-flip, their rows equal the JAX drivers'
  on the same directory and two paper files (rtol 1e-9, `runtime`
  excluded), and a corrupt checkpoint falls back to the fresh init in
  both packages.
"""

import filecmp
import importlib.util
import os
import shutil

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from multihop_offload_tpu.models import tf_import as jtf  # noqa: E402
from multihop_offload_tpu.train import driver as jd  # noqa: E402
from multihop_offload_tpu_torch.config import Config  # noqa: E402
from multihop_offload_tpu_torch.models import tf_bundle as tb  # noqa: E402
from multihop_offload_tpu_torch.models import tf_import as ttf  # noqa: E402
from multihop_offload_tpu_torch.models.chebconv import load_weights, params_from_jax  # noqa: E402
from multihop_offload_tpu_torch.train import driver as td  # noqa: E402
from tests.test_torch_drivers import assert_rows_equal, jax_config, read_rows  # noqa: E402
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401, E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "multihop_offload_tpu_torch", "data")
FIXTURE_ROOT = os.path.join(DATA, "tf_ckpt")
FIXTURE = os.path.join(FIXTURE_ROOT, "model_ChebConv_SCRATCH800_a5_c5_ACO_agent")
PAPER_FILES = ("aco_case_seed500_m2_n20_s4.mat", "aco_case_seed500_m2_n30_s7.mat")


def random_params(k: int, seed: int = 0, layers=(4, 32, 32, 32, 32, 1)) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {f"cheb_{i}": {"kernel": rng.normal(size=(k, a, b)).astype(np.float32),
                                     "bias": rng.normal(size=(b,)).astype(np.float32)}
                       for i, (a, b) in enumerate(zip(layers, layers[1:]))}}


def assert_same_as_tf(tf, prefix: str) -> dict:
    """`read_bundle(prefix)` against `tf.train.load_checkpoint(prefix)`:
    the same keys, and per key the dtype, shape and bits."""
    got = tb.read_bundle(prefix)
    reader = tf.train.load_checkpoint(prefix)
    dtypes = reader.get_variable_to_dtype_map()
    assert sorted(got) == sorted(dtypes)
    for key, dtype in dtypes.items():
        want = reader.get_tensor(key)
        if dtype == tf.string:
            want = np.asarray(want, dtype=object)
            assert got[key].dtype == object and got[key].shape == want.shape, key
            assert list(got[key].reshape(-1)) == list(want.reshape(-1)), key
        else:
            assert got[key].dtype == want.dtype and got[key].shape == want.shape, key
            assert got[key].tobytes() == want.tobytes(), key
    return got


def same_files(a: str, b: str) -> bool:
    return all(filecmp.cmp(a + suffix, b + suffix, shallow=False)
               for suffix in (".index", ".data-00000-of-00001"))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_reader_and_writer_match_tf_and_jax(tmp_path, k):
    tf = pytest.importorskip("tensorflow")
    variables = random_params(k, seed=k)
    jprefix = jtf.save_reference_checkpoint(str(tmp_path / "jax" / "cp-0000.ckpt"), variables)
    got = assert_same_as_tf(tf, jprefix)
    assert set(got) == {tb.OBJECT_GRAPH_KEY} | {
        f"layer_with_weights-{i}/{n}/.ATTRIBUTES/VARIABLE_VALUE"
        for i in range(5) for n in ("kernel", "bias")}
    # the port's writer: byte for byte TF's, read back by TF and by JAX
    tprefix = ttf.save_reference_checkpoint(str(tmp_path / "port" / "cp-0000.ckpt"), variables)
    assert tprefix == str(tmp_path / "port" / "cp-0000.ckpt")
    assert same_files(tprefix, jprefix)
    assert_same_as_tf(tf, tprefix)
    want = jtf.load_reference_checkpoint(tprefix, dtype=np.float32)
    mine = ttf.load_reference_checkpoint(jprefix)
    for layer, leaves in variables["params"].items():
        for leaf, value in leaves.items():
            assert want["params"][layer][leaf].tobytes() == value.tobytes()
            assert mine["params"][layer][leaf].tobytes() == value.tobytes()
            assert mine["params"][layer][leaf].dtype == np.float32
    assert ttf.load_reference_checkpoint(jprefix, dtype=np.float64)["params"]["cheb_0"][
        "kernel"].dtype == np.float64
    # the object graph TF records restores every variable of the same graph
    root = tf.train.Checkpoint()
    made = {}
    for i, layer in enumerate(variables["params"].values()):
        node = tf.train.Checkpoint(
            kernel=tf.Variable(np.zeros(layer["kernel"].shape, np.float64)),
            bias=tf.Variable(np.zeros(layer["bias"].shape, np.float64)))
        setattr(root, f"layer_with_weights-{i}", node)
        made[i] = node
    root.read(tprefix).assert_consumed()
    for i, layer in enumerate(variables["params"].values()):
        np.testing.assert_array_equal(made[i].kernel.numpy(), layer["kernel"])
        np.testing.assert_array_equal(made[i].bias.numpy(), layer["bias"])


def test_reader_matches_a_keras_like_save(tmp_path):
    tf = pytest.importorskip("tensorflow")
    variables = random_params(1, seed=7)
    root = tf.train.Checkpoint()
    for i, layer in enumerate(variables["params"].values()):
        setattr(root, f"layer_with_weights-{i}", tf.train.Checkpoint(
            kernel=tf.Variable(layer["kernel"]), bias=tf.Variable(layer["bias"])))
    path = root.save(str(tmp_path / "cp"))  # "cp-1", the save_counter, `checkpoint`
    assert ttf._checkpoint_prefix(str(tmp_path)) == path
    got = assert_same_as_tf(tf, path)
    assert got["save_counter/.ATTRIBUTES/VARIABLE_VALUE"].dtype == np.int64
    # the object graph decodes, and encodes again to TF's bytes
    graph = got[tb.OBJECT_GRAPH_KEY].item()
    nodes = tb.decode_object_graph(graph)
    assert tb.encode_object_graph(nodes) == graph
    assert {name for _, name in nodes[0].children} == {
        "save_counter", *(f"layer_with_weights-{i}" for i in range(5))}
    assert sorted(key for node in nodes for _, _, key in node.attributes) == sorted(
        k for k in got if k != tb.OBJECT_GRAPH_KEY)
    mine = ttf.load_reference_checkpoint(str(tmp_path))
    want = jtf.load_reference_checkpoint(str(tmp_path))
    for layer, leaves in want["params"].items():
        for leaf, value in leaves.items():
            assert mine["params"][layer][leaf].tobytes() == value.tobytes()
            assert value.tobytes() == variables["params"][layer][leaf].tobytes()


def many_tensors(count: int) -> dict:
    """`count` small tensors of every dtype the bundle takes, under keys
    long enough that the index passes one data block."""
    rng = np.random.default_rng(3)
    out = {}
    for i in range(count):
        kind = i % 5
        if kind == 0:
            v = rng.normal(size=(2,)).astype(np.float32)
        elif kind == 1:
            v = np.asarray(rng.normal(), dtype=np.float64)
        elif kind == 2:
            v = rng.integers(-9, 9, size=(3,)).astype(np.int32)
        elif kind == 3:
            v = rng.integers(-2 ** 40, 2 ** 40, size=(1, 2)).astype(np.int64)
        else:
            v = np.asarray([b"ab", b"", b"xyz" * (i % 50)], dtype=object)
        out[f"scope_{i % 7}/layer_{i:05d}/sublayer/.ATTRIBUTES/VARIABLE_VALUE"] = v
    return out


def data_blocks(prefix: str) -> int:
    with open(prefix + ".index", "rb") as f:
        buf = f.read()
    footer = buf[-tb.FOOTER_SIZE:]
    pos = 0
    for _ in range(2):
        start = pos
        _, pos = tb.decode_varint(footer, pos)
        _, pos = tb.decode_varint(footer, pos)
    return len(tb._read_block(buf, footer[start:pos]))


def test_multi_block_index_reads_and_writes_as_tf(tmp_path):
    tf = pytest.importorskip("tensorflow")
    tensors = many_tensors(4500)
    prefix = str(tmp_path / "tf" / "bundle")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=list(tensors),
                      shape_and_slices=[""] * len(tensors),
                      tensors=[tf.constant(v) for v in tensors.values()])
    assert data_blocks(prefix) >= 2
    got = assert_same_as_tf(tf, prefix)
    assert len(got) == len(tensors)
    mine = tb.write_bundle(str(tmp_path / "port" / "bundle"), tensors)
    assert same_files(mine, prefix)
    # a smaller block size: many blocks, each key read back in order
    small = tb.write_bundle(str(tmp_path / "small" / "bundle"), tensors, block_size=4096)
    assert data_blocks(small) > 20
    back = tb.read_bundle(small)
    assert list(back) == sorted(tensors)
    for key, value in tensors.items():
        assert back[key].shape == np.shape(value)
        assert list(back[key].reshape(-1)) == list(np.asarray(value).reshape(-1))


def test_reader_takes_any_number_of_shards(tmp_path):
    tf = pytest.importorskip("tensorflow")

    class OnePerShard(tf.train.experimental.ShardingCallback):
        @property
        def description(self):
            return "one tensor a shard"

        def __call__(self, shardable_tensors):
            return [{t.checkpoint_key: {t.slice_spec: t.tensor}} for t in shardable_tensors]

    rng = np.random.default_rng(0)
    ckpt = tf.train.Checkpoint(**{f"v{i}": tf.Variable(rng.normal(size=(8, i + 1)))
                                  for i in range(4)})
    prefix = ckpt.write(str(tmp_path / "ck"), options=tf.train.CheckpointOptions(
        experimental_sharding_callback=OnePerShard()))
    assert os.path.isfile(tb.data_path(prefix, 4, 5))
    assert len(assert_same_as_tf(tf, prefix)) == 5


def test_fixture_is_a_fresh_tf_export_and_gives_weights_back(tmp_path):
    want = load_weights("SCRATCH800_decay0.99")["params"]
    got = ttf.load_reference_checkpoint(FIXTURE)
    assert sorted(got["params"]) == sorted(want)
    for layer, leaves in want.items():
        for leaf, value in leaves.items():
            assert got["params"][layer][leaf].dtype == value.dtype == np.float32
            assert got["params"][layer][leaf].tobytes() == value.tobytes()
    # rewritten by the port's writer, byte for byte
    prefix = ttf.save_reference_checkpoint(str(tmp_path / "port" / "cp-0000.ckpt"),
                                           {"params": want})
    assert same_files(prefix, os.path.join(FIXTURE, "cp-0000.ckpt"))
    pytest.importorskip("tensorflow")
    spec = importlib.util.spec_from_file_location(
        "export_torch_port_data", os.path.join(ROOT, "scripts", "export_torch_port_data.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    fresh = str(tmp_path / "fresh")
    names = [os.path.basename(p) for p in export.write_tf_checkpoint(fresh)]
    assert names == sorted(os.listdir(FIXTURE)) == [
        "checkpoint", "cp-0000.ckpt.data-00000-of-00001", "cp-0000.ckpt.index"]
    for name in names:
        assert filecmp.cmp(os.path.join(fresh, name), os.path.join(FIXTURE, name),
                           shallow=False), name


@pytest.mark.parametrize("damage", ["data_byte", "index_byte", "index_truncated"])
def test_damaged_bundles_raise(tmp_path, damage):
    prefix = ttf.save_reference_checkpoint(str(tmp_path / "cp"), random_params(1))
    path = prefix + (".data-00000-of-00001" if damage == "data_byte" else ".index")
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    if damage == "index_truncated":
        buf = buf[:len(buf) // 2]
    else:
        buf[len(buf) // 3] ^= 0x10
    with open(path, "wb") as f:
        f.write(bytes(buf))
    with pytest.raises(tb.DataLossError):
        tb.read_bundle(prefix)
    with pytest.raises(tb.DataLossError):
        ttf.load_reference_checkpoint(prefix)


def test_checkpoint_prefix_and_errors_match_jax(tmp_path):
    for mod in (jtf, ttf):
        assert mod._checkpoint_prefix("some/prefix") == "some/prefix"
    d = tmp_path / "d"
    d.mkdir()
    for mod in (jtf, ttf):
        with pytest.raises(FileNotFoundError, match="no checkpoint under"):
            mod._checkpoint_prefix(str(d))
    # no `checkpoint` file: the last `.index` in sorted order
    for name in ("cp-0002", "cp-0010", "cp-0001"):
        ttf.save_reference_checkpoint(str(d / name), random_params(1))
    for mod in (jtf, ttf):
        assert mod._checkpoint_prefix(str(d)) == str(d / "cp-0010")
    # a `checkpoint` file names the prefix, relative or absolute
    (d / "checkpoint").write_text('model_checkpoint_path: "cp-0001"\n'
                                  'all_model_checkpoint_paths: "cp-0001"\n')
    for mod in (jtf, ttf):
        assert mod._checkpoint_prefix(str(d)) == str(d / "cp-0001")
    (d / "checkpoint").write_text(f'model_checkpoint_path: "{d / "cp-0002"}"\n')
    for mod in (jtf, ttf):
        assert mod._checkpoint_prefix(str(d)) == str(d / "cp-0002")
    # a bundle without ChebConv layers: ValueError in both
    empty = tb.write_bundle(str(tmp_path / "other"), {"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="no ChebConv weights found"):
        ttf.load_reference_checkpoint(empty)
    pytest.importorskip("tensorflow")
    with pytest.raises(ValueError, match="no ChebConv weights found"):
        jtf.load_reference_checkpoint(empty)


# ---- the drivers ---------------------------------------------------------------


@pytest.fixture
def two_files(tmp_path):
    d = tmp_path / "aco_data_ba_two"
    d.mkdir()
    for name in PAPER_FILES:
        shutil.copy(os.path.join(DATA, "aco_data_ba_paper", name), d / name)
    return str(d)


def driver_kw(datapath: str, tmp_path, tag: str, model_root: str, **kw) -> dict:
    return dict(datapath=datapath, out=str(tmp_path / f"out_{tag}"), model_root=model_root,
                T=1000, arrival_scale=0.15, dtype="float64", num_instances=4, seed=3,
                training_set="SCRATCH800", cheb_k=1, hidden=32, num_layer=5, **kw)


def fixture_copy(tmp_path, tag: str) -> str:
    root = str(tmp_path / f"model_{tag}")
    shutil.copytree(FIXTURE_ROOT, root)
    return root


TRAIN = dict(batch=6, memory_size=32, learning_rate=1e-3, epochs=1, explore=0.0)


@pytest.mark.parametrize("driver", ["Evaluator", "Trainer"])
def test_drivers_load_a_tf_format_directory(two_files, tmp_path, monkeypatch, capsys, driver):
    pytest.importorskip("tensorflow")
    extra = TRAIN if driver == "Trainer" else {}
    jkw = driver_kw(two_files, tmp_path, "jax", fixture_copy(tmp_path, "jax"), **extra)
    jh = getattr(jd, driver)(jax_config(**jkw))
    assert "loaded reference-format weights from" in capsys.readouterr().out
    limit = {"files_limit": 1} if driver == "Trainer" else {}
    want = read_rows(jh.run(verbose=False, **limit))

    def no_probe(*a, **k):
        raise AssertionError("a loaded model is probed for a dead output")

    monkeypatch.setattr(td, "ensure_alive_output_multi", no_probe)
    tkw = driver_kw(two_files, tmp_path, "port", fixture_copy(tmp_path, "port"), **extra)
    th = getattr(td, driver)(Config(**tkw), device="cpu")
    assert capsys.readouterr().out.splitlines() == [
        f"loaded reference-format weights from {th.model_dir}"]
    weights = params_from_jax(load_weights("SCRATCH800_decay0.99"))
    for k, v in th.params().items():
        assert v.dtype == torch.float64 and torch.equal(v, weights[k].to(torch.float64)), k
    got = read_rows(th.run(verbose=False, **limit))
    assert len(got) == (4 * 4 if driver == "Trainer" else 2 * 4 * 3)
    assert_rows_equal(got, want)


def test_a_corrupt_checkpoint_falls_back_to_the_fresh_init(two_files, tmp_path, capsys):
    pytest.importorskip("tensorflow")
    clean_root, bad_root = str(tmp_path / "clean"), str(tmp_path / "bad")
    bad_dir = Config(**driver_kw(two_files, tmp_path, "x", bad_root)).model_dir()
    os.makedirs(bad_dir)
    with open(os.path.join(bad_dir, "checkpoint"), "w") as f:
        f.write('model_checkpoint_path: "cp-0000.ckpt"\n')
    with open(os.path.join(bad_dir, "cp-0000.ckpt.index"), "wb") as f:
        f.write(os.urandom(100))
    # JAX: the fresh init, as with no checkpoint
    jclean = jd.Evaluator(jax_config(**driver_kw(two_files, tmp_path, "jc", clean_root)))
    jbad = jd.Evaluator(jax_config(**driver_kw(two_files, tmp_path, "jb", bad_root)))
    assert f"unable to load {bad_dir}" in capsys.readouterr().out
    for layer, leaves in jclean.variables["params"].items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(np.asarray(jbad.variables["params"][layer][leaf]),
                                          np.asarray(value))
    # the port likewise
    for cls in (td.Evaluator, td.Trainer):
        clean = cls(Config(**driver_kw(two_files, tmp_path, "tc", clean_root)), device="cpu")
        bad = cls(Config(**driver_kw(two_files, tmp_path, "tb", bad_root)), device="cpu")
        out = capsys.readouterr().out
        assert out.startswith(f"unable to load {bad_dir}: "), out
        for k, v in clean.params().items():
            assert torch.equal(bad.params()[k], v), k
