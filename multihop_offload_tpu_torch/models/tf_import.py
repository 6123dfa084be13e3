"""The reference's TensorFlow checkpoints, read and written without
TensorFlow (port of `multihop_offload_tpu/models/tf_import.py`).

The reference saves Keras `save_weights` checkpoints
(`gnn_offloading_agent.py:131-132`) whose variables are addressed as
`layer_with_weights-{i}/{kernel,bias}/.ATTRIBUTES/VARIABLE_VALUE` with kernel
shape (K, in, out), the ChebConv parameter layout, so the import is a
rename and a cast.  The tensor bundle itself is `models/tf_bundle.py`.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from multihop_offload_tpu_torch.models.tf_bundle import (
    OBJECT_GRAPH_KEY,
    TrackableNode,
    encode_object_graph,
    read_bundle,
    write_bundle,
)

_VAR = "layer_with_weights-{i}/{name}/.ATTRIBUTES/VARIABLE_VALUE"


def _checkpoint_prefix(path: str) -> str:
    """Accept a directory (use its latest checkpoint) or a ckpt prefix."""
    if os.path.isdir(path):
        meta = os.path.join(path, "checkpoint")
        if os.path.isfile(meta):
            with open(meta) as f:
                for line in f:
                    if line.startswith("model_checkpoint_path"):
                        name = line.split(":", 1)[1].strip().strip('"')
                        return os.path.join(path, name)
        cands = sorted(
            f[: -len(".index")] for f in os.listdir(path) if f.endswith(".index")
        )
        if not cands:
            raise FileNotFoundError(f"no checkpoint under {path}")
        return os.path.join(path, cands[-1])
    return path


def load_reference_checkpoint(path: str, dtype=np.float32) -> Dict[str, Any]:  # fp32-island(imported params stay wide)
    """Load reference weights into a ``{"params": {"cheb_i": {"kernel",
    "bias"}}}`` numpy tree (`chebconv.params_from_jax` carries it into a
    model), layer by layer until `layer_with_weights-{i}/kernel` is missing."""
    prefix = _checkpoint_prefix(path)
    tensors = read_bundle(prefix)
    params: Dict[str, Any] = {}
    i = 0
    while _VAR.format(i=i, name="kernel") in tensors:
        params[f"cheb_{i}"] = {
            "kernel": np.asarray(tensors[_VAR.format(i=i, name="kernel")], dtype=dtype),
            "bias": np.asarray(tensors[_VAR.format(i=i, name="bias")], dtype=dtype),
        }
        i += 1
    if not params:
        raise ValueError(f"no ChebConv weights found in {prefix}")
    return {"params": params}


def _object_graph(num_layers: int) -> bytes:
    """The object graph `tf.train.Checkpoint.write` records for a root that
    tracks bare `layer_with_weights-{i}` nodes, each holding a `bias` and a
    `kernel` variable: nodes numbered breadth-first, children by name."""
    nodes = [TrackableNode(children=[(1 + i, f"layer_with_weights-{i}")
                                     for i in range(num_layers)])]
    first_var = 1 + num_layers
    for i in range(num_layers):
        nodes.append(TrackableNode(children=[(first_var + 2 * i, "bias"),
                                             (first_var + 2 * i + 1, "kernel")]))
    for i in range(num_layers):
        for name in ("bias", "kernel"):
            nodes.append(TrackableNode(attributes=[
                ("VARIABLE_VALUE", "Variable", _VAR.format(i=i, name=name))]))
    return encode_object_graph(nodes)


def save_reference_checkpoint(path: str, variables: Dict[str, Any]) -> str:
    """Write our params out under the reference's exact variable paths
    (`layer_with_weights-{i}/{kernel,bias}/.ATTRIBUTES/VARIABLE_VALUE`), as
    float64, so the original TF/Spektral code could `load_weights` a model
    trained here; the same bytes as `tf.train.Checkpoint.write` of that
    object graph.  Returns the prefix written."""
    params = variables["params"]
    tensors = {}
    for i in range(len(params)):
        layer = params[f"cheb_{i}"]
        for name in ("bias", "kernel"):
            tensors[_VAR.format(i=i, name=name)] = np.asarray(layer[name], dtype=np.float64)
    tensors[OBJECT_GRAPH_KEY] = np.asarray(_object_graph(len(params)), dtype=object)
    return write_bundle(path, tensors)
