"""Write the PyTorch port's data files from the JAX package.

The machine that runs the port has neither networkx (which the JAX data
generator needs) nor orbax (which its checkpoints need), so the port reads
two committed `.npz` files instead:

* `multihop_offload_tpu_torch/data/cases.npz`: the BA cases of
  `cli/datagen.generate_dataset(gtype="ba", seed0=500)` — group ``paper``
  (``size=2``, n = 20..110) and group ``rung256`` (``size=4``,
  ``graph_sizes=[250]``).  Per case: the adjacency (uint8), the mean link
  rates in canonical link order, `nodes_info` (role, proc_bw) and the seed,
  in sorted file-name order.
* `multihop_offload_tpu_torch/data/weights.npz`: the ``params`` of the model
  of record ``SCRATCH800_decay0.99`` (K=1) and of ``SPECTRAL_K2`` (K=2),
  keyed ``<model>/cheb_<i>/<kernel|bias>``.

Run once from the repository root:

    JAX_PLATFORMS=cpu python scripts/export_torch_port_data.py
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT_DIR = os.path.join(ROOT, "multihop_offload_tpu_torch", "data")
CASE_GROUPS = {
    "paper": dict(size=2, graph_sizes=None),
    "rung256": dict(size=4, graph_sizes=[250]),
}
CHECKPOINTS = {
    "SCRATCH800_decay0.99": "training/runs/SCRATCH800_decay0.99/model/"
    "model_ChebConv_SCRATCH800_decay0.99_a5_c5_ACO_agent/orbax_best",
    "SPECTRAL_K2": "training/runs/SPECTRAL_K2/model/"
    "model_ChebConv_SPECTRAL_K2_a5_c5_ACO_agent/orbax_best",
}


def case_arrays(group: str) -> dict:
    """The arrays of one case group, generated afresh with the JAX package."""
    from multihop_offload_tpu.cli.datagen import generate_dataset
    from multihop_offload_tpu.graphs.matio import list_dataset, load_case_mat

    spec = CASE_GROUPS[group]
    out = {}
    with tempfile.TemporaryDirectory() as d:
        generate_dataset(d, "ba", size=spec["size"], seed0=500,
                         graph_sizes=spec["graph_sizes"], verbose=False)
        names = list_dataset(d)
        for i, name in enumerate(names):
            rec = load_case_mat(os.path.join(d, name))
            out[f"{group}/{i}/adj"] = rec.topo.adj.astype(np.uint8)
            out[f"{group}/{i}/link_rates"] = rec.link_rates.astype(np.float64)
            out[f"{group}/{i}/nodes_info"] = np.stack(
                [rec.roles.astype(np.int64), rec.proc_bws.astype(np.int64)], 1)
            out[f"{group}/{i}/seed"] = np.int64(rec.seed)
        out[f"{group}/names"] = np.asarray(names)
    return out


def weight_arrays() -> dict:
    """The ``params`` leaves of the committed checkpoints, as numpy."""
    from multihop_offload_tpu.train.checkpoints import restore_checkpoint_raw

    out = {}
    for model, path in CHECKPOINTS.items():
        params = restore_checkpoint_raw(os.path.join(ROOT, path))["params"]
        for layer, leaves in params.items():
            for leaf, val in leaves.items():
                out[f"{model}/{layer}/{leaf}"] = np.asarray(val)
    return out


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT_DIR, exist_ok=True)
    cases = {}
    for group in CASE_GROUPS:
        cases.update(case_arrays(group))
    np.savez_compressed(os.path.join(OUT_DIR, "cases.npz"), **cases)
    np.savez_compressed(os.path.join(OUT_DIR, "weights.npz"), **weight_arrays())
    for name in ("cases.npz", "weights.npz"):
        path = os.path.join(OUT_DIR, name)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
