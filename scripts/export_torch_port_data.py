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
  Group ``large`` is the one network of `scripts/large_scale_demo.py` at
  ``--n 1024 --gtype er --seed 42`` (load 0.15, T 1000), as its
  `build_case` and job draw (`:97-109`) make it: the link list (not the
  (L, L) matrices), the link rates, roles, proc_bws, and the job sources
  and rates.
* `multihop_offload_tpu_torch/data/aco_data_ba_paper/`: the same ``paper``
  cases as `.mat` files in the reference schema, as
  `cli/datagen.generate_dataset(d, "ba", size=2, seed0=500)` writes them
  (the drivers' dataset: `cli/train.py`, `cli/test.py`).
* `multihop_offload_tpu_torch/data/weights.npz`: the ``params`` of the model
  of record ``SCRATCH800_decay0.99`` (K=1) and of ``SPECTRAL_K2`` (K=2),
  keyed ``<model>/cheb_<i>/<kernel|bias>``; and ``LARGE_K3_init``, the
  random K=3 initial parameters the demo runs with
  (`make_model(Config(cheb_k=3)).init(PRNGKey(0), ...)`, `:112-115`; their
  shapes, and so their values, do not depend on E, so they are drawn at a
  small E).

Run once from the repository root (``--mat`` writes only the `.mat`
dataset, ``--npz`` only the two `.npz` files):

    JAX_PLATFORMS=cpu python scripts/export_torch_port_data.py [--mat | --npz]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT_DIR = os.path.join(ROOT, "multihop_offload_tpu_torch", "data")
MAT_DIR = os.path.join(OUT_DIR, "aco_data_ba_paper")
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


def large_arrays(n: int = 1024, gtype: str = "er", seed: int = 42,
                 load: float = 0.15, t_max: float = 1000.0) -> dict:
    """Group ``large``: what `scripts/large_scale_demo.py` draws for
    (n, gtype, seed), drawn again with its own `build_case`."""
    draw = large_case_draw(n, gtype, seed, load)
    return {f"large/{k}": np.asarray(v) for k, v in dict(
        draw, n=n, gtype=gtype, seed=seed, load=load, T=t_max).items()}


def large_case_draw(n: int, gtype: str, seed: int, load: float) -> dict:
    """The demo's network and job set (`scripts/large_scale_demo.py:97-109`),
    as plain arrays."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "large_scale_demo", os.path.join(ROOT, "scripts", "large_scale_demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    rng = np.random.default_rng(seed)
    topo, roles, proc_bws, link_rates = demo.build_case(n, gtype, seed, rng)
    mobile = np.flatnonzero(roles == 0)
    nj = int(0.5 * mobile.size)
    job_src = rng.permutation(mobile)[:nj]
    job_rate = load * rng.uniform(0.1, 0.5, nj)
    return {"link_ends": topo.link_ends.astype(np.int32),
            "link_rates": np.asarray(link_rates, np.float64),
            "roles": roles.astype(np.int32),
            "proc_bws": np.asarray(proc_bws, np.float64),
            "job_src": job_src.astype(np.int64), "job_rate": job_rate}


def large_init_params(cheb_k: int = 3, e: int = 16) -> dict:
    """The demo's initial parameters (`make_model(Config(cheb_k=k)).init(
    PRNGKey(0), zeros((E, 4)), support)`, `:112-115`) at extended-slot
    count `e`; their shapes do not depend on E."""
    import jax
    import jax.numpy as jnp

    from multihop_offload_tpu.config import Config
    from multihop_offload_tpu.models import make_model

    model = make_model(Config(cheb_k=cheb_k))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((e, 4)), jnp.zeros((e, e)))
    return jax.device_get(variables["params"])


def weight_arrays() -> dict:
    """The ``params`` leaves of the committed checkpoints and of the large
    demo's initial parameters, as numpy."""
    from multihop_offload_tpu.train.checkpoints import restore_checkpoint_raw

    trees = {model: restore_checkpoint_raw(os.path.join(ROOT, path))["params"]
             for model, path in CHECKPOINTS.items()}
    trees["LARGE_K3_init"] = large_init_params()
    out = {}
    for model, params in trees.items():
        for layer, leaves in params.items():
            for leaf, val in leaves.items():
                out[f"{model}/{layer}/{leaf}"] = np.asarray(val)
    return out


def write_paper_mat(out_dir: str = MAT_DIR) -> list:
    """The ``paper`` cases as `.mat` files, written afresh by the JAX
    package's `generate_dataset` into an emptied `out_dir`."""
    from multihop_offload_tpu.cli.datagen import generate_dataset

    shutil.rmtree(out_dir, ignore_errors=True)
    spec = CASE_GROUPS["paper"]
    return generate_dataset(out_dir, "ba", size=spec["size"], seed0=500,
                            graph_sizes=spec["graph_sizes"], verbose=False)


def main(argv=None) -> None:
    import jax

    p = argparse.ArgumentParser(description=__doc__)
    g = p.add_mutually_exclusive_group()
    g.add_argument("--mat", action="store_true", help="only the .mat dataset")
    g.add_argument("--npz", action="store_true", help="only the .npz files")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT_DIR, exist_ok=True)
    if not args.npz:
        paths = write_paper_mat()
        print(f"wrote {len(paths)} cases into {MAT_DIR} "
              f"({sum(os.path.getsize(q) for q in paths)} bytes)")
    if args.mat:
        return
    cases = {}
    for group in CASE_GROUPS:
        cases.update(case_arrays(group))
    cases.update(large_arrays())
    np.savez_compressed(os.path.join(OUT_DIR, "cases.npz"), **cases)
    np.savez_compressed(os.path.join(OUT_DIR, "weights.npz"), **weight_arrays())
    for name in ("cases.npz", "weights.npz"):
        path = os.path.join(OUT_DIR, name)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
