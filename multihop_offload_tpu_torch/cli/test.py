"""Evaluation entry point — the `bash/test.sh` equivalent.

Port of `multihop_offload_tpu/cli/test.py`:

    python -m multihop_offload_tpu_torch.cli.test [--device cpu] \\
        --datapath=multihop_offload_tpu_torch/data/aco_data_ba_paper \\
        --arrival_scale=0.15 --training_set=BAT800 --T=1000

Evaluates the baseline, local and GNN methods on every file and writes the
test CSV.  As in the JAX package the GNN loads the reference's TF-format
checkpoint when the model directory (`--model_root`, `--training_set`)
holds one, and is a seeded fresh init otherwise.  It runs on CUDA unless
`--device cpu` is given, and raises when CUDA is absent.
`--precision bf16` (or `auto` on the card) evaluates under the bf16
policy: the files stored as bf16, the model at its compute dtypes, the
APSP squared in bf16 (`train.driver.Evaluator`).
`--mesh_data N` shards the whole files (`--file_batch` a device) over N of the
local CUDA devices (0, the default: all of them); before anything else
`init_distributed()` joins the process group the environment names (a
no-op for one process), and process 0 writes the outputs
(`--csv_write_all_hosts true`: every process its own CSV).
"""

from __future__ import annotations

from multihop_offload_tpu_torch.config import from_cli
from multihop_offload_tpu_torch.multihost.runtime import init_distributed
from multihop_offload_tpu_torch.train.driver import Evaluator


def main(argv=None) -> str:
    init_distributed()  # multi-host bring-up; single-process no-op
    cfg, device = from_cli(argv, __doc__)
    csv = Evaluator(cfg, device=device).run()
    print(f"test results written to {csv}")
    return csv


if __name__ == "__main__":
    main()
