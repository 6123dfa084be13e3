"""Evaluation entry point — the `bash/test.sh` equivalent.

Port of `multihop_offload_tpu/cli/test.py` (one device):

    python -m multihop_offload_tpu_torch.cli.test [--device cpu] \\
        --datapath=multihop_offload_tpu_torch/data/aco_data_ba_paper \\
        --arrival_scale=0.15 --training_set=BAT800 --T=1000

Evaluates the baseline, local and GNN methods on every file and writes the
test CSV.  As in the JAX package the GNN is a seeded fresh init (the JAX
entry point would load a TF-format checkpoint from the model directory;
the port refuses one until `models/tf_import.py` is ported).  It runs on
CUDA unless `--device cpu` is given, and raises when CUDA is absent.
"""

from __future__ import annotations

from multihop_offload_tpu_torch.config import from_cli
from multihop_offload_tpu_torch.train.driver import Evaluator


def main(argv=None) -> str:
    cfg, device = from_cli(argv, __doc__)
    csv = Evaluator(cfg, device=device).run()
    print(f"test results written to {csv}")
    return csv


if __name__ == "__main__":
    main()
