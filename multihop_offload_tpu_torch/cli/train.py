"""Training entry point — the `bash/train.sh` equivalent.

Port of `multihop_offload_tpu/cli/train.py` (one device):

    python -m multihop_offload_tpu_torch.cli.train [--device cpu] \\
        --datapath=multihop_offload_tpu_torch/data/aco_data_ba_paper \\
        --arrival_scale=0.15 --learning_rate=1e-6 --training_set=BAT800 --T=800

Resumes from the newest checkpoint in the model directory's `torch/` when
there is one, runs the epoch loop and writes the training CSV.  It runs on
CUDA unless `--device cpu` is given, and raises when CUDA is absent.
"""

from __future__ import annotations

from multihop_offload_tpu_torch.config import from_cli
from multihop_offload_tpu_torch.train.driver import Trainer


def main(argv=None) -> str:
    cfg, device = from_cli(argv, __doc__)
    trainer = Trainer(cfg, device=device)
    restored = trainer.try_restore()
    if restored is not None:
        print(f"resumed from torch step {restored}")
    csv = trainer.run()
    print(f"training log written to {csv}")
    return csv


if __name__ == "__main__":
    main()
