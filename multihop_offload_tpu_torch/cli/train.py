"""Training entry point — the `bash/train.sh` equivalent.

Port of `multihop_offload_tpu/cli/train.py`:

    python -m multihop_offload_tpu_torch.cli.train [--device cpu] \\
        --datapath=multihop_offload_tpu_torch/data/aco_data_ba_paper \\
        --arrival_scale=0.15 --learning_rate=1e-6 --training_set=BAT800 --T=800

Resumes from the newest checkpoint in the model directory's `torch/` when
there is one, runs the epoch loop and writes the training CSV.  It runs on
CUDA unless `--device cpu` is given, and raises when CUDA is absent.
`--precision bf16` (or `auto`, which is bf16 on the card and fp32 on the
CPU) trains under the bf16 policy (`precision.py`): job sets stored bf16,
the ChebNet's operands and its backward in bf16 (K4's forward and
transposed walk in bf16 on the sparse layout), the APSP in bf16, the
critic and K1 on fp32, and parameters, Adam moments and checkpoints in
fp32, so a bf16 run resumes an fp32 checkpoint and the reverse.
`--mesh_data N` shards the episodes of each file over N of the
local CUDA devices (0, the default: all of them); before anything else
`init_distributed()` joins the process group the environment names (a
no-op for one process), and process 0 writes the outputs
(`--csv_write_all_hosts true`: every process its own CSV).
"""

from __future__ import annotations

from multihop_offload_tpu_torch.config import from_cli
from multihop_offload_tpu_torch.multihost.runtime import init_distributed
from multihop_offload_tpu_torch.train.driver import Trainer


def main(argv=None) -> str:
    init_distributed()  # multi-host bring-up; single-process no-op
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
