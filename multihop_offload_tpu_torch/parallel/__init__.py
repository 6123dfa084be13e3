"""Sharding over a mesh of torch devices.

Each process drives its own devices of the mesh; a data axis may span the
processes of a `torch.distributed` group (`make_mesh(..., runtime=)`).  Port of `multihop_offload_tpu/parallel/` (`mesh`, `ring`, `partition`,
`data_parallel`), plus `collectives`, the counterparts of the `lax`
collectives JAX runs inside `shard_map`.  `parallel/compat.py` is a JAX
version shim and has no counterpart.
"""

from multihop_offload_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    global_batch,
    init_distributed,
    make_mesh,
)
from multihop_offload_tpu_torch.parallel.ring import (  # noqa: F401
    ring_minplus_square,
    sharded_apsp,
)
from multihop_offload_tpu_torch.parallel.data_parallel import (  # noqa: F401
    make_dp_eval_step,
    make_dp_train_step,
    make_multichip_train_step,
)
from multihop_offload_tpu_torch.parallel.partition import (  # noqa: F401
    halo_matmul,
    sharded_chebnet_apply,
    sharded_interference_fixed_point,
    sharded_spectral_forward,
)
