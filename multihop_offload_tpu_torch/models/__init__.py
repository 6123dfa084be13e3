from multihop_offload_tpu_torch.models.tf_import import (  # noqa: F401
    load_reference_checkpoint,
    save_reference_checkpoint,
)
