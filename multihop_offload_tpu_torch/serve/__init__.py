"""The offloading-decision service on one device.

Port of `multihop_offload_tpu/serve/` (single device): admission guards,
shape buckets, packing, one batched decision pass per non-empty bucket per
tick, demultiplexing, deadline degradation to the baseline, the occupancy
ladder and overlapped ticks.  `cli/serve.py` builds it from a `Config`.
"""
