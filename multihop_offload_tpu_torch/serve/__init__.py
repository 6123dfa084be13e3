"""The offloading-decision service, on one device or sharded over a fleet.

Port of `multihop_offload_tpu/serve/`: admission guards, shape buckets,
packing, one batched decision pass per non-empty bucket per tick,
demultiplexing, deadline degradation to the baseline, the occupancy
ladder and overlapped ticks; under a fleet, the placement planner
(`placement`) and the sharded executor (`sharded`).  `cli/serve.py` builds
it from a `Config`.
"""
