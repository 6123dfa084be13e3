"""Congestion-agnostic baseline unit delays (port of
`multihop_offload_tpu/env/baseline.py`): per-link 1/rate, per-node
1/proc_bw (+inf for relays and padding, whose proc_bw is 0)."""

from __future__ import annotations


def baseline_unit_delays(inst):
    """Returns (link_delays (B, L), node_delays (B, N))."""
    return 1.0 / inst.link_rates, 1.0 / inst.proc_bws
