"""Distributed link scheduling: local-greedy maximum-weight independent set.

Port of `multihop_offload_tpu/env/scheduling.py`, batched over a leading
axis B.  Each sweep, every remaining vertex compares its weight against
its remaining neighbours and joins the set when it strictly wins, or ties
and has a lower index than the lowest-indexed tied neighbour; winners'
neighbours are eliminated.

The JAX function runs one instance's `lax.while_loop` on `remain.any()`
under `vmap`.  Here one loop sweeps the whole batch until no instance has
a remaining vertex: a sweep of an instance with nothing left changes
nothing, so every instance ends with the set its own loop gives.  Each
test of the loop condition reads one bool back from the device (a host
sync on the card); `local_greedy_mwis.sweeps` counts the sweeps run.
"""

from __future__ import annotations

import torch


def local_greedy_mwis(
    adj: torch.Tensor,
    wts: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy MWIS on a batch of conflict graphs.

    adj: (B, L, L) 0/1 adjacency; wts: (B, L) vertex weights; mask: (B, L)
    bool active vertices (padding stays out of the set).  Returns (in_set
    bool (B, L), total weight (B,)), equal to the JAX function's, its tie
    rule included."""
    b, n = wts.shape
    remain = (torch.ones((b, n), dtype=torch.bool, device=wts.device)
              if mask is None else mask.to(torch.bool))
    idx = torch.arange(n, device=wts.device, dtype=torch.long)
    adj_b = adj > 0
    in_set = torch.zeros((b, n), dtype=torch.bool, device=wts.device)
    neg_inf = torch.full((), float("-inf"), dtype=wts.dtype, device=wts.device)
    w_cols = wts.unsqueeze(1)                                    # (B, 1, L)
    while bool(remain.any()):
        local_greedy_mwis.sweeps += 1
        nb = adj_b & remain.unsqueeze(1)       # nb[b, v, u]: u remains, next to v
        has_nb = nb.any(dim=2)
        nb_max = torch.where(nb, w_cols, neg_inf).amax(dim=2)
        tied = nb & (w_cols == nb_max.unsqueeze(2))
        # lowest tied index (L where none: then either v has no remaining
        # neighbour, and joins, or nb_max is NaN, which ties nothing)
        first_tied = torch.where(tied, idx, n).amin(dim=2)
        join = ~has_nb | (wts > nb_max) | ((wts == nb_max) & (idx < first_tied))
        new = remain & join
        eliminated = (adj_b & new.unsqueeze(1)).any(dim=2)
        remain = remain & ~new & ~eliminated
        in_set = in_set | new
    return in_set, torch.where(in_set, wts, torch.zeros((), dtype=wts.dtype,
                                                        device=wts.device)).sum(dim=1)


local_greedy_mwis.sweeps = 0
