"""Named fault sites + seeded corruption helpers.

Port of `multihop_offload_tpu/chaos/faults.py`.  Production code marks its
interruptible moments with `crashpoint("site")` and its fallible I/O with
`io_gate("site")`.  Both are no-ops (one dict lookup) unless a drill has
armed a `FaultPlan`, so the hooks are safe to leave in hot paths.  A drill
arms a plan, runs the workload, and the hooks raise at exactly the named
site:

- `crashpoint` raises `SimulatedCrash` -- a `BaseException` subclass so no
  `except Exception` recovery path in the workload can swallow it; the
  drill catches it at the top and "restarts the process" by re-running the
  entry point against the same on-disk state (a SIGKILL equivalent).
- `io_gate` raises `TransientIOError` (an `OSError`) for the first
  `plan.io_fail[site]` hits at the site -- the retry/backoff machinery must
  absorb it.

The sites: `ckpt:save` and `ckpt:restore` (`train/checkpoints.py`),
`events:write` (`obs/events.py`), `journal:write` (`loop/promote.py`), the
crash sites of `loop/refit.py`, `loop/promote.py` and `cli/loop.py`.

Corruption helpers (`truncate_file`, `bit_flip_file`, `torn_tail`) mutate
files the way real crashes and bit-rot do, seeded for determinism: the
same file and seed give the JAX package's bytes.  `poison_checkpoint`
breaks meaning instead of bytes, over the port's checkpoint trees, and
`fuzz_request` the semantics of one request.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, Optional

import numpy as np


class SimulatedCrash(BaseException):
    """Process death at a named site.  BaseException on purpose: recovery
    code under test must never be able to catch and absorb it."""

    def __init__(self, site: str):
        super().__init__(f"simulated crash at {site}")
        self.site = site


class TransientIOError(OSError):
    """An injected transient I/O failure (storage hiccup, flaky mount)."""


class FaultPlan:
    """One drill's armed faults.

    crash_at: site name -> SimulatedCrash on the Nth hit (1-based, default
    first).  io_fail: site name -> number of consecutive TransientIOErrors
    to inject before letting the call through."""

    def __init__(self, crash_at: Optional[Dict[str, int]] = None,
                 io_fail: Optional[Dict[str, int]] = None):
        self.crash_at = dict(crash_at or {})
        self.io_fail = dict(io_fail or {})
        self.hits: Dict[str, int] = {}       # crashpoint visit counts
        self.io_hits: Dict[str, int] = {}    # io_gate injected-failure counts
        self.fired: Dict[str, int] = {}      # site -> hit index that crashed


_plan: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    global _plan
    _plan = plan


def clear() -> None:
    install(None)


def active_plan() -> Optional[FaultPlan]:
    return _plan


def crashpoint(site: str) -> None:
    """Mark an interruptible moment.  No-op unless a plan arms `site`."""
    p = _plan
    if p is None:
        return
    n = p.hits.get(site, 0) + 1
    p.hits[site] = n
    want = p.crash_at.get(site)
    if want is not None and n >= want:
        del p.crash_at[site]           # fire once, then the restart survives
        p.fired[site] = n
        raise SimulatedCrash(site)


def io_gate(site: str) -> None:
    """Mark fallible I/O.  Raises TransientIOError for the first
    `plan.io_fail[site]` hits, then lets calls through."""
    p = _plan
    if p is None:
        return
    left = p.io_fail.get(site, 0)
    if left > 0:
        p.io_fail[site] = left - 1
        p.io_hits[site] = p.io_hits.get(site, 0) + 1
        raise TransientIOError(f"injected transient I/O failure at {site}")


# ---- seeded corruption helpers ---------------------------------------------


def truncate_file(path: str, keep_fraction: float = 0.5) -> int:
    """Truncate `path` to `keep_fraction` of its size (a partial write).
    Returns the new size."""
    size = os.path.getsize(path)
    new = max(int(size * keep_fraction), 0)
    with open(path, "r+b") as f:
        f.truncate(new)
    return new


def bit_flip_file(path: str, seed: int, flips: int = 8) -> list:
    """Flip `flips` seeded-random bits in `path` (bit-rot).  Returns the
    byte offsets touched."""
    rng = random.Random(seed)  # nondet-ok(seeded stdlib RNG: deterministic corruption pattern)
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        if not data:
            return []
        offsets = []
        for _ in range(flips):
            i = rng.randrange(len(data))
            data[i] ^= 1 << rng.randrange(8)
            offsets.append(i)
        f.seek(0)
        f.write(data)
        f.truncate(len(data))
    return offsets


def torn_tail(path: str, garbage: bytes = b'{"event": "tick", "ts\xff\xfe') -> None:
    """Append a torn final record -- a partial JSON line with invalid UTF-8,
    exactly what a crash mid-`write()` leaves behind (no trailing
    newline)."""
    with open(path, "ab") as f:
        f.write(garbage)


# ---- semantic fault families -----------------------------------------------
# The corruption helpers above break BYTES; these break MEANING.  A
# weight-poisoned checkpoint is saved through the normal path and therefore
# carries a perfectly valid integrity checksum -- it is exactly the fault
# class `train.checkpoints.restore_verified` cannot see and the semantic
# canary (`loop.canary`) exists to catch.  The request mutations produce
# OffloadRequests that are shape-compatible with the buckets but
# semantically wrong -- the admission guards' (`serve.guards`) fault diet.

POISON_MODES = ("nan", "inf", "scale")


def _map_sorted(tree, fn):
    """`fn` over every leaf of a nested dict, visiting keys in sorted order
    (the order `jax.tree_util` flattens a dict in), structure kept."""
    if isinstance(tree, dict):
        out = {k: None for k in tree}
        for k in sorted(tree):
            out[k] = _map_sorted(tree[k], fn)
        return out
    return fn(tree)


def poison_checkpoint(directory: str, mode: str = "nan", seed: int = 0,
                      fraction: float = 0.25) -> int:
    """Save a weight-poisoned -- but checksum-VALID -- checkpoint at
    `latest+1` of a checkpoint directory of the port (`train/checkpoints`).

    Restores the latest verified step, poisons `fraction` of each float
    leaf's entries (seeded, leaves in sorted key order): NaN / Inf
    injection, or a 1e6 scale blowup (finite, so finiteness checks alone
    miss it -- only the canary's decision-agreement probe can).  The
    poisoned tree goes through the NORMAL `save_checkpoint` path, so it
    gets a fresh, valid integrity checksum and `source="poison"` lineage.
    Returns the poisoned step id."""
    import torch

    from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

    if mode not in POISON_MODES:
        raise ValueError(f"unknown poison mode '{mode}'; one of {POISON_MODES}")
    restored, step = ckpt_lib.restore_verified(directory)
    if restored is None:
        raise ValueError(f"no verified checkpoint to poison in {directory}")
    rng = np.random.default_rng(seed)

    def poison(x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        a = x.detach().cpu().clone()
        flat = a.reshape(-1)
        k = max(int(flat.numel() * fraction), 1)
        idx = torch.from_numpy(rng.choice(flat.numel(), size=min(k, flat.numel()),
                                          replace=False))
        if mode == "nan":
            flat[idx] = float("nan")
        elif mode == "inf":
            flat[idx] = float("inf")
        else:
            flat[idx] = flat[idx] * 1e6
        return a

    poisoned = _map_sorted(restored, poison)
    new_step = step + 1
    ckpt_lib.save_checkpoint(
        directory, new_step, poisoned,
        lineage=ckpt_lib.make_lineage(
            "poison", parent_step=step, parent_dir=directory,
            extra={"poison": mode, "fraction": fraction, "seed": seed},
        ),
    )
    return new_step


# request mutations: name -> expected admission-guard rejection reason
REQUEST_MUTATIONS = (
    ("nan_rate", "nonfinite"),
    ("negative_rate", "nonpositive_rate"),
    ("oob_src", "bad_node_id"),
    ("relay_src", "bad_role"),
    ("len_mismatch", "bad_shape"),
    ("nonfinite_bw", "nonfinite"),
    ("saturated", "saturated"),
)


def fuzz_request(req, mutation: str, seed: int = 0):
    """Return a semantically-broken copy of a VALID OffloadRequest.

    Each mutation is minimal -- one field family perturbed -- so the
    admission guards' typed `reason` is predictable (the second element of
    the matching `REQUEST_MUTATIONS` row); everything else stays
    bit-identical to the input."""
    rng = np.random.default_rng(seed)
    job_rate = np.array(req.job_rate, dtype=np.float64, copy=True)
    if mutation == "nan_rate":
        job_rate[rng.integers(job_rate.size)] = np.nan
        return dataclasses.replace(req, job_rate=job_rate)
    if mutation == "negative_rate":
        job_rate[rng.integers(job_rate.size)] = -0.25
        return dataclasses.replace(req, job_rate=job_rate)
    if mutation == "oob_src":
        job_src = np.array(req.job_src, copy=True)
        job_src[rng.integers(job_src.size)] = req.topo.n + 7
        return dataclasses.replace(req, job_src=job_src)
    if mutation == "relay_src":
        # point one job at a non-mobile node: valid id, wrong role
        non_mobile = np.flatnonzero(np.asarray(req.roles) != 0)
        job_src = np.array(req.job_src, copy=True)
        job_src[rng.integers(job_src.size)] = int(non_mobile[-1])
        return dataclasses.replace(req, job_src=job_src)
    if mutation == "len_mismatch":
        return dataclasses.replace(req, job_rate=job_rate[:-1])
    if mutation == "nonfinite_bw":
        proc = np.array(req.proc_bws, dtype=np.float64, copy=True)
        proc[rng.integers(proc.size)] = np.inf
        return dataclasses.replace(req, proc_bws=proc)
    if mutation == "saturated":
        return dataclasses.replace(req, job_rate=job_rate * 1e9)
    raise ValueError(f"unknown request mutation '{mutation}'; one of "
                     f"{[m for m, _ in REQUEST_MUTATIONS]}")
