"""Device-side metric accumulators for loops that run on the card.

Port of `multihop_offload_tpu/obs/devmetrics.py`.  A `DevMetrics` object
declares its metrics once (names, static labels, histogram boundaries) and
is frozen; the accumulators are a dict of tensors on the run's device,
updated with tensor operations only, so counting adds no host sync to the
loop that carries them.  `flush` fetches a window's accumulators in one
transfer per dtype kind (ints, floats) at a sync the caller already pays
for, and merges them into the port's `obs.registry`.

Accumulator semantics: one window, starting at zero.  Counters sum masks
or amounts, gauges keep the last value written, histograms bucket weighted
observations (Prometheus `le` boundaries plus a +Inf tail) with exact
sum/min/max.  `init(batch_shape)` gives every accumulator leading axes
(the sim's fleet lanes): `inc` and `observe` then sum each lane's own
entries, and `flush` merges the leading axes as replicas (counters and
buckets sum, min and max reduce, gauges average), as the JAX flush merges
`vmap` lanes.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from multihop_offload_tpu_torch.obs.registry import MetricRegistry, registry


class _Decl:
    __slots__ = ("kind", "key", "name", "help", "labels", "buckets", "dtype")

    def __init__(self, kind, key, name, help_, labels, buckets, dtype):
        self.kind = kind
        self.key = key
        self.name = name
        self.help = help_
        self.labels = labels
        self.buckets = buckets
        self.dtype = dtype


def _default_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def _lane_sum(acc: torch.Tensor, amount: torch.Tensor, dtype) -> torch.Tensor:
    """`amount` cast to `dtype` and summed over every axis past `acc`'s
    (a scalar or an array no wider than `acc` broadcasts as it is)."""
    amt = amount.to(dtype)
    if amt.dim() > acc.dim():
        amt = amt.reshape(*acc.shape, -1).sum(-1, dtype=dtype)
    return amt


class DevMetrics:
    """A metric declaration and the pure update and flush operations over
    its accumulators.  Declaration methods return the key the update
    operations take; two declarations of one name with different static
    labels get distinct keys (and flush into distinct registry series)."""

    def __init__(self):
        self._decls: Dict[str, _Decl] = {}
        self._frozen = False
        # histogram boundaries as tensors, by (key, device): made once, so
        # an update copies nothing from the host
        self._bounds: Dict[tuple, torch.Tensor] = {}

    # ---- declaration (host, build time) ---------------------------------

    def _declare(self, kind, name, help_, labels, buckets, dtype, key):
        if self._frozen:
            raise RuntimeError(
                "DevMetrics is frozen: declare every metric before the first "
                "init() (the declaration fixes the accumulators' structure)")
        key = key or _default_key(name, labels)
        if key in self._decls:
            raise ValueError(f"duplicate devmetric key '{key}'")
        self._decls[key] = _Decl(kind, key, name, help_, dict(labels), buckets, dtype)
        return key

    def counter(self, name: str, help_: str = "", *, dtype=None,
                key: Optional[str] = None, **labels) -> str:
        """Sum accumulator, int32 by default (exact against the sim's
        int32 counters); a float dtype sums real-valued amounts."""
        return self._declare("c", name, help_, labels, None, dtype or torch.int32, key)

    def gauge(self, name: str, help_: str = "", *, dtype=None,
              key: Optional[str] = None, **labels) -> str:
        """Last-value-wins accumulator (flush averages replicas)."""
        return self._declare("g", name, help_, labels, None, dtype or torch.float32, key)

    def histogram(self, name: str, buckets: Iterable[float], help_: str = "", *,
                  dtype=None, key: Optional[str] = None, **labels) -> str:
        """Fixed-bucket histogram (`le` boundaries and a +Inf tail) with
        exact per-window sum/min/max beside the bucket counts."""
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket boundary")
        return self._declare("h", name, help_, labels, b, dtype or torch.float32, key)

    def freeze(self) -> "DevMetrics":
        self._frozen = True
        return self

    # ---- accumulators (tensors on the run's device) ----------------------

    def init(self, batch_shape: Tuple[int, ...] = (), device=None) -> dict:
        """Zero accumulators for one window, each with leading axes
        `batch_shape`, on `device` (default the CPU).  Freezes the
        declaration."""
        self._frozen = True
        shape = tuple(batch_shape)
        c, g, h = {}, {}, {}
        for d in self._decls.values():
            if d.kind == "c":
                c[d.key] = torch.zeros(shape, dtype=d.dtype, device=device)
            elif d.kind == "g":
                g[d.key] = torch.zeros(shape, dtype=d.dtype, device=device)
            else:
                h[d.key] = {
                    "counts": torch.zeros(shape + (len(d.buckets) + 1,),
                                          dtype=torch.int32, device=device),
                    "sum": torch.zeros(shape, dtype=d.dtype, device=device),
                    "min": torch.full(shape, float("inf"), dtype=d.dtype, device=device),
                    "max": torch.full(shape, float("-inf"), dtype=d.dtype, device=device),
                }
        return {"c": c, "g": g, "h": h}

    def _decl(self, key: str, kind: str) -> _Decl:
        d = self._decls.get(key)
        if d is None or d.kind != kind:
            raise KeyError(f"no {kind!r} devmetric with key '{key}'")
        return d

    def inc(self, dev: dict, key: str, amount=1) -> dict:
        """Counter add: `amount` may be a scalar, a bool mask (counts its
        True entries) or any tensor (summed), lane by lane over the
        accumulator's leading axes.  Returns new accumulators."""
        d = self._decl(key, "c")
        acc = dev["c"][key]
        c = dict(dev["c"])
        c[key] = acc + _lane_sum(acc, torch.as_tensor(amount, device=acc.device), d.dtype)
        return {"c": c, "g": dev["g"], "h": dev["h"]}

    def set(self, dev: dict, key: str, value) -> dict:
        """Gauge write (last value wins within the window)."""
        d = self._decl(key, "g")
        acc = dev["g"][key]
        g = dict(dev["g"])
        g[key] = torch.as_tensor(value, device=acc.device).to(d.dtype).expand(acc.shape)
        return {"c": dev["c"], "g": g, "h": dev["h"]}

    def observe(self, dev: dict, key: str, values, weights=None) -> dict:
        """Histogram update: bucket every element of `values` past the
        accumulator's leading axes; `weights` (same shape, int) weights or
        masks observations, and weight-0 entries leave counts and
        sum/min/max untouched."""
        d = self._decl(key, "h")
        h = dev["h"][key]
        lead = h["sum"].shape
        v = torch.as_tensor(values, device=h["sum"].device).to(d.dtype)
        v = v.reshape(*lead, -1)
        w = (torch.ones(v.shape, dtype=torch.int32, device=v.device) if weights is None
             else torch.as_tensor(weights, device=v.device).to(torch.int32).reshape(v.shape))
        bounds = self._bounds.get((key, v.device))
        if bounds is None:
            bounds = self._bounds[(key, v.device)] = torch.tensor(
                d.buckets, dtype=d.dtype, device=v.device)
        # the first boundary >= v: Prometheus `v <= le`; past the last one,
        # the +Inf tail
        idx = torch.searchsorted(bounds, v.contiguous(), right=False)
        nb = h["counts"].shape[-1]
        onehot = idx.unsqueeze(-1) == torch.arange(nb, device=v.device)
        delta = (onehot * w.unsqueeze(-1)).sum(-2, dtype=torch.int32)
        live = w > 0
        inf = torch.full((), float("inf"), dtype=d.dtype, device=v.device)
        new = {
            "counts": h["counts"] + delta,
            "sum": h["sum"] + (v * w.to(d.dtype)).sum(-1),
            "min": torch.minimum(h["min"], torch.where(live, v, inf).amin(-1)),
            "max": torch.maximum(h["max"], torch.where(live, v, -inf).amax(-1)),
        }
        hh = dict(dev["h"])
        hh[key] = new
        return {"c": dev["c"], "g": dev["g"], "h": hh}

    def merge(self, a: dict, b: dict) -> dict:
        """Combine two windows: counters and bucket counts add, min/max
        reduce, gauges take `b` (the later window)."""
        c = {k: a["c"][k] + b["c"][k] for k in a["c"]}
        g = dict(b["g"])
        h = {}
        for k, ha in a["h"].items():
            hb = b["h"][k]
            h[k] = {
                "counts": ha["counts"] + hb["counts"],
                "sum": ha["sum"] + hb["sum"],
                "min": torch.minimum(ha["min"], hb["min"]),
                "max": torch.maximum(ha["max"], hb["max"]),
            }
        return {"c": c, "g": g, "h": h}

    # ---- host-side flush -------------------------------------------------

    @staticmethod
    def _fetch(dev: dict) -> dict:
        """The accumulators as numpy arrays of their own dtypes, moved in
        two transfers: every integer leaf widened to int64 in one vector,
        every float leaf to float64 in another (widening casts, so the
        round trip is exact)."""
        leaves = []

        def walk(tree, path):
            for k in sorted(tree):
                if isinstance(tree[k], dict):
                    walk(tree[k], path + (k,))
                else:
                    leaves.append((path + (k,), tree[k]))

        walk(dev, ())
        ints = [x for _, x in leaves if not x.is_floating_point()]
        flts = [x for _, x in leaves if x.is_floating_point()]
        host = {
            False: (torch.cat([x.reshape(-1).to(torch.int64) for x in ints]).cpu().numpy()
                    if ints else None),
            True: (torch.cat([x.reshape(-1).to(torch.float64) for x in flts]).cpu().numpy()
                   if flts else None),
        }
        offset = {False: 0, True: 0}
        out: dict = {}
        for path, x in leaves:
            kind = x.is_floating_point()
            n = x.numel()
            arr = host[kind][offset[kind]:offset[kind] + n]
            offset[kind] += n
            np_dt = torch.empty((), dtype=x.dtype).numpy().dtype
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = arr.astype(np_dt).reshape(tuple(x.shape))
        return out

    def flush(self, dev: dict, reg: Optional[MetricRegistry] = None, **labels) -> dict:
        """Merge one window's accumulators into the registry and return
        the merged plain values.  Leading axes are replicas: counters and
        bucket counts sum over them, histogram min/max reduce, gauges
        average.  `labels` are added to every series."""
        reg = reg if reg is not None else registry()
        dev = self._fetch(dev)
        out = {}
        for d in self._decls.values():
            lab = {**d.labels, **labels}
            if d.kind == "c":
                total = float(np.sum(dev["c"][d.key]))
                reg.counter(d.name, d.help).inc(total, **lab)
                out[d.key] = total
            elif d.kind == "g":
                val = float(np.mean(dev["g"][d.key]))
                reg.gauge(d.name, d.help).set(val, **lab)
                out[d.key] = val
            else:
                h = dev["h"][d.key]
                counts = np.asarray(h["counts"], np.int64)
                counts = counts.reshape(-1, counts.shape[-1]).sum(axis=0)
                total = int(counts.sum())
                s = float(np.sum(h["sum"]))
                mn = float(np.min(h["min"])) if total else None
                mx = float(np.max(h["max"])) if total else None
                reg.histogram(d.name, d.help, buckets=d.buckets) \
                    .observe_bucketed(counts.tolist(), s, mn, mx, **lab)
                out[d.key] = {"count": total, "sum": s, "min": mn, "max": mx,
                              "counts": counts.tolist()}
        return out

    # ---- introspection ---------------------------------------------------

    def buckets_of(self, key: str) -> Tuple[float, ...]:
        return self._decl(key, "h").buckets

    def keys(self) -> Tuple[str, ...]:
        return tuple(self._decls)


def pow2_buckets(hi: int) -> Tuple[float, ...]:
    """Power-of-two occupancy ladder 0, 1, 2, 4, ..., hi: the boundaries
    for queue depths bounded by a ring-buffer capacity."""
    out = [0.0, 1.0]
    b = 2
    while b < hi:
        out.append(float(b))
        b *= 2
    out.append(float(hi))
    return tuple(dict.fromkeys(out))
