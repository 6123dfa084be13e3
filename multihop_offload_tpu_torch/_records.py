"""Dataclasses of tensors: moving them between devices, stacking and slicing
them.

The port's counterpart of JAX pytrees.  A record's fields are tensors,
nested records, None (an absent optional part, such as `Instance.sparse`
under the dense layout) or static values (a COO's logical shape), which
are kept as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


class TensorRecord:
    """Base of a dataclass whose fields are tensors or nested records."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: _to(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
        })


def _to(value, device):
    if isinstance(value, (torch.Tensor, TensorRecord)):
        return value.to(device)
    return value


def stack_records(items: Sequence):
    """Stack same-shape records along a new leading batch axis, field by
    field; nested records recurse, None and static fields are kept."""
    first = items[0]
    out = {}
    for f in dataclasses.fields(first):
        value = getattr(first, f.name)
        if isinstance(value, torch.Tensor):
            out[f.name] = torch.stack([getattr(it, f.name) for it in items])
        elif isinstance(value, TensorRecord):
            out[f.name] = stack_records([getattr(it, f.name) for it in items])
        else:
            out[f.name] = value
    return dataclasses.replace(first, **out)


def cat_records(items: Sequence):
    """Concatenate same-shape batched records along their batch axis,
    field by field; nested records recurse, None and static fields are
    kept."""
    first = items[0]
    out = {}
    for f in dataclasses.fields(first):
        value = getattr(first, f.name)
        if isinstance(value, torch.Tensor):
            out[f.name] = torch.cat([getattr(it, f.name) for it in items])
        elif isinstance(value, TensorRecord):
            out[f.name] = cat_records([getattr(it, f.name) for it in items])
        else:
            out[f.name] = value
    return dataclasses.replace(first, **out)


def slice_records(item, start: int, stop: int):
    """Rows [start, stop) of a batched record, tensor or dict of either
    along its batch axis; nested records recurse, None and static fields
    are kept."""
    if isinstance(item, torch.Tensor):
        return item[start:stop]
    if isinstance(item, dict):
        return {k: slice_records(v, start, stop) for k, v in item.items()}
    out = {}
    for f in dataclasses.fields(item):
        value = getattr(item, f.name)
        if isinstance(value, (torch.Tensor, TensorRecord)):
            out[f.name] = slice_records(value, start, stop)
    return dataclasses.replace(item, **out)
