"""Checkpoints of the full training state, with integrity and lineage.

Port of the parts of `multihop_offload_tpu/train/checkpoints.py` that the
drivers call, with no orbax: a state is a nested dict of tensors (and
ints), written with `torch.save` as CPU tensors into
``<directory>/<step>/state.pt``.  Every save also writes atomically

* ``integrity/<step>.json``: a content sha256 of the state
  (`tree_checksum`), checked by every restore;
* ``lineage/<step>.json`` (when given): where the state came from.

A step directory is renamed into place only after its file and integrity
sidecar are written, so `latest_step` never sees a half-written step.
Retention keeps the newest `MAX_TO_KEEP` steps, as the JAX
`CheckpointManager(max_to_keep=3)` does.  The drivers keep their states
in ``torch/`` and ``torch_best/`` of the model directory, beside the JAX
package's ``orbax/`` and ``orbax_best/``, which the port never reads.

The integrity layer of JAX `train/checkpoints.py:199-300`, which the
service's hot reload runs on: `restore_verified` re-hashes a step against
its sidecar, moves a truncated, bit-flipped or unreadable step into
``quarantine/`` (non-numeric, so `all_steps` never lists it again) with a
typed `ckpt_quarantine` event, and falls back to the next-newest step;
`has_verified` is the same check without side effects; `gc_checkpoints`
is bounded retention with a `gc` event per deleted step.  As in JAX, a
step with no sidecar restores unverified there (`restore_checkpoint_raw`,
the drivers' restore, refuses it).  The chaos hooks sit where JAX has
them (`chaos.faults.io_gate`): ``ckpt:save`` in every save attempt,
``ckpt:restore`` in every attempt of `restore_verified`.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from multihop_offload_tpu_torch.chaos import faults
from multihop_offload_tpu_torch.utils.durable import (
    atomic_write_json,
    load_json,
    with_backoff,
)

MAX_TO_KEEP = 3
STATE_FILE = "state.pt"


class IntegrityError(RuntimeError):
    """A checkpoint whose content does not match its integrity sidecar."""


def _flatten(tree: Any, prefix: str = "") -> list:
    """[(key path, leaf)] of a nested dict / list tree, in insertion order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _host(x: Any) -> np.ndarray:
    """A leaf as a numpy array.  numpy has no bfloat16: a bf16 tensor (a
    state saved at a bf16 base) comes as its 16-bit words."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _dtype_name(x: Any) -> str:
    """A leaf's dtype as numpy names it; bf16 under the name JAX's arrays
    carry (ml_dtypes' `bfloat16`)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(_host(x).dtype)


def tree_checksum(tree: Any) -> str:
    """Content sha256 of a state tree: (key path, dtype, shape, raw bytes)
    per leaf in key-path order."""
    h = hashlib.sha256()
    for path, x in sorted(_flatten(tree), key=lambda kv: kv[0]):
        a = np.ascontiguousarray(_host(x))
        h.update(path.encode())
        h.update(_dtype_name(x).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return torch.as_tensor(tree)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), str(int(step)))


def _integrity_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), "integrity", f"{int(step)}.json")


def _lineage_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), "lineage", f"{int(step)}.json")


def save_checkpoint(directory: str, step: int, state: Any,
                    lineage: Optional[dict] = None) -> None:
    """Write `state` (nested dicts of tensors / ints) as step `step`, with
    its integrity sidecar and, when given, its lineage sidecar; then drop
    all but the newest `MAX_TO_KEEP` steps.  `step` must be new: a step
    already on disk is kept as it is and the save raises."""
    final = _step_dir(directory, step)
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint step {step} already exists in {directory}")
    cpu = _to_cpu(state)
    tmp = final + ".tmp"

    def _save() -> None:
        faults.io_gate("ckpt:save")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(cpu, os.path.join(tmp, STATE_FILE))

    with_backoff(_save, site="ckpt:save")
    atomic_write_json(_integrity_path(directory, step),
                      {"step": int(step), "algo": "sha256", "sha256": tree_checksum(cpu)},
                      site="ckpt:integrity")
    if lineage is not None:
        atomic_write_json(_lineage_path(directory, step), {"step": int(step), **lineage},
                          site="ckpt:lineage")
    os.replace(tmp, final)
    for old in all_steps(directory)[:-MAX_TO_KEEP]:
        shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
        for side in (_integrity_path(directory, old), _lineage_path(directory, old)):
            if os.path.exists(side):
                os.remove(side)


def make_lineage(source: str, parent_step: Optional[int] = None,
                 parent_dir: Optional[str] = None, cfg=None,
                 extra: Optional[dict] = None) -> dict:
    """Provenance record for a checkpoint: who trained it, from what
    (`source`: "offline" for the file-visit Trainer)."""
    from multihop_offload_tpu_torch.obs import events as obs_events

    lin = {
        "source": source,
        "ts": time.time(),  # nondet-ok(lineage stamp: when the checkpoint was written)
        "git_sha": obs_events._git_sha(),
        "config_hash": obs_events.config_hash(cfg) if cfg is not None else None,
        "parent_step": parent_step,
        "parent_dir": os.path.abspath(parent_dir) if parent_dir else None,
    }
    if extra:
        lin.update(extra)
    return lin


def load_lineage(directory: str, step: Optional[int] = None) -> Optional[dict]:
    """The lineage sidecar of `step` (default: the latest step), or None."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None
    return load_json(_lineage_path(directory, step))


def all_steps(directory: str) -> List[int]:
    """The complete steps in `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit()
                  and os.path.isfile(os.path.join(directory, name, STATE_FILE)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def load_integrity(directory: str, step: int) -> Optional[dict]:
    """The integrity sidecar of `step`, or None when there is none."""
    return load_json(_integrity_path(directory, step))


def _load_state(directory: str, step: int):
    """The state of `step` as written.  The file is read first, so an
    `OSError` is the file system's (transient, retried by the callers);
    bytes that do not unpickle (torch's zip reader raises `OSError` on a
    torn file too) raise `IntegrityError`."""
    path = os.path.join(_step_dir(directory, step), STATE_FILE)
    with open(path, "rb") as f:
        data = f.read()
    try:
        return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
    except Exception as e:
        raise IntegrityError(f"checkpoint step {step} in {directory} does not load: "
                             f"{e}") from e


def restore_checkpoint_raw(directory: str, step: Optional[int] = None):
    """The state of `step` (default latest) exactly as written, after its
    content is checked against the integrity sidecar: a missing,
    unreadable or mismatched sidecar raises `IntegrityError`.  None when
    there is no step."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    state = with_backoff(lambda: _load_state(directory, step), site="ckpt:restore")
    integ = load_integrity(directory, step)
    if integ is None or integ.get("sha256") != tree_checksum(state):
        raise IntegrityError(
            f"checkpoint step {step} in {directory} does not match its integrity "
            "sidecar (missing, unreadable or a different checksum); refusing it")
    return state


def leaf_shapes(tree: Any) -> list:
    """Sorted (key path, shape) of every leaf."""
    return sorted((p, tuple(np.shape(_host(x)))) for p, x in _flatten(tree))


def _signature(tree: Any) -> list:
    return sorted((p, tuple(np.shape(_host(x))), _dtype_name(x)) for p, x in _flatten(tree))


def restore_checkpoint(directory: str, template: Any, step: Optional[int] = None):
    """Restore into the structure, shapes and dtypes of `template`: the
    restored state (CPU tensors), or None when there is no step.  Raises
    ValueError when the saved tree's key paths, shapes or dtypes differ
    from the template's, and `IntegrityError` on a content mismatch."""
    state = restore_checkpoint_raw(directory, step)
    if state is None:
        return None
    if _signature(state) != _signature(template):
        raise ValueError(f"checkpoint in {directory} does not match the state's "
                         "structure, shapes or dtypes")
    return state


# ---- integrity: verified restore, quarantine, retention --------------------


def quarantine_step(directory: str, step: int, reason: str) -> Optional[str]:
    """Move a corrupt step's directory into ``directory/quarantine/`` (a
    non-numeric directory `all_steps` ignores), count it in
    `mho_ckpt_quarantined_total` and emit `ckpt_quarantine`.  Returns the
    quarantine path, or None when the step directory is already gone."""
    from multihop_offload_tpu_torch.obs import events as obs_events
    from multihop_offload_tpu_torch.obs.registry import registry

    src = _step_dir(directory, step)
    dst = None
    if os.path.exists(src):
        qdir = os.path.join(os.path.abspath(directory), "quarantine")
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, os.path.basename(src))
        n = 1
        while os.path.exists(dst):
            dst = os.path.join(qdir, f"{os.path.basename(src)}.{n}")
            n += 1
        os.replace(src, dst)
    registry().counter("mho_ckpt_quarantined_total", "corrupt checkpoints quarantined"
                       ).inc(dir=os.path.basename(os.path.abspath(directory)))
    obs_events.emit("ckpt_quarantine", dir=os.path.abspath(directory), step=int(step),
                    reason=reason, moved_to=dst)
    return dst


def restore_verified(directory: str, step: Optional[int] = None,
                     sleep=time.sleep) -> Tuple[Any, Optional[int]]:
    """Restore `step` (default latest), re-hash it against its integrity
    sidecar, and on any corruption signal (an unreadable step, a checksum
    mismatch) quarantine it and try the next-newest.  Transient `OSError`s
    retry with backoff first and then raise.  Returns ``(state, step)``,
    or ``(None, None)`` when no verified step survives."""
    want = step
    while True:
        s = want if want is not None else latest_step(directory)
        if s is None:
            return None, None
        want = None  # after the pinned attempt, fall back through latest
        def _restore():
            faults.io_gate("ckpt:restore")
            return _load_state(directory, s)

        try:
            restored = with_backoff(_restore, site="ckpt:restore", sleep=sleep)
        except FileNotFoundError as e:
            quarantine_step(directory, s, f"missing data: {e}")
            continue
        except OSError:
            raise  # transient budget exhausted: surface, do not quarantine
        except Exception as e:  # a torn file fails to unpickle in many ways
            quarantine_step(directory, s, f"restore failed: {e}")
            continue
        integ = load_integrity(directory, s)
        if integ is not None and tree_checksum(restored) != integ.get("sha256"):
            quarantine_step(directory, s, "content checksum mismatch")
            continue
        return restored, s


def has_verified(directory: str, step: int) -> bool:
    """True when `step` exists, loads, and matches its integrity sidecar."""
    try:
        restored = _load_state(directory, step)
    except Exception:
        return False
    integ = load_integrity(directory, step)
    return integ is not None and tree_checksum(restored) == integ.get("sha256")


def gc_checkpoints(directory: str, keep: int, reason: str = "retention") -> List[int]:
    """Bounded retention: delete all but the newest `keep` steps (step
    directory and sidecars), with a `gc` event and `mho_ckpt_gc_total` per
    deletion.  Returns the deleted steps."""
    from multihop_offload_tpu_torch.obs import events as obs_events
    from multihop_offload_tpu_torch.obs.registry import registry

    steps = all_steps(directory)
    removed = []
    for s in steps[:-int(keep)] if keep > 0 else steps:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
        for side in (_integrity_path(directory, s), _lineage_path(directory, s)):
            if os.path.exists(side):
                os.remove(side)
        removed.append(s)
        registry().counter("mho_ckpt_gc_total", "checkpoints deleted by bounded retention"
                           ).inc(dir=os.path.basename(os.path.abspath(directory)))
        obs_events.emit("gc", dir=os.path.abspath(directory), step=int(s), keep=int(keep),
                        reason=reason)
    return removed
