"""Continual-learning flywheel: serve -> train -> serve, closed.

Port of `multihop_offload_tpu/loop/`.  The service logs per-request
outcomes (`serve.service` capture -> `obs.events` "outcome" rows);
`experience` turns that stream back into replay batches; `refit`
fine-tunes the policy on them; `validate` replays a held-out slice of the
logged workload through the packet simulator for champion vs candidate;
`canary` probes a candidate's decisions before any swap; `promote` drives
the state machine capture -> refit -> validate -> promote-via-hot-reload ->
monitor, with automatic rollback.  Entry point: `cli.loop`.
`loop/drift.py` (`shift_campaign`) waits for `scenarios/` (ROADMAP.md
Queue 1 item 9).

Deliberately import-light: submodules import serve/sim/train/agent pieces
directly, and serve.service imports `loop.experience` -- keeping this
package namespace empty avoids the cycle.
"""
