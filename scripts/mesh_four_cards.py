"""The data mesh over four cards against the same mesh on one card.

On a machine with four NVIDIA cards: `sharded_apsp` at the large case's
(1, 1024) over `cuda:0..3` (peer copies ordered by events) against
`[cuda:0] * 4` and K2's closure, bit for bit; the `mean` step at data 2 x
graph 2 and data 4 over the four cards against the same mesh on one card
(parameters and episode totals within 1e-4, every replica on another card
holding the model's parameters); the Trainer at `mesh_data = 0` (every
card) on 4 paper files against `[cuda:0] * 4` and one device (rows within
1e-4, injected replay indices), and the Evaluator at `mesh_data = 4` over
the 20 paper files against one device.  Logs each path's host ms (and
the card busy ms of the steps) and writes them to
`build/mesh_four_cards.json`.  It raises unless four cards are present.

    python3 scripts/mesh_four_cards.py
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from multihop_offload_tpu_torch.agent import replay as replay_mod  # noqa: E402
from multihop_offload_tpu_torch.config import Config  # noqa: E402
from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch  # noqa: E402
from multihop_offload_tpu_torch.graphs.matio import PAPER_DATASET  # noqa: E402
from multihop_offload_tpu_torch.models.chebconv import load_model  # noqa: E402
from multihop_offload_tpu_torch.ops import minplus as mp  # noqa: E402
from multihop_offload_tpu_torch.parallel import data_parallel as dp  # noqa: E402
from multihop_offload_tpu_torch.parallel import make_mesh, ring  # noqa: E402
from multihop_offload_tpu_torch.train import driver as drv  # noqa: E402

t_start = time.perf_counter()
card = cs.device_lines()
assert torch.cuda.device_count() == 4, torch.cuda.device_count()
print([torch.cuda.can_device_access_peer(0, j) for j in range(1, 4)], flush=True)
cs.build_kernels()
out = {}
four = [torch.device("cuda", i) for i in range(4)]
one = [torch.device("cuda", 0)] * 4
dev = four[0]

# ---- the ring over four cards against one ----------------------------------
w = cs.ring_weights(dev)
n = w.shape[-1]
r4 = ring.sharded_apsp(w, four)
r1 = ring.sharded_apsp(w, one)
k2 = mp.minplus_closure_cuda(torch.where(torch.eye(n, dtype=torch.bool, device=dev), 0.0,
                                         w).contiguous(), ring.squarings(n))
torch.cuda.synchronize()
assert torch.equal(r4, r1) and torch.equal(r4, k2), "ring over 4 cards differs"
out["ring_ms_4_cards"] = cs.wall_ms(lambda: ring.sharded_apsp(w, four), 5)
out["ring_ms_1_card"] = cs.wall_ms(lambda: ring.sharded_apsp(w, one), 5)
out["k2_ms"] = cs.wall_ms(lambda: mp.minplus_closure_cuda(
    torch.where(torch.eye(n, dtype=torch.bool, device=dev), 0.0, w).contiguous(),
    ring.squarings(n)), 10)
print(f"ring (1, {n}) over cuda:0..3 bit-identical to [cuda:0] * 4 and K2; "
      f"{out['ring_ms_4_cards']:.2f} ms vs {out['ring_ms_1_card']:.2f} ms on one card, "
      f"K2 {out['k2_ms']:.3f} ms", flush=True)

# ---- the mean and replay steps ---------------------------------------------------
inst, jobs, _ = request_batch(load_cases("paper")[:16], 4, seed=0,
                              cfg=Config(arrival_scale=0.15), device=dev)
opt = replay_mod.make_optimizer(Config(learning_rate=1e-3))
res = {}
for tag, mesh in (("2x2 cards", make_mesh(data=2, graph=2, devices=four)),
                  ("2x2 one", make_mesh(data=2, graph=2, devices=one)),
                  ("4x1 cards", make_mesh(data=4, devices=four)),
                  ("4x1 one", make_mesh(data=4, devices=one))):
    model = load_model(cs.MODEL_K1, device=dev)
    step = dp.make_dp_train_step(model, opt, mesh, mode="mean")
    state = opt.init({k: p.detach() for k, p in model.named_parameters()})
    params, state, metrics = step(model, state, inst, jobs, None, 0.0)
    for rep in step.replicas._copies.values():
        for p, q in zip(rep.parameters(), model.parameters()):
            assert p.device != q.device and torch.equal(p.cpu(), q.cpu()), "replica drift"
    call = lambda: step(model, state, inst, jobs, None, 0.0)
    wall = cs.wall_ms(call, 3)
    res[tag] = {"params": params, "job_total": metrics["job_total"], "ms": wall,
                "busy_ms": cs.busy_share(call, wall)["busy_ms"],
                "copies": len(step.replicas._copies)}
for a, b in (("2x2 cards", "2x2 one"), ("4x1 cards", "4x1 one")):
    cs.compare_params(f"mean step {a} vs {b}", res[a]["params"], res[b]["params"], 1e-4)
    cs.compare_totals(f"mean step {a} vs {b}", res[a]["job_total"], res[b]["job_total"],
                      jobs.mask)
out["mean"] = {k: {kk: v[kk] for kk in ("ms", "busy_ms", "copies")} for k, v in res.items()}
print(f"mean step (B=64) ms / busy ms: {out['mean']}", flush=True)

# ---- the drivers over every local card --------------------------------------------
tmp = tempfile.mkdtemp(prefix="mho_p4_")
orig = replay_mod.sample_indices
replay_mod.sample_indices = cs.injected_indices
try:
    tcfg = dict(datapath=PAPER_DATASET, layout="sparse", cheb_k=2, epochs=1, files_limit=4,
                batch=20, memory_size=100, explore=0.0, best_window=0, num_instances=10,
                arrival_scale=0.15, T=1000)
    rows, ms = {}, {}
    for tag, kw in (("cards", {"mesh_data": 0}), ("one", {"mesh_data": 4, "devices": one}),
                    ("single", {"mesh_data": 1})):
        devices = kw.pop("devices", None)
        tr = drv.Trainer(Config(**tcfg, **kw, out=os.path.join(tmp, tag),
                                model_root=os.path.join(tmp, "m" + tag)),
                         devices=devices)
        t0 = time.perf_counter()
        rows[tag] = cs.read_csv_rows(tr.run(verbose=False))
        ms[tag] = (time.perf_counter() - t0) * 1e3 / 4
        print(f"Trainer {tag}: n_dp {tr.n_dp}, mesh {tr.mesh}, {ms[tag]:.1f} ms a file "
              f"(4 files, first calls included)", flush=True)
    cs.compare_train_rows("Trainer over cuda:0..3 vs one device", rows["cards"], rows["single"],
                          rtol=1e-4)
    cs.compare_train_rows("Trainer over cuda:0..3 vs [cuda:0] * 4", rows["cards"], rows["one"],
                          rtol=1e-4)
    out["trainer_ms_per_file"] = ms
    erows, ems = {}, {}
    for tag, kw in (("cards", {"mesh_data": 4, "file_batch": 1}),
                    ("single", {"mesh_data": 1, "file_batch": 1})):
        ev = drv.Evaluator(Config(datapath=PAPER_DATASET, num_instances=10, arrival_scale=0.15,
                                  out=os.path.join(tmp, "e" + tag),
                                  model_root=os.path.join(tmp, "em"), **kw))
        ev.run(files_limit=4, verbose=False)  # warm
        t0 = time.perf_counter()
        erows[tag] = cs.read_csv_rows(ev.run(verbose=False))
        ems[tag] = (time.perf_counter() - t0) * 1e3
    cs.compare_eval_rows("Evaluator over cuda:0..3 vs one device (20 files)", erows["cards"],
                         erows["single"])
    out["evaluator_ms_20_files"] = ems
    print(f"Evaluator 20 files: {ems}", flush=True)
finally:
    replay_mod.sample_indices = orig
out["total_s"] = time.perf_counter() - t_start
os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
with open(os.path.join(ROOT, "build", "mesh_four_cards.json"), "w") as f:
    json.dump({"card": card, **out}, f, indent=1)
print(json.dumps(out), flush=True)
