#!/usr/bin/env python3
"""Train the PyTorch port over a mesh of several GPUs, one process per GPU.

    python3 chip_mesh.py                        # 4 GPUs, create_mesh({"dp": 2, "fsdp": 2})
    python3 chip_mesh.py --device cpu --model test-tiny --seq 32   # rehearsal over gloo

`chip_smoke.py` runs a mesh of one rank, all one card can hold. This script
runs `--ranks` ranks (one GPU each, NCCL; or CPU processes over gloo),
rendezvousing through a FileStore in a temporary directory:

1. In this process, on GPU 0: the reference. `--model` (random weights
   from `--seed`, full remat, fused cross-entropy as the model's switch
   decides, AdamW as bench.py) takes `--steps` steps on one device over the
   global batch cut into the mesh's row blocks, each block's loss (its
   summed loss over the global token count) backpropagated into the same
   gradients: the arithmetic each rank does on its rows, with the
   gradients summed in one place. Freed before the ranks start.
2. `--ranks` worker processes (this file, `--rank r`): each builds the
   model on the meta device, `init_state` over `create_mesh(--mesh)` draws
   the weights leaf by leaf from the same seed, `build_train_step`'s
   placement takes the rank's rows, and the ranks take the same steps; then
   each saves its shards of the step and the params (rank 0 commits) and
   restores them onto the mesh.

Gates: every rank's first-step loss and grad_norm within 1e-5 relative of
the reference's (the same weights and rows; the gradients differ only in
the order their f32 sums are taken), every step's the same on every rank,
finite, the loss falling; K1 twice and K2 once per layer per step on every
rank's rows; every weight a DTensor placed by the rules; the restore bit
for bit on every rank. The later steps' distances from the reference are
reported, not gated: Adam moves a weight whose gradient is near its eps
(1e-8) by about lr * sign(g), so the sums' order shows in the next steps'
weights (4 H100s: loss 4e-6, grad_norm 1.7e-4 relative by step 3). Reported: step times against the reference's,
peak memory per rank, a profiled step's device idle share on rank 0, the
save's blocked ms. Prints JSON records; the last line is {"ok": ..., "device":
{...}}. Exits non-zero on a failed gate or when the GPUs are fewer than the
ranks; workers outliving the run's limit are killed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REL_TOL = 1e-5
RUN_LIMIT_S = 420


def _args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--mesh", default="dp=2,fsdp=2",
                        help="axis=size,... for create_mesh")
    parser.add_argument("--model", default="llama3-1b")
    parser.add_argument("--batch", type=int, default=8, help="global rows")
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def _axes(spec: str) -> dict:
    return {k: int(v) for k, v in (item.split("=") for item in spec.split(","))}


def _emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def _optimizer():
    import torch

    from ray_tpu_torch.parallel.optim import adamw

    return adamw(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)


def _device(args, rank: int):
    import torch

    if args.device == "cuda":
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    return torch.device("cpu")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reference(args, blocks: int) -> dict:
    """`--steps` steps on one device with the global batch's row blocks
    backpropagated one after the other into the same gradients."""
    import torch

    from ray_tpu_torch.models.transformer import Transformer, get_config
    from ray_tpu_torch.parallel.optim import global_norm, tree_leaves, tree_unflatten
    from ray_tpu_torch.parallel.spmd import fused_ce_enabled, train_loss

    device = _device(args, 0)
    cfg = get_config(args.model, remat=True, remat_policy="full")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Transformer(cfg, device=device, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq), generator=gen,
                           device=device)
    fused = fused_ce_enabled(model, tokens.shape)
    opt = _optimizer()
    tree = model.param_tree(trainable=True)
    state = opt.init(tree)
    params = tree_leaves(tree)
    rows = args.batch // blocks
    losses, norms, times = [], [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        loss = torch.zeros((), device=device)
        for b in range(blocks):
            block = tokens[b * rows:(b + 1) * rows]
            part = train_loss(model, {"tokens": block, "targets": block}, fused_ce=fused,
                              denominator=float(tokens.numel()))
            part.backward()
            loss += part.detach()
        grads = [p.grad for p in params]
        norms.append(float(global_norm(grads)))
        opt.update_(tree_unflatten(tree, grads), state, tree)
        for p in params:
            p.grad = None
        losses.append(float(loss))
        _sync(device)
        times.append(time.perf_counter() - t0)
    del model, opt, state, tree, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": norms, "step_s": times, "fused_ce": fused,
            "row_blocks": blocks, "steady_step_ms": statistics.median(times[1:] or times) * 1e3}


def _worker(args) -> int:
    """One rank: train, save, restore; its record to <dir>/rank_<r>.json."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import checkpoint as ckpt
    from ray_tpu_torch.models.transformer import Transformer, get_config, param_axes
    from ray_tpu_torch.ops.attention import LAUNCHES
    from ray_tpu_torch.parallel.mesh import create_mesh, logical_to_placements
    from ray_tpu_torch.parallel.optim import tree_leaves
    from ray_tpu_torch.parallel.spmd import build_train_step, init_state

    rank, world = args.rank, args.ranks
    device = _device(args, rank)
    store = dist.FileStore(os.path.join(args.dir, "store"), world)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RUN_LIMIT_S // 2))
    rec = {"rank": rank}
    try:
        mesh = create_mesh(_axes(args.mesh), device=device.type)
        cfg = get_config(args.model, remat=True, remat_policy="full")
        model = Transformer(cfg, device="meta")
        opt = _optimizer()
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state, shardings = init_state(model, cfg, opt, mesh, rng=gen)
        tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq), generator=gen,
                               device=device)
        step_fn, place = build_train_step(model, opt, mesh)
        local = place({"tokens": tokens, "targets": tokens})
        rec["rows"] = int(local["tokens"].shape[0])
        placed = 0
        for path, _ in model.named_tree_params():
            p = state.params
            for key in path:
                p = p[key]
            placed += isinstance(p, DTensor) and tuple(p.placements) == \
                logical_to_placements(param_axes(path), p.device_mesh)
        rec["weights_placed"], rec["weights"] = placed, len(list(model.named_tree_params()))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        losses, norms, times = [], [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, local)
            losses.append(float(metrics["loss"]))  # synchronizes
            times.append(time.perf_counter() - t0)
            norms.append(float(metrics["grad_norm"]))
        rec.update(losses=losses, grad_norms=norms, step_s=times, launches=dict(LAUNCHES),
                   steady_step_ms=statistics.median(times[1:] or times) * 1e3)
        if device.type == "cuda":
            rec["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
            if rank == 0:
                from chip_smoke import _device_profile

                rec["profile"] = _device_profile(lambda: step_fn(state, local), reps=2)
            else:  # the profiled steps are collective: take them too
                for _ in range(4):
                    step_fn(state, local)
        path = os.path.join(args.dir, "checkpoint")
        writer = ckpt.AsyncCheckpointWriter()
        try:
            dist.barrier()
            t0 = time.perf_counter()
            writer.save(path, {"step": np.asarray(state.step, np.int32),
                               "params": state.params})
            rec["save_blocked_ms"] = (time.perf_counter() - t0) * 1e3
            writer.wait_until_finished()
            rec["save_s"] = time.perf_counter() - t0
        finally:
            writer.shutdown()
        dist.barrier()  # rank 0 has committed
        want = {k: v for k, v in shardings.items() if k.startswith("params/")}
        t0 = time.perf_counter()
        restored = ckpt.restore(path, mesh=mesh, placements=want)
        _sync(device)
        rec["restore_s"] = time.perf_counter() - t0
        rec["restored_bitwise"] = int(restored["step"]) == state.step and all(
            torch.equal(a.to_local(), b.detach().to_local())
            for a, b in zip(tree_leaves(restored["params"]), tree_leaves(state.params)))
        rec["shard_bytes"] = sum(p.to_local().numel() * p.to_local().element_size()
                                 for p in tree_leaves(state.params))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.dir, f"rank_{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    if args.rank is not None:
        return _worker(args)
    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < args.ranks):
        print(f"chip_mesh: {args.ranks} GPUs needed", file=sys.stderr)
        return 2
    if args.device == "cuda":
        from chip_smoke import phase_card

        card = phase_card()
    else:
        card = {"device": "cpu", "count": 0}
    axes = _axes(args.mesh)
    blocks = math.prod(axes.get(a, 1) for a in ("dp", "fsdp"))
    ref = _reference(args, blocks)
    _emit({"phase": "reference", **ref})
    tmp = tempfile.mkdtemp(prefix="chip_mesh_")
    procs = []
    try:
        t0 = time.monotonic()
        for rank in range(args.ranks):
            given = sys.argv[1:] if argv is None else list(argv)
            cmd = [sys.executable, os.path.abspath(__file__), *given, "--rank", str(rank),
                   "--dir", tmp]
            procs.append(subprocess.Popen(cmd))
        codes = []
        for proc in procs:
            try:
                codes.append(proc.wait(timeout=max(0.0, t0 + RUN_LIMIT_S - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        ranks = []
        for rank in range(args.ranks):
            path = os.path.join(tmp, f"rank_{rank}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path) else None)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    def rel(a, b):
        return abs(a - b) / abs(b)

    done = [r for r in ranks if r is not None]
    cfg_layers = None
    if done:
        from ray_tpu_torch.models.transformer import get_config

        cfg_layers = get_config(args.model).n_layers
    expected = {"flash_fwd": 2 * cfg_layers * args.steps, "flash_bwd": cfg_layers * args.steps} \
        if cfg_layers else None
    rec = {"phase": "mesh", "model": args.model, "mesh": axes, "ranks": args.ranks,
           "tokens": [args.batch, args.seq], "codes": codes, "rel_tol": REL_TOL,
           "per_rank": ranks}
    ok = len(done) == args.ranks and all(c == 0 for c in codes)
    if ok:
        first = done[0]
        rec["loss_rel_by_step"] = [rel(a, b) for a, b in zip(first["losses"], ref["losses"])]
        rec["grad_norm_rel_by_step"] = [rel(a, b) for a, b in
                                        zip(first["grad_norms"], ref["grad_norms"])]
        rec["steady_step_ms_over_reference"] = first["steady_step_ms"] / ref["steady_step_ms"]
        ok = (rec["loss_rel_by_step"][0] <= REL_TOL and rec["grad_norm_rel_by_step"][0] <= REL_TOL
              and all(math.isfinite(x) for x in first["losses"] + first["grad_norms"])
              and first["losses"][-1] < first["losses"][0]
              and all(r["losses"] == done[0]["losses"] for r in done)
              and all(r["grad_norms"] == done[0]["grad_norms"] for r in done)
              and all(r["weights_placed"] == r["weights"] for r in done)
              and all(r["restored_bitwise"] for r in done)
              and all(r["rows"] == args.batch // blocks for r in done)
              and (args.device != "cuda" or all(r["launches"] == expected for r in done)))
    rec["launches_expected"] = expected
    rec["ok"] = ok
    _emit(rec)
    _emit({"ok": ok, "device": {"platform": "gpu" if args.device == "cuda" else "cpu",
                                "kind": card["device"], "count": card["count"]}})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
