#!/usr/bin/env python3
"""Train and serve the PyTorch port over several GPUs, one process per GPU.

    python3 chip_mesh.py                        # 4 GPUs, create_mesh({"dp": 2, "fsdp": 2})
    python3 chip_mesh.py --device cpu --model test-tiny --seq 32   # rehearsal over gloo
    python3 chip_mesh.py --mode serve           # 4 GPUs: llama3-8b at tp=1, 2 and 4
    python3 chip_mesh.py --mode serve --device cpu --model test-tiny --seq 64   # its rehearsal

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
save's blocked ms.

`--mode serve` runs tensor-parallel serving instead. In this process, on
GPU 0: chip_smoke's model phase gives the teacher-forced margin, then the
reference `LLMServer` at tp=1 (`--model`, random bf16 weights from `--seed`,
4 slots, max_seq `--seq`) answers four prompts together (20, 100, 255 and
300 tokens; 5, 10, 20 and 30 on the CPU), 32 tokens each, and its weights
stay for the checks. Then, for tp=2 and tp=4, that many worker processes
(`--rank r`) each build `LLMServer(LLMConfig(..., tp=N))` over NCCL (each
draws only its shards, leaf by leaf), rank 0 answers the same prompts, and
every rank shuts down. Gates per degree: every token the teacher-forced
argmax of the tp=1 weights or within the margin; K1 once per layer per rank
for each prompt's offset-0 chunk; each rank's weights and KV the bytes of
its shards under `param_spec` (about 1/tp of tp=1's); each rank's peak while
the server is built at most those bytes plus one whole leaf's draw; each
rank's `memory_allocated` back at its level before the server after
`shutdown`. The tp=2 ranks then take a follower fault: a 2-layer cut of the
model at tp=2, whose rank 1 raises in its decode step before its
collectives, so rank 0 waits in one (over NCCL until its watcher aborts
it); gate: rank 0's request ends with rank 1's error within
FAULT_DEADLINE_S, and both ranks' threads end. Reported: TTFT, TPOT, a
decode step's and a prefill chunk's wall and device ms on rank 0
(torch.profiler) and its idle share, the load peak, peak memory, the
fault's seconds.

The tier run, at tp=1 here and at each degree on its workers (before the
fault): chip_smoke's `tiers` sequence through an `LLMServer` built from the
tier flags (16-row blocks, 2 MiB each at llama3-8b's width: a host pool of
80, a device tier of 128, a spill directory of 512 in the run's temporary
directory): a 1,072-token prompt cold, from the host pool (promoting it to
every rank's card), from the card, a second cold prompt whose insert
evicts and spills the first's tail, then the first from disk. Rank 0 holds
the cache; after each step it reads every rank's hot-tier slices
(`_hot_report`). Gates: one hit from each tier; the hits' tokens equal,
and every reply's tokens within the teacher-forced margin of the tp=1
weights; K1 once per layer per rank on each cold request and never on a
hit; after each step every rank holds exactly rank 0's tier ids, in rank
0's tier bytes / tp (whole where the kv heads replicate); on the device hit
no rank scatters host rows or attaches from the host; followers build no
cache and no spill worker; the spill worker stopped and (TP) every rank's
`memory_allocated` back after `shutdown`. Reported: TTFT per step, attach
ms per tier, the same rows attached from the host pool (`_attach_kv`, into
a free slot), each insert's read-back ms, promotion ms to the card and
from disk, each rank's slice bytes, the spill.

Prints JSON records; the last line is {"ok": ..., "device": {...}}. Exits
non-zero on a failed gate or when the GPUs are fewer than the ranks; workers
outliving the run's limit are killed.
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
    parser.add_argument("--mode", default="train", choices=("train", "serve"))
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--mesh", default="dp=2,fsdp=2",
                        help="axis=size,... for create_mesh")
    parser.add_argument("--model", default=None,
                        help="llama3-1b (train) or llama3-8b (serve) by default")
    parser.add_argument("--batch", type=int, default=8, help="global rows")
    parser.add_argument("--seq", type=int, default=2048, help="train: tokens a row; serve: max_seq")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.model is None:
        args.model = "llama3-8b" if args.mode == "serve" else "llama3-1b"
    return args


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


# -- serving over a tensor-parallel group --------------------------------------

SERVE_SLOTS = 4
SERVE_TOKENS = 32  # per reply
TP_DEGREES = (2, 4)
# The f32 (CPU) rehearsal's margin: plain and flash routes agree there to
# rounding, so chip_smoke's margin (twice their bf16 distance from f32) is 0.
F32_MARGIN = 1e-4
# The prompts' lengths: the serve phase's on the card, short ones in the
# CPU rehearsal.
SERVE_LENGTHS = {"cuda": (20, 100, 255, 300), "cpu": (5, 10, 20, 30)}
# Seconds within which a follower's fault must fail rank 0's request (the
# groups' own timeout is GROUP_TIMEOUT_S, 300 s).
FAULT_DEADLINE_S = 60.0
# Bytes a one-leaf draw may hold beyond the shards, per element of the
# largest leaf: the f32 truncated-normal draw, its f32 scaled copy and the
# cast to the model's dtype; plus 64 MiB of small allocations.
DRAW_BYTES_PER_ELEMENT = 10
LOAD_SLACK_BYTES = 64 << 20
# The tier run's prompts (prefix + suffix tokens), reply length and budgets
# in 16-row blocks: chip_smoke's `tiers` phase on the card; in the CPU
# rehearsal a host pool of 3 blocks, so the second prompt still evicts the
# first's tail.
TIER_SIZES = {"cuda": {"prefix": 1024, "suffix": 48, "max_tokens": 16, "host": 80,
                       "device": 128, "spill": 512},
              "cpu": {"prefix": 40, "suffix": 3, "max_tokens": 6, "host": 3, "device": 4,
                      "spill": 16}}
TIER_STEPS = ("cold", "host", "device", "evict", "disk")
SPILL_WAIT_S = 120.0


def _serve_config(args, tp: int, device):
    from ray_tpu_torch.llm import LLMConfig

    return LLMConfig(model_id=args.model, num_slots=SERVE_SLOTS, max_seq=args.seq,
                     seed=args.seed, tp=tp, device=str(device))


def _prompts(args, vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(args.seed)
    return [rng.integers(0, vocab, n).tolist() for n in SERVE_LENGTHS[args.device]]


def _serve(server, prompts, max_tokens: int) -> list:
    import asyncio

    async def run():
        return await asyncio.gather(*(server.generate(p, max_tokens=max_tokens)
                                      for p in prompts))

    return asyncio.run(run())


def _replies(results) -> dict:
    return {"token_ids": [r["token_ids"] for r in results],
            "ttft_s": [r["ttft_s"] for r in results],
            "tpot_s": [(r["latency_s"] - r["ttft_s"]) / max(1, len(r["token_ids"]) - 1)
                       for r in results],
            "latency_s": [r["latency_s"] for r in results]}


def _profile_engine(eng, prefill_len: int, device) -> dict:
    """A decode step over every slot (`_decode_logits`: the forward, the
    logits gathered to rank 0 and pulled to the host; the write gate off)
    and an offset-0 prefill chunk, each through the engine's op channel, so
    a TP engine's followers run them too. torch.profiler on the card; the
    host clock alone on the CPU."""
    import numpy as np

    B, bucket = eng.B, eng._bucket(prefill_len)
    last, lens = np.zeros(B, np.int64), np.full(B, 400, np.int64)
    gate, tokens = np.zeros(B, bool), np.ones((1, bucket), np.int64)

    def decode():
        eng._op("_decode_logits", last, lens, gate)

    def prefill():
        eng._op("_prefill_at", tokens, 0, 0, bucket, 0)

    import torch

    with torch.inference_mode():
        if device.type == "cuda":
            from chip_smoke import _device_profile

            return {"decode_step": dict(_device_profile(decode), host=_host_ops(decode)),
                    "prefill_chunk": dict(_device_profile(prefill), bucket=bucket,
                                          host=_host_ops(prefill))}
        out = {}
        for name, fn in (("decode_step", decode), ("prefill_chunk", prefill)):
            fn()
            t0 = time.perf_counter()
            fn()
            out[name] = {"wall_ms": (time.perf_counter() - t0) * 1e3}
        return out


def _host_ops(fn) -> dict:
    """Where rank 0's host time of one call goes: torch.profiler's self CPU
    time by op (the profiler's own cost included, so read it as shares),
    the collectives' part (c10d: NCCL's all-reduces and gathers, gloo's
    announcement) and the ten largest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count) for a in prof.key_averages()),
                  key=lambda r: -r[1])
    return {"self_cpu_ms": sum(ms for _, ms, _ in rows),
            "collectives_ms": sum(ms for key, ms, _ in rows
                                  if any(w in key for w in ("c10d", "nccl", "gloo"))),
            "collective_calls": sum(n for key, _, n in rows if key.startswith("c10d::")),
            "top": [[key[:60], ms, n] for key, ms, n in rows[:10]]}


def _tree_bytes(tree) -> int:
    from ray_tpu_torch.llm.tp import per_device_bytes

    return per_device_bytes(tree)


def _expected_bytes(cfg, tp: int, max_seq: int) -> int:
    """The bytes of one rank's shards under param_spec (matrices in the
    model's dtype, norm scales f32) plus its KV pool."""
    from ray_tpu_torch.llm.tp import kv_cache_sharding, param_spec
    from ray_tpu_torch.models.transformer import param_shapes

    total = 0
    for path, shape, init in param_shapes(cfg):
        n = math.prod(shape)
        if param_spec(path, shape, tp) is not None:
            n //= tp
        total += n * (4 if init is None else cfg.dtype.itemsize)
    heads = cfg.n_kv_heads // tp if kv_cache_sharding(tp, cfg.n_kv_heads) else cfg.n_kv_heads
    return total + 2 * cfg.n_layers * SERVE_SLOTS * max_seq * heads * cfg.head_dim \
        * cfg.dtype.itemsize


def _draw_bytes(cfg) -> int:
    """What drawing the largest leaf whole may hold beyond the shards."""
    from ray_tpu_torch.models.transformer import param_shapes

    return DRAW_BYTES_PER_ELEMENT * max(math.prod(shape) for _, shape, _ in param_shapes(cfg))


def _allocated(device):
    """Bytes the caching allocator holds for tensors on `device`, less the
    cuBLAS workspaces it keeps for each thread's handle (dropped first: the
    stepper's and the follower's threads make their own), None on the CPU."""
    import torch

    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated(device)


def _tier_flags(args, spill_dir: str) -> dict:
    """The tier run's `llm_kv_*` flags: TIER_SIZES' budgets in blocks of
    16 rows at `--model`'s width."""
    from ray_tpu_torch.models.transformer import get_config

    cfg, size = get_config(args.model), TIER_SIZES[args.device]
    block = cfg.n_layers * 2 * 16 * cfg.n_kv_heads * cfg.head_dim * cfg.dtype.itemsize
    return {"llm_kv_block_size": 16, "llm_prefix_cache_bytes": size["host"] * block,
            "llm_kv_device_bytes": size["device"] * block, "llm_kv_spill_dir": spill_dir,
            "llm_kv_spill_bytes": size["spill"] * block}


def _tier_prompts(args, vocab: int) -> list:
    """The tier run's prompts, in TIER_STEPS' order (a, a, a, b, a)."""
    import numpy as np

    size = TIER_SIZES[args.device]
    rng = np.random.default_rng(args.seed + 6)
    a, b = (rng.integers(0, vocab, size["prefix"] + size["suffix"]).tolist() for _ in range(2))
    return [a, a, a, b, a]


class _TierEvents:
    """This process's host-row scatters, attaches and `_hot_report`s, from
    class-level wrappers; a report's entry carries the K1 count so far (the
    launches on the card, the wrapper's runs on the CPU), so the reports cut
    the log into the run's steps."""

    def __init__(self, device):
        from ray_tpu_torch.llm._engine import DecodeEngine
        from ray_tpu_torch.llm.tp import TPShard
        from ray_tpu_torch.ops.attention import CALLS, LAUNCHES

        count = LAUNCHES if device.type == "cuda" else CALLS
        self.events = [["start", count["flash_fwd"]]]
        self._saved = []
        for cls, name in ((TPShard, "scatter_host"), (DecodeEngine, "_attach_kv"),
                          (DecodeEngine, "_attach_hot"), (DecodeEngine, "_hot_report")):
            fn = getattr(cls, name)
            self._saved.append((cls, name, fn))
            setattr(cls, name, self._logged(name, fn, count))

    def _logged(self, name, fn, count):
        def call(*args, **kwargs):
            self.events.append([name, count["flash_fwd"]])
            return fn(*args, **kwargs)
        return call

    def close(self) -> list:
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        return self.events


def _event_steps(events: list) -> list:
    """A rank's tier events cut at its `_hot_report`s: per step, the names
    logged and the K1 count."""
    out, names, k1 = [], [], events[0][1]
    for name, count in events[1:]:
        if name == "_hot_report":
            out.append({"names": names, "k1": count - k1})
            names, k1 = [], count
        else:
            names.append(name)
    return out


def _tier_run(args, server, device) -> dict:
    """Rank 0's side of the tier run: TIER_STEPS through `server`, each
    step's reply, K1 count and last attach; on a TP engine every rank's
    slices read after each step (`_hot_report`) beside rank 0's tier. The
    attach (`_attach_lease`), the promotions to the card and from disk are
    timed synchronized on rank 0."""
    from ray_tpu_torch.ops.attention import CALLS, LAUNCHES

    eng = server._engine
    cache = eng._prefix_cache
    count = LAUNCHES if device.type == "cuda" else CALLS
    timings = {"attach": [], "promote_device": [], "promote_disk": [], "insert": []}
    attach_lease, to_device = eng._attach_lease, cache._promote_to_device
    from_disk, insert = cache._promote_from_disk, eng._insert_prompt_kv

    def timed(key, fn, note):
        def call(*args):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(device)
            entry = note(args, out)
            if entry is not None:
                timings[key].append(dict(entry, ms=(time.perf_counter() - t0) * 1e3))
            return out
        return call

    eng._attach_lease = timed("attach", attach_lease, lambda a, tier: {"tier": tier})
    cache._promote_to_device = timed("promote_device", to_device,
                                     lambda a, _: {"blocks": len(a[0])})
    cache._promote_from_disk = timed("promote_disk", from_disk,
                                     lambda a, added: {"blocks": added} if added else None)
    eng._insert_prompt_kv = timed("insert", insert, lambda a, _: {"cached_tokens": a[3]})
    steps, spill = [], {}
    for step, prompt in zip(TIER_STEPS, _tier_prompts(args, server._cfg.vocab_size)):
        if step == "disk":
            # Every block the second prompt evicted is on disk first.
            want, t0 = cache.stats()["evicted_blocks"], time.perf_counter()
            while cache.stats()["tiers"]["spills"] < want and \
                    time.perf_counter() - t0 < SPILL_WAIT_S:
                time.sleep(0.005)
            tiers = cache.stats()["tiers"]
            spill = {"evicted_blocks": want, "spills": tiers["spills"],
                     "spill_mib": tiers["spill_bytes"] / 2**20,
                     "wait_s": time.perf_counter() - t0}
        k1 = count["flash_fwd"]
        reply = _serve(server, [prompt], TIER_SIZES[args.device]["max_tokens"])[0]
        rec = {"step": step, "token_ids": reply["token_ids"], "ttft_s": reply["ttft_s"],
               "k1": count["flash_fwd"] - k1, "last_attach": eng.last_attach}
        if eng._tp is not None:
            report = eng._op("_hot_report")
            with cache._lock:
                ids = sorted(cache._device._blocks)
            rec.update(tier_ids=len(ids), tier_bytes=cache.stats()["tiers"]["device_bytes"],
                       rank_ids_equal=[sorted(mine) == ids for mine in report],
                       rank_bytes=[sum(nb for _, nb, _ in mine.values()) for mine in report])
        steps.append(rec)
    # The same rows from the host pool, for comparison: the first prompt's
    # whole chain written into a free slot through `_attach_kv` (under TP
    # rank 0 scatters each rank its kv-head slice of the host rows).
    import torch

    lease = eng.lease_prefix(_tier_prompts(args, server._cfg.vocab_size)[0])
    try:
        with torch.inference_mode():
            _sync(device)
            t0 = time.perf_counter()
            eng._op("_attach_kv", 0, lease.kv())
            _sync(device)
            host_attach = {"rows": lease.matched_tokens, "ms": (time.perf_counter() - t0) * 1e3}
    finally:
        lease.release()
    stats = cache.stats()
    return {"steps": steps, "timings": timings, "spill": spill, "tiers": stats["tiers"],
            "host_attach": host_attach, "leases_active": stats["leases_active"],
            "spill_worker": cache._spill_thread}


def _tier_server(args, tp: int, device, spill_dir: str):
    from chip_smoke import _engine_flags

    from ray_tpu_torch.llm import LLMServer

    with _engine_flags(**_tier_flags(args, spill_dir)):
        return LLMServer(_serve_config(args, tp, device))


def _spill_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate() if t.name.startswith("kv-spill"))


def _serve_tiers(args, rank: int, tp: int, device, sync) -> None:
    """One rank's tier run at tp: every rank builds the server from the
    same flags (a follower builds no cache), rank 0 runs the steps, every
    rank shuts down. Its record to <dir>/tiers_<tp>_<r>.json."""
    import asyncio
    import gc

    import torch.distributed as dist

    rec = {"rank": rank, "tp": tp, "memory_before": _allocated(device)}
    server = _tier_server(args, tp, device, os.path.join(args.dir, f"kv_spill_tp{tp}"))
    eng = server._engine
    rec["cache"] = type(eng._prefix_cache).__name__
    events = _TierEvents(device)
    dist.barrier(group=sync)
    try:
        if rank == 0:
            run = _tier_run(args, server, device)
            worker = run.pop("spill_worker")
            rec.update(run)
        rec["spill_threads"] = _spill_threads()
        dist.barrier(group=sync)
        asyncio.run(server.shutdown())
    finally:
        rec["events"] = events.close()
    if rank == 0:
        rec["spill_worker_stopped"] = worker is None or not worker.is_alive()
        rec["tier_copies_after"] = len(eng._prefix_cache._device)
    rec["slices_after"] = len(eng._hot_slices)
    del server, eng
    gc.collect()
    rec["memory_after"] = _allocated(device)
    dist.barrier(group=sync)
    with open(os.path.join(args.dir, f"tiers_{tp}_{rank}.json"), "w") as f:
        json.dump(rec, f)


def _tier_gates(args, ref_eng, margin: float, cfg, ranks: list) -> dict:
    """The tier run's gates over each rank's record (rank 0's first)."""
    from chip_smoke import _teacher_forced

    lead, tp = ranks[0], len(ranks)
    by = {s["step"]: s for s in lead["steps"]}
    answers = [s["token_ids"] for s in lead["steps"]]
    exact, total, gap = _teacher_forced(ref_eng, _tier_prompts(args, cfg.vocab_size), answers)
    hits = [by[t]["token_ids"] for t in ("host", "device", "disk")]
    cold_k1 = cfg.n_layers
    want_k1 = {"cold": cold_k1, "host": 0, "device": 0, "evict": cold_k1, "disk": 0}
    out = {"teacher_forced": [exact, total, gap],
           "hits_equal_cold": [h == by["cold"]["token_ids"] for h in hits]}
    tiers = lead["tiers"]
    gates = {
        "one_hit_per_tier": [by[t]["last_attach"]["tier"] for t in ("host", "device", "disk")]
        == ["host", "device", "disk"] and (tiers["hits_host"], tiers["hits_device"],
                                           tiers["hits_disk"]) == (1, 1, 1),
        "tokens": hits[0] == hits[1] == hits[2] and gap <= margin
        and all(len(a) == TIER_SIZES[args.device]["max_tokens"] for a in answers),
        "spill": tiers["spill_drops"] == 0 and lead["spill"].get("spills", 0)
        >= lead["spill"].get("evicted_blocks", 1) > 0 and lead["spill_worker_stopped"]
        and lead["leases_active"] == 0,
    }
    if tp == 1:
        gates["k1"] = {s["step"]: s["k1"] for s in lead["steps"]} == want_k1
        return dict(out, gates=gates)
    from ray_tpu_torch.llm.tp import kv_prefix_sharding

    share = tp if kv_prefix_sharding(tp, cfg.n_kv_heads) is not None else 1
    per_rank = [dict(zip(TIER_STEPS, _event_steps(r["events"]))) for r in ranks]
    out["rank_k1"] = [{s: v["k1"] for s, v in steps.items()} for steps in per_rank]
    gates.update({
        "k1_per_layer_per_rank": all(k1 == want_k1 for k1 in out["rank_k1"]),
        "ranks_hold_rank0_ids": all(all(s["rank_ids_equal"]) for s in lead["steps"]),
        "slice_bytes": by["device"]["tier_bytes"] > 0 and all(
            b == s["tier_bytes"] // share for s in lead["steps"] for b in s["rank_bytes"]),
        "no_host_rows_on_device_hit": all(steps["device"]["names"] == ["_attach_hot"]
                                          for steps in per_rank),
        "followers_no_cache": all(r["cache"] == "NoneType" and r["spill_threads"] == []
                                  for r in ranks[1:]),
        "freed": lead["tier_copies_after"] == 0 and all(r["slices_after"] == 0 for r in ranks),
        "memory_returned": args.device != "cuda" or all(
            r["memory_after"] == r["memory_before"] for r in ranks),
    })
    return dict(out, gates=gates)


def _tier_report(lead: dict) -> dict:
    """The tier run's times on rank 0: TTFT per step, attach ms per tier,
    promotion ms."""
    t = lead["timings"]
    device = next(s for s in lead["steps"] if s["step"] == "device")
    return {"ttft_s": {s["step"]: s["ttft_s"] for s in lead["steps"]},
            "attach_ms": {a["tier"]: a["ms"] for a in t["attach"]},
            "host_attach": lead["host_attach"], "insert_ms": [i["ms"] for i in t["insert"]],
            "promote_device": t["promote_device"], "promote_disk": t["promote_disk"],
            "rank_slice_bytes": device.get("rank_bytes"), "spill": lead["spill"],
            "tiers": lead["tiers"]}


def _serve_worker(args) -> int:
    """One rank of a tp=--ranks server: its record to <dir>/serve_<tp>_<r>.json."""
    import datetime
    import gc

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.ops.attention import CALLS, LAUNCHES

    rank, tp = args.rank, args.ranks
    device = _device(args, rank)
    store = dist.FileStore(os.path.join(args.dir, f"store_tp{tp}"), tp)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store,
                            rank=rank, world_size=tp,
                            timeout=datetime.timedelta(seconds=RUN_LIMIT_S // 2))
    rec = {"rank": rank, "tp": tp}
    try:
        # Host barriers of this script, beside the engine's own groups.
        sync = dist.new_group(backend="gloo")
        rec["memory_before"] = _allocated(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        server = LLMServer(_serve_config(args, tp, device))
        _sync(device)
        rec["load_s"] = time.perf_counter() - t0
        eng, cfg = server._engine, server._cfg
        if device.type == "cuda":
            rec["load_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        rec["weights_bytes"] = _tree_bytes(eng.params)
        rec["kv_bytes"] = _tree_bytes(eng._caches)
        rec["expected_bytes"] = _expected_bytes(cfg, tp, args.seq)
        rec["draw_bytes"] = _draw_bytes(cfg)
        prompts = _prompts(args, cfg.vocab_size)
        if rank == 0:
            _serve(server, [prompts[0][:8]], 2)  # warm-up: allocator, cuBLAS, NCCL
        dist.barrier(group=sync)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        CALLS.update(flash_fwd=0, flash_bwd=0)
        dist.barrier(group=sync)
        if rank == 0:
            t0 = time.perf_counter()
            results = _serve(server, prompts, SERVE_TOKENS)
            rec["wall_s"] = time.perf_counter() - t0
            rec.update(_replies(results))
            rec["timing"] = [r["timing"] for r in results]
        dist.barrier(group=sync)
        rec["launches"], rec["calls"] = dict(LAUNCHES), dict(CALLS)
        if device.type == "cuda":
            rec["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        if rank == 0:
            rec["profile"] = _profile_engine(eng, 128, device)
        dist.barrier(group=sync)
        import asyncio

        asyncio.run(server.shutdown())
        asyncio.run(server.shutdown())
        rec["freed"] = eng.params is None and eng._caches == [] and eng._kv_pool.freed
        del server, eng
        gc.collect()
        rec["memory_after"] = _allocated(device)
        dist.barrier(group=sync)
        with open(os.path.join(args.dir, f"serve_{tp}_{rank}.json"), "w") as f:
            json.dump(rec, f)
        _serve_tiers(args, rank, tp, device, sync)
        if tp == 2:
            _follower_fault(args, rank, device, sync)
    finally:
        dist.destroy_process_group()
    return 0


def _follower_fault(args, rank: int, device, sync) -> None:
    """A 2-layer cut of the model at tp=2 whose rank 1 raises in its decode
    step before any of its collectives, so rank 0 waits in one: over NCCL
    until its watcher aborts it. Each rank's record to
    <dir>/fault_<r>.json; a rank still waiting at FAULT_DEADLINE_S writes
    its record and exits at once instead of hanging its teardown."""
    import dataclasses
    import threading

    import torch.distributed as dist

    from ray_tpu_torch.llm import LLMConfig, load_model
    from ray_tpu_torch.llm._engine import DecodeEngine, SamplingParams
    from ray_tpu_torch.models.transformer import get_config

    small = dataclasses.replace(get_config(args.model), n_layers=2)
    cfg, params = load_model(LLMConfig(model_id=args.model, model_config=small, seed=args.seed,
                                       tp=2, device=str(device)))
    eng = DecodeEngine(cfg, params, num_slots=2, max_seq=256, tp=2, device=str(device))
    del params
    if rank == 1:
        def boom(*_):
            raise ValueError("injected follower fault")

        eng._decode_logits = eng._decode_multi = boom
    dist.barrier(group=sync)
    rec = {"rank": rank}
    path = os.path.join(args.dir, f"fault_{rank}.json")
    if rank == 0:
        got, done = [], threading.Event()

        def cb(tok, fin):
            got.append(tok)
            if fin:
                done.set()

        t0 = time.perf_counter()
        eng.submit(list(range(1, 21)), SamplingParams(max_tokens=8), cb)
        rec.update(ended=done.wait(FAULT_DEADLINE_S), seconds=time.perf_counter() - t0,
                   tokens=got, error=repr(eng.error))
        if not rec["ended"]:
            with open(path, "w") as f:
                json.dump(rec, f)
            os._exit(3)
    else:
        eng._thread.join(FAULT_DEADLINE_S)
        if eng._thread.is_alive():
            rec["ended"] = False
            with open(path, "w") as f:
                json.dump(rec, f)
            os._exit(3)
    eng.shutdown()
    eng.shutdown()
    rec.update(thread_alive=eng._thread.is_alive(), watcher_alive=eng._tp._watcher.is_alive(),
               freed=eng._kv_pool.freed)
    with open(path, "w") as f:
        json.dump(rec, f)


def _launch(args, ranks: int, tmp: str) -> tuple:
    """Start `ranks` workers (this file, --rank r) and wait for them within
    the run's limit: (exit codes, their records)."""
    given = sys.argv[1:] if args.argv is None else list(args.argv)
    t0 = time.monotonic()
    procs = []
    try:
        for rank in range(ranks):
            cmd = [sys.executable, os.path.abspath(__file__), *given, "--ranks", str(ranks),
                   "--rank", str(rank), "--dir", tmp]
            procs.append(subprocess.Popen(cmd))
        codes = []
        for proc in procs:
            try:
                codes.append(proc.wait(timeout=max(0.0, t0 + RUN_LIMIT_S - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return codes


def _serve_main(args, card) -> int:
    """The tp=1 reference here, then each degree's workers; the gates."""
    import gc

    import torch

    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.ops.attention import CALLS, LAUNCHES

    device = _device(args, 0)
    if device.type == "cuda":
        from chip_smoke import phase_model

        margin = phase_model(args.model, seed=args.seed)["tolerance"]
    else:
        margin = F32_MARGIN
    from chip_smoke import _teacher_forced

    mem0 = torch.cuda.memory_allocated(device) if device.type == "cuda" else None
    server = LLMServer(_serve_config(args, 1, device))
    eng, cfg = server._engine, server._cfg
    prompts = _prompts(args, cfg.vocab_size)
    _serve(server, [prompts[0][:8]], 2)
    LAUNCHES.update(flash_fwd=0, flash_bwd=0)
    CALLS.update(flash_fwd=0, flash_bwd=0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    results = _serve(server, prompts, SERVE_TOKENS)
    ref = {"phase": "serve_tp1", "model": args.model, "wall_s": time.perf_counter() - t0,
           **_replies(results), "launches": dict(LAUNCHES), "calls": dict(CALLS),
           "weights_bytes": _tree_bytes(eng.params), "kv_bytes": _tree_bytes(eng._caches),
           "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                              if device.type == "cuda" else None),
           "memory_before": mem0}
    ref["profile"] = _profile_engine(eng, 128, device)
    import asyncio

    asyncio.run(server.shutdown())
    ref["teacher_forced"] = _teacher_forced(eng, prompts, ref["token_ids"])
    _emit(ref)
    del server
    gc.collect()
    total = ref["weights_bytes"] + ref["kv_bytes"]
    expected_k1 = cfg.n_layers * len(prompts)
    ok = ref["teacher_forced"][2] <= margin
    ok = _serve_tiers_tp1(args, device, eng, margin, cfg) and ok
    records = []
    for tp in TP_DEGREES:
        tmp = tempfile.mkdtemp(prefix="chip_mesh_serve_")
        try:
            codes = _launch(args, tp, tmp)
            ranks, faults, tier_ranks = [], [], []
            for rank in range(tp):
                for name, out in ((f"serve_{tp}_{rank}.json", ranks),
                                  (f"fault_{rank}.json", faults),
                                  (f"tiers_{tp}_{rank}.json", tier_ranks)):
                    path = os.path.join(tmp, name)
                    out.append(json.load(open(path)) if os.path.exists(path) else None)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        tier_rec = {"phase": f"tiers_tp{tp}", "model": args.model, "tp": tp, "codes": codes}
        if all(r is not None for r in tier_ranks):
            tier_rec.update(_tier_gates(args, eng, margin, cfg, tier_ranks),
                            **_tier_report(tier_ranks[0]))
        tier_rec["ok"] = "gates" in tier_rec and all(tier_rec["gates"].values())
        ok = ok and tier_rec["ok"]
        _emit(tier_rec)
        rec = {"phase": f"serve_tp{tp}", "model": args.model, "tp": tp, "codes": codes,
               "margin": margin, "per_rank": ranks}
        if tp == 2:
            rec["follower_fault"] = faults
        good = all(c == 0 for c in codes) and all(r is not None for r in ranks)
        if good:
            lead = ranks[0]
            rec["teacher_forced"] = _teacher_forced(eng, prompts, lead["token_ids"])
            rec["tokens_equal_tp1"] = lead["token_ids"] == ref["token_ids"]
            rec["bytes_over_tp1"] = [(r["weights_bytes"] + r["kv_bytes"]) / total for r in ranks]
            if device.type == "cuda":
                rec["load_peak_over_tp1"] = [(r["load_peak_bytes"] - r["memory_before"]) / total
                                             for r in ranks]
            count = "launches" if device.type == "cuda" else "calls"
            rec["gates"] = {
                "tokens": rec["teacher_forced"][2] <= margin
                and all(len(t) == SERVE_TOKENS for t in lead["token_ids"]),
                "k1_per_layer_per_rank": all(
                    r[count] == {"flash_fwd": expected_k1, "flash_bwd": 0} for r in ranks),
                "bytes": all(r["weights_bytes"] + r["kv_bytes"] == r["expected_bytes"]
                             for r in ranks),
                "load_peak": device.type != "cuda" or all(
                    r["load_peak_bytes"] - r["memory_before"]
                    <= r["expected_bytes"] + r["draw_bytes"] + LOAD_SLACK_BYTES for r in ranks),
                "freed": all(r["freed"] for r in ranks),
                "memory_returned": device.type != "cuda" or all(
                    r["memory_after"] == r["memory_before"] for r in ranks),
            }
            if tp == 2:
                lead_fault = faults[0] or {}
                rec["gates"]["follower_fault"] = (
                    all(f is not None and f.get("thread_alive") is False
                        and f.get("watcher_alive") is False for f in faults)
                    and lead_fault.get("ended") is True
                    and lead_fault["seconds"] < FAULT_DEADLINE_S
                    and lead_fault["tokens"][-1] == -1
                    and "injected follower fault" in lead_fault["error"]
                    and "rank 1" in lead_fault["error"])
            good = all(rec["gates"].values())
        rec["ok"] = good
        ok = ok and good
        records.append(rec)
        _emit(rec)
    _emit({"phase": "serve", "ok": ok, "tps": [r["tp"] for r in records],
           "k1_expected_per_rank": expected_k1})
    _emit({"ok": ok, "device": {"platform": "gpu" if args.device == "cuda" else "cpu",
                                "kind": card["device"], "count": card["count"]}})
    return 0 if ok else 1


def _serve_tiers_tp1(args, device, ref_eng, margin: float, cfg) -> bool:
    """The tier run at tp=1 in this process (the reference's weights stay
    beside it), with a spill directory of its own; emits its record."""
    import asyncio
    import gc

    tmp = tempfile.mkdtemp(prefix="chip_mesh_kv_spill_")
    before = _allocated(device)
    try:
        server = _tier_server(args, 1, device, tmp)
        eng = server._engine
        run = _tier_run(args, server, device)
        worker = run.pop("spill_worker")
        asyncio.run(server.shutdown())
        run["spill_worker_stopped"] = worker is None or not worker.is_alive()
        del server, eng
        gc.collect()
        if device.type == "cuda":
            import torch

            torch.cuda.empty_cache()  # the workers' rank 0 shares GPU 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "tiers_tp1", "model": args.model, "tp": 1,
           **_tier_gates(args, ref_eng, margin, cfg, [run]), **_tier_report(run),
           "memory_before": before, "memory_after": _allocated(device)}
    rec["ok"] = all(rec["gates"].values())
    _emit(rec)
    return rec["ok"]


def main(argv=None) -> int:
    args = _args(argv)
    args.argv = argv
    if args.rank is not None:
        return _serve_worker(args) if args.mode == "serve" else _worker(args)
    import torch

    need = max(TP_DEGREES) if args.mode == "serve" else args.ranks
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < need):
        print(f"chip_mesh: {need} GPUs needed", file=sys.stderr)
        return 2
    if args.device == "cuda":
        from chip_smoke import phase_card

        card = phase_card()
    else:
        card = {"device": "cpu", "count": 0}
    if args.mode == "serve":
        return _serve_main(args, card)
    axes = _axes(args.mesh)
    blocks = math.prod(axes.get(a, 1) for a in ("dp", "fsdp"))
    ref = _reference(args, blocks)
    _emit({"phase": "reference", **ref})
    tmp = tempfile.mkdtemp(prefix="chip_mesh_")
    try:
        codes = _launch(args, args.ranks, tmp)
        ranks = []
        for rank in range(args.ranks):
            path = os.path.join(tmp, f"rank_{rank}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path) else None)
    finally:
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
