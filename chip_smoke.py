#!/usr/bin/env python3
"""Drive the PyTorch port (`ray_tpu_torch`) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py                   # every phase, as the card check runs it
    python3 chip_smoke.py --phases build,k1,k2   # a subset; no result line

Phases, each printing one JSON record per line:
  card     the card's name and power limit (nvidia-smi)
  build    K1's and K2's CUDA sources compiled with nvcc for sm_90a, one nvcc
           each, started together; each kernel's registers and spill bytes
           from the ptxas report (a spill fails the run)
  k1       the flash-attention forward kernel held against its plain PyTorch
           version on the card, per shape, with times (CUDA events, median of
           >= 20 after warmup) beside SDPA as a yardstick (kernel_over_library)
           and the card's bound, and the host time of one call beside SDPA's;
           rerun 20 times on the same inputs, equal bit for bit
  k2       the flash-attention backward kernel held against its plain PyTorch
           version the same way, beside SDPA's backward, with each of its CUDA
           kernels' device time (torch.profiler), and run twice on the same
           inputs: the results must be equal bit for bit
  head     the tied head's bf16-operand, f32-result GEMM (`_matmul_f32`,
           cuBLAS) forward and backward against f32 matmuls on the card, at
           the train phase's head shapes
  model    llama3-8b at full width and depth, random weights: the Transformer's
           flash route (K1 in every layer) against its plain-attention route
  serve    LLMServer(llama3-8b) answering 4 concurrent greedy requests, each
           answer held against a teacher-forced plain-attention forward and
           carrying the flight recorder's timing; then one decode step and one
           prefill chunk profiled (wall time against device busy time,
           torch.profiler)
  prefix   the paged KV prefix cache on the serve phase's weights: a cold
           request (1,024-token prefix + its own suffix) fills a 1 GiB cache,
           then 4 prefix + suffix requests hit it at offset 1,024 together
           (no K1 launch, the attached rows bit for bit the cold prefill's,
           every token through the teacher-forced check, no lease left, each
           insert reading back only the blocks the cache lacked), then
           the same 4 on an engine without a cache; TTFT, TPOT and timing per
           request, the attach and the insert read-back in ms
  tiers    the tiered prefix cache on the serve phase's weights, built from
           the llm_kv_* flags (host pool 160 MiB, device tier 256 MiB, a
           spill directory capped at 1 GiB): a 1,072-token prompt cold, hit
           from the host pool (promoting it to the card), from the card,
           evicted to disk by a second cold prompt, and hit from disk with
           its head still resident (bf16 blocks stitched back): K1 only on
           the cold requests, the rows from every tier bit for bit the cold
           rows, the device hit's rows on the card (no H2D copy), the hits'
           tokens equal and through the teacher-forced check, no lease left,
           the spill worker stopped; attach ms per tier (synchronized),
           TTFT, promotion ms, spill seconds and disk promotion ms
  guided   LLMServer(llama3-8b, the serve phase's weights made again from its
           seed, their sums checked equal) answering a regex,
           a JSON schema and a grammar request beside an unguided one
           (generate(guided=...)): each text valid under its spec, every
           guided token through the teacher-forced check with the replayed
           host mask added, every ConstraintState released; compile ms at
           vocab 128,256, the host mask's ms per token, and the unguided
           request's TPOT beside guided slots (multi-step off) and without
  stream   on that server: generate_stream's text and open_stream's tokens
           equal generate's; a guided stream closed after 3 tokens frees its
           slot within one scheduler iteration (counted between the engine's
           receipt of the cancel and the free slot; cancel-to-free ms split
           there), its record cancelled and its ConstraintState released
  spec     speculative decoding on the serve prompts and weights: a plain
           engine, then the ngram draft (k 6) over the prompts twice, the
           8-layer early-exit draft and the self-draft (k 4 each): every
           token through the teacher-forced check, K1 launched once per
           layer per admission plus once per draft layer (the draft's
           whole-prompt prefill); TTFT, TPOT, tokens/s, acceptance, tokens
           per verify round, verify and propose ms
  lora     multi-LoRA serving on the serve prompts and weights: three rank-16
           adapters on q and v of every layer through 2 device slots, a
           batch of base, a0, a1, a2 and the same 4 reversed (one adapter
           request waits for a pin); base tokens and logits bit for bit an
           engine without lora_config's, adapter tokens through the
           teacher-forced check against merged weights, the paged tokens
           equal to an engine that never pages, K1 once per layer per
           admission, no pin left; page-in ms, cold- against warm-adapter
           TTFT, the delta's TPOT cost and kernels per decode step
  pd       the PD handoff in process on the serve prompts and weights: a
           prefill engine's prefill_detached (no slot taken; K1 once per
           layer per prompt) and a decode engine's submit_prefilled, the
           rows handed over as a host tensor, as f32 numpy and as a CUDA
           tensor, beside a mono engine (FIFO, no token budget, no prefix
           cache): the detached rows bit for bit the mono engine's prefill
           rows, every pair run's tokens equal to the mono engine's and
           through the teacher-forced check, no K1 and no prefill chunk on
           the decode engine; each attach's ms per form, the detached
           prefill's ms beside the mono TTFT
  train    init_state/build_train_step on llama3-1b (full width and depth,
           [4, 2048], remat, fused cross-entropy) and on gpt2-125m ([8, 1024],
           no remat, plain cross-entropy): step-1 gradients of the flash route
           (K1 + K2) against the plain-attention route and an f32 evaluation,
           then steps on a repeated batch with their loss, exact K1/K2 launch
           counts, step time, MFU, device idle share and peak memory
  remat    llama3-1b as the train phase runs it under each remat policy (full,
           attn, dots, selective), one set of weights and one batch: step-1
           gradients against "full"'s, K1/K2 launches per step (K1 once per
           layer under "selective", twice under the others), step time, MFU
           and peak memory per policy
  fused    llama3-1b with fused_qkv=True, its weights the unfused model's
           concatenated: step-1 gradients (split back) through the train
           phase's f32-distance check, launch counts, step time beside the
           unfused model's
  ckpt     gpt2-125m saved with AsyncCheckpointWriter after 2 steps while step
           3 runs, restored bit for bit into a fresh state, step 3 resumed from
           it, and LLMServer warm-started from the checkpoint serving 2 greedy
           requests token-identical to an engine over the in-memory weights
  mesh     training over a mesh of one rank (NCCL, a FileStore rendezvous;
           one card cannot hold two ranks): llama3-1b built on the meta
           device, sharded with FSDP2 by init_state over create_mesh({"fsdp":
           1}), its weights drawn leaf by leaf from the train phase's seed,
           3 steps ([4, 2048], full remat, fused cross-entropy) beside the
           same steps on one device: loss and grad_norm within 1e-5
           relative (bit for bit reported), every weight a DTensor with the
           rules' placement, K1 32 and K2 16 launches a step, the step and
           params saved by process 0 of 1 and restored onto the mesh bit for
           bit; step time against the one-device step, idle share, peak
           memory of the init and the steps, the save's blocked ms
Then a summary (failed phases; kernel_over_library at the shapes the kernels
are judged by), the kernels line and, last, {"ok": true, "device": {...}}.
The kernel
launch counts, both kernels', are set to 0 just before each main path (the
model's forward, the served requests, each configuration's and each remat
policy's train steps, the mesh phase's steps, the prefix phase's cold request, its hits and its
uncached requests, each tiers-phase request, the guided batch, the stream phase's requests, each
spec-phase run, each lora-phase batch and its cold/warm requests, the pd
phase's mono requests, its detached prefills and each of its pair runs) and read
just after; the kernels line's
`launches` are K1's on the served requests and K2's on llama3-1b's steps,
with every path's counts beside them.

Exits non-zero (and prints no result) without a GPU, without the package
beside it, or when any phase fails. The only process it starts besides
itself is nvcc (and nvidia-smi), both waited for; the threads it starts
(the checkpoint writers, the engines' steppers, the spill worker) are shut
down, and the mesh phase's process group destroyed, before it ends.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# H100 SXM published dense peaks (NVIDIA data sheet), used for bound_ms.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# K1 against flash_forward_reference on the same bf16 inputs. out: both sides
# round the output to bf16 (an ulp is 2**-7 relative) and round p to bf16 at
# the running rather than the final max, so allow 1e-2 + 1e-2*|ref| per
# element. lse: f32 throughout on both sides, only the summation order
# differs, so 1e-3 absolute at |lse| <~ 10.
OUT_ATOL, OUT_RTOL, LSE_ATOL = 1e-2, 1e-2, 1e-3

# K2 against flash_backward_reference on the same bf16 inputs. Both sides
# compute p, dp and ds in f32 from the same lse, round p and ds to bf16 at
# the same points and sum over the GQA repeat axis in f32, so they differ by
# summation order, by p or ds values that land on the other side of a bf16
# rounding step, and by the final bf16 rounding (an ulp is 2**-8 to 2**-7
# relative). Per element 4e-3 + 2e-2*|ref| (4e-3 is one ulp at |ref| in
# [0.5, 1); most |dq| are 0.03-0.05 at the main shape, so the absolute term
# alone would hide nothing smaller than 10%), and per tensor
# ||got - ref|| / ||ref|| <= 1e-2, which holds every row to the same
# relative standard. Each record states the readings and those of a planted
# fault (delta = rowsum(g * out) dropped, in the plain version) that the
# per-tensor limit must catch.
GRAD_ATOL, GRAD_RTOL, GRAD_REL_L2 = 4e-3, 2e-2, 1e-2

# The tied head's GEMM (`_matmul_f32`: bf16 operands, f32 sums and result,
# cuBLAS) and its backward against f32 matmuls of the same bf16-rounded
# operands on the card. The products are exact in f32 on both sides and only
# the summation order differs, so the f32 results (logits, the table's grad)
# agree to ||d|| / ||ref|| <= 1e-4; a GEMM that rounded its result to bf16
# would read about 1e-3. The activation's grad is written in bf16 on both
# sides, so <= 4e-3 (one bf16 ulp relative).
HEAD_F32_REL_L2, HEAD_BF16_REL_L2 = 1e-4, 4e-3
# (rows, K, N): llama3-1b's fused cross-entropy chunk ([4, 256] rows against
# the [128256, 2048] table) and gpt2-125m's whole head ([8, 1024] rows,
# vocab 50257).
HEAD_CASES = [(4 * 256, 2048, 128256), (8 * 1024, 768, 50257)]

# (B, S = T, H, Hkv, D, causal, layout). The first two are the train phase's
# shapes (llama3-1b [4, 2048] with GQA 32/8, gpt2-125m [8, 1024] MHA), both
# in the model's bhsd layout; then D 128 (llama3-8b), both layouts, ragged S,
# no mask, and the fused phase's bshd route at llama3-1b's train shape.
K2_CASES = [
    (4, 2048, 32, 8, 64, True, "bhsd"),
    (8, 1024, 12, 12, 64, True, "bhsd"),
    (1, 2048, 32, 8, 128, True, "bshd"),
    (1, 100, 32, 8, 128, True, "bhsd"),
    (2, 200, 12, 12, 64, True, "bshd"),
    (1, 130, 8, 2, 64, False, "bhsd"),
    (1, 256, 32, 8, 128, False, "bshd"),
    (4, 2048, 32, 8, 64, True, "bshd"),
]
K2_MAIN_SHAPE = K2_CASES[0]

# (S = T, H, Hkv, D, causal, layout). The serve phase's offset-0 prefill
# chunks are buckets 32, 128, 128 and 128 (the 256-token budget less one
# token per slot already decoding, rounded down to a bucket); 256 is the
# largest bucket under that budget; the guided phase's prompts of 40 and 60
# tokens take their first chunk at bucket 64, those of 80 and 100 at 128; the
# stream phase's 16-token prompt at 16; 512 is the model phase's sequence
# (bhsd) and a model draft's whole-prompt prefill of the 300-token serve
# prompt (bshd; the draft prefills 32, 128, 256 and 512); 2048 is the served
# max_seq. The lora phase's first chunks are the serve phase's (32 and 128,
# and 256 for a long prompt admitted while nothing decodes). The ckpt phase
# serves gpt2-125m (12 heads, D 64) prompts of 24 and 57 tokens. Every shape a main path launches K1 or K2 at is logged
# (`_ShapeLog`); one missing here is checked after the main paths
# (`phase_shapes`) and reported as unlisted.
K1_CASES = [
    (16, 32, 8, 128, True, "bshd"),
    (32, 32, 8, 128, True, "bshd"),
    (64, 32, 8, 128, True, "bshd"),
    (100, 32, 8, 128, True, "bshd"),
    (128, 32, 8, 128, True, "bshd"),
    (256, 32, 8, 128, True, "bshd"),
    (2048, 32, 8, 128, True, "bshd"),
    (16, 32, 8, 64, True, "bhsd"),
    (100, 32, 8, 64, True, "bhsd"),
    (2048, 32, 8, 64, True, "bhsd"),
    (512, 32, 8, 128, True, "bhsd"),
    (100, 32, 8, 128, False, "bshd"),
    (512, 32, 8, 128, True, "bshd"),
    (32, 12, 12, 64, True, "bshd"),
    (64, 12, 12, 64, True, "bshd"),
]
# K1 at the train phase's shapes, batch included: (B, S, H, Hkv, D, causal,
# layout); the fused phase's route is bshd.
K1_TRAIN_CASES = [(4, 2048, 32, 8, 64, True, "bhsd"), (8, 1024, 12, 12, 64, True, "bhsd"),
                  (4, 2048, 32, 8, 64, True, "bshd")]

# The train phase's configurations: (model, batch, seq, remat, timed steps).
TRAIN_RUNS = [("llama3-1b", 4, 2048, True, 6), ("gpt2-125m", 8, 1024, False, 6)]
K1_REPEATS = 20  # reruns of K1 on the same inputs, each compared bit for bit
K1_MAIN_SHAPE = (128, 32, 8, 128, True, "bshd")  # 3 of the 4 served offset-0 chunks
K1_MAX_SEQ_SHAPE = (2048, 32, 8, 128, True, "bshd")  # the served max_seq, one prompt

PHASES = ("build", "k1", "k2", "head", "model", "serve", "prefix", "tiers", "guided", "stream",
          "spec", "lora", "pd", "train", "remat", "fused", "ckpt", "mesh")

# The guided phase's specs: (spec, max_tokens). The regex finishes at its
# accepting dead-end (8 tokens); the schema's integer is unbounded, so
# budget steering must close the object within 48 tokens.
GUIDED_SPECS = {
    "regex": ("[0-9]{3}-[0-9]{4}", 8),
    "schema": ({"json_schema": {"type": "object",
                                "properties": {"ok": {"type": "boolean"},
                                               "n": {"type": "integer"}},
                                "required": ["ok", "n"]}}, 48),
    "grammar": ({"grammar": {"root": "<word>(,<word>){0,2}", "word": "[a-z]{2,4}"}}, 24),
}
# The spec phase's drafts: (name, spec_config, passes over the serve prompts).
SPEC_DRAFTS = [("ngram", {"method": "ngram", "num_spec_tokens": 6}, 2),
               ("layers8", {"draft_layers": 8, "num_spec_tokens": 4}, 1),
               ("self", {"num_spec_tokens": 4}, 1)]
# The lora phase: PEFT's default LoRA targets for LLaMA (q_proj, v_proj) at
# rank 16 with its common lora_alpha = 2 * rank; three adapters in a
# registry of 4, paged through 2 device slots.
LORA_CONFIG = {"max_loras": 4, "rank": 16, "cache_slots": 2}
LORA_ALPHA = 32.0
LORA_NAMES = ("a0", "a1", "a2")


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, n: int = 100) -> float:
    """Host time of one call of fn in microseconds: n calls back to back with
    no synchronisation inside, over n. While it exceeds the device time, a
    single timed call (time_ms) is this plus the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref|| over every element, in f32."""
    import torch

    ref = ref.float()
    return float(torch.linalg.vector_norm(got.float() - ref) / torch.linalg.vector_norm(ref))


def _pairs(S, T, causal):
    """(row, col) pairs the top-left causal mask keeps."""
    if causal:
        n = min(S, T)
        return n * (n + 1) // 2 + max(0, S - T) * T
    return S * T


def k1_bound(B, H, Hkv, S, T, D, causal):
    """Least time for K1's work on this card: the larger of the flops (q.k and
    p.v over the (row, col) pairs the mask keeps) at the bf16 peak and the
    bytes (q, k, v read once, out and lse written once) at the HBM rate."""
    flops = 4 * B * H * D * _pairs(S, T, causal)
    nbytes = 2 * B * S * H * D * 2 + 2 * B * T * Hkv * D * 2 + B * H * S * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_card() -> dict:
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(out, flush=True)
    rec = {"phase": "card", "nvidia_smi": out, "torch": torch.__version__,
           "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit(rec)
    return rec


def k2_bound(B, H, Hkv, S, T, D, causal):
    """Least time for K2's work on this card: the larger of the flops (five
    products of depth D per kept (row, col) pair: s, dp, dv, dk, dq) at the
    bf16 peak and the bytes (q, k, v, out, g and lse read once, dq, dk, dv
    written once) at the HBM rate."""
    flops = 10 * B * H * D * _pairs(S, T, causal)
    nbytes = 3 * B * S * H * D * 2 + B * H * S * 4 + 2 * B * T * Hkv * D * 2 \
        + B * S * H * D * 2 + 2 * B * T * Hkv * D * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


_PTXAS_NAME = re.compile(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)")
_PTXAS_KERNEL = re.compile(r"(flash_[a-z_]+?_kernel)I((?:Li\d+E)+)")


def _kernel_label(mangled: str) -> str:
    """flash_fwd_kernel<64,4> from its mangled name (the template arguments
    are the head dim and, for K1, the warps per block)."""
    m = _PTXAS_KERNEL.search(mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def parse_ptxas(log: str) -> list:
    """Per kernel of an nvcc -Xptxas -v log: registers, stack, spill bytes."""
    out: dict = {}
    name = None
    for line in log.splitlines():
        m = _PTXAS_NAME.search(line)
        if m:
            name = _kernel_label(m.group(1))
            out.setdefault(name, {"kernel": name})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["static_smem"] = int(m.group(1))
    return list(out.values())


def phase_build() -> dict:
    from ray_tpu_torch.ops import _build

    names = ["flash_fwd", "flash_bwd"]
    t0 = time.time()
    _build.build(names)
    kernels = {name: parse_ptxas(_build.BUILD_LOG.get(name, "")) for name in names}
    spills = sum(k.get("spill_stores", 0) + k.get("spill_loads", 0)
                 for ks in kernels.values() for k in ks)
    rec = {"phase": "build", "seconds": round(time.time() - t0, 3), "kernels": kernels,
           "spill_bytes": spills, "ptxas": [
               line.strip() for name in names
               for line in _build.BUILD_LOG.get(name, "").splitlines()
               if "registers" in line or "bytes stack" in line or "Compiling" in line]}
    emit(rec)
    return rec


def k1_case(S, H, Hkv, D, causal, layout, seed=0, B=1) -> dict:
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_bhsd,
        flash_forward,
        flash_forward_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "bshd":
        qs, kvs = (B, S, H, D), (B, S, Hkv, D)
    else:
        qs, kvs = (B, H, S, D), (B, Hkv, S, D)
    q = torch.randn(qs, generator=g, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(kvs, generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(kvs, generator=g, device="cuda", dtype=torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_forward(q, k, v, causal=causal, scale=scale, layout=layout)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_forward_reference(q, k, v, causal=causal, scale=scale,
                                               layout=layout)
    err = (out.float() - ref_out.float()).abs()
    out_ok = bool((err <= OUT_ATOL + OUT_RTOL * ref_out.float().abs()).all())
    lse_err = float((lse - ref_lse).abs().max())
    finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())
    repeats = 0
    for _ in range(K1_REPEATS):
        out2, lse2 = flash_forward(q, k, v, causal=causal, scale=scale, layout=layout)
        repeats += int(torch.equal(out2, out) and torch.equal(lse2, lse))

    if layout == "bshd":
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    else:
        qh, kh, vh = q, k, v
    kernel_ms = time_ms(lambda: flash_forward(q, k, v, causal=causal, scale=scale,
                                              layout=layout))
    plain_ms = time_ms(lambda: flash_forward_reference(q, k, v, causal=causal,
                                                       scale=scale, layout=layout))
    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, scale=scale,
                                              enable_gqa=True)

    library_ms = time_ms(sdpa)
    op = flash_attention if layout == "bshd" else flash_attention_bhsd
    hosts = {"kernel": host_us(lambda: flash_forward(q, k, v, causal=causal, scale=scale,
                                                     layout=layout)),
             "op": host_us(lambda: op(q, k, v, causal, scale)),
             "library": host_us(sdpa)}
    bound_ms, bound_by = k1_bound(B, H, Hkv, S, S, D, causal)
    return {
        "phase": "k1", "shape": {"B": B, "S": S, "T": S, "H": H, "Hkv": Hkv, "D": D,
                                 "causal": causal, "layout": layout},
        "out_max_abs_err": float(err.max()), "out_tol": [OUT_ATOL, OUT_RTOL],
        "lse_max_abs_err": lse_err, "lse_tol": LSE_ATOL,
        "bitwise_repeat": [repeats, K1_REPEATS],
        "ok": out_ok and lse_err <= LSE_ATOL and finite and repeats == K1_REPEATS,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "kernel_over_library": kernel_ms / library_ms, "host_us": hosts,
        "bound_ms": bound_ms, "bound_us": bound_ms * 1e3, "bound_by": bound_by,
    }


def phase_k1() -> list:
    recs = []
    for case in K1_CASES:
        rec = k1_case(*case)
        emit(rec)
        recs.append(rec)
    for B, *case in K1_TRAIN_CASES:
        rec = k1_case(*case, B=B)
        emit(rec)
        recs.append(rec)
    return recs


def _kernel_split(fn) -> dict:
    """Device time of each CUDA kernel one call of fn launches (torch.profiler,
    one call after a warm-up), by kernel name without its arguments."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def k2_case(B, S, H, Hkv, D, causal, layout, seed=0) -> dict:
    """K2 against flash_backward_reference on the same bf16 inputs (out and
    lse from K1), then its time beside the plain version's and SDPA's
    backward (torch.autograd.grad through scaled_dot_product_attention)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import (
        flash_backward,
        flash_backward_reference,
        flash_forward,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "bshd":
        qs, kvs = (B, S, H, D), (B, S, Hkv, D)
    else:
        qs, kvs = (B, H, S, D), (B, Hkv, S, D)
    q, g = (torch.randn(qs, generator=gen, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    k, v = (torch.randn(kvs, generator=gen, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_forward(q, k, v, causal=causal, scale=scale, layout=layout)
    got = flash_backward(q, k, v, out, lse, g, causal=causal, scale=scale, layout=layout)
    # No atomics: a second run on the same inputs repeats bit for bit.
    again = flash_backward(q, k, v, out, lse, g, causal=causal, scale=scale, layout=layout)
    repeats = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    torch.cuda.synchronize()
    ref = flash_backward_reference(q, k, v, out, lse, g, causal=causal, scale=scale,
                                   layout=layout)
    errs, need_atol, rel, ok = {}, {}, {}, True
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        diff = (a.float() - b.float()).abs()
        errs[name] = float(diff.max())
        need_atol[name] = float((diff - GRAD_RTOL * b.float().abs()).max())
        rel[name] = _rel_l2(a, b)
        ok = ok and a.shape == b.shape and a.dtype == b.dtype and bool(
            (diff <= GRAD_ATOL + GRAD_RTOL * b.float().abs()).all()) and bool(
            torch.isfinite(a.float()).all()) and rel[name] <= GRAD_REL_L2
    # The planted fault: delta dropped (out = 0 makes rowsum(g * out) = 0);
    # it moves dq and dk, and the per-tensor limit must see it.
    fault = flash_backward_reference(q, k, v, torch.zeros_like(out), lse, g, causal=causal,
                                     scale=scale, layout=layout)
    fault_rel = {name: _rel_l2(a, b) for name, a, b in zip(("dq", "dk"), fault, ref)}
    ok = ok and min(fault_rel.values()) > GRAD_REL_L2 and repeats
    del got, ref, fault
    kernel_ms = time_ms(lambda: flash_backward(q, k, v, out, lse, g, causal=causal,
                                               scale=scale, layout=layout))
    split_ms = _kernel_split(lambda: flash_backward(q, k, v, out, lse, g, causal=causal,
                                                    scale=scale, layout=layout))
    plain_ms = time_ms(lambda: flash_backward_reference(q, k, v, out, lse, g, causal=causal,
                                                        scale=scale, layout=layout), iters=5)
    tr = (lambda t: t.transpose(1, 2)) if layout == "bshd" else (lambda t: t)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(tr(ql), tr(kl), tr(vl), is_causal=causal,
                                              scale=scale, enable_gqa=True)
    def sdpa_backward():
        return torch.autograd.grad(sdpa_out, (ql, kl, vl), tr(g), retain_graph=True)

    library_ms = time_ms(sdpa_backward)
    hosts = {"kernel": host_us(lambda: flash_backward(q, k, v, out, lse, g, causal=causal,
                                                      scale=scale, layout=layout), n=20),
             "library": host_us(sdpa_backward, n=20)}
    bound_ms, bound_by = k2_bound(B, H, Hkv, S, S, D, causal)
    return {
        "phase": "k2", "shape": {"B": B, "S": S, "T": S, "H": H, "Hkv": Hkv, "D": D,
                                 "causal": causal, "layout": layout},
        "max_abs_err": errs, "atol_needed_at_rtol": need_atol, "rel_l2": rel,
        "fault_delta_dropped_rel_l2": fault_rel,
        "tol": {"atol": GRAD_ATOL, "rtol": GRAD_RTOL, "rel_l2": GRAD_REL_L2},
        "bitwise_repeat": repeats, "ok": ok,
        "kernel_ms": kernel_ms, "kernel_split_ms": split_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "kernel_over_library": kernel_ms / library_ms,
        "host_us": hosts, "bound_ms": bound_ms, "bound_by": bound_by,
    }


def phase_k2() -> list:
    import torch

    recs = []
    for case in K2_CASES:
        rec = k2_case(*case)
        emit(rec)
        recs.append(rec)
        torch.cuda.empty_cache()
    return recs


def _shape_key(q, k, causal, layout) -> tuple:
    """(B, S, T, H, Hkv, D, causal, layout) of a K1/K2 call."""
    if layout == "bshd":
        (B, S, H, D), T, Hkv = q.shape, k.shape[1], k.shape[2]
    else:
        (B, H, S, D), Hkv, T = q.shape, k.shape[1], k.shape[2]
    return (B, S, T, H, Hkv, D, bool(causal), layout)


class _ShapeLog:
    """While installed, logs the shape of every K1 and K2 launch by the path
    that is current (`tag`): it wraps the CUDA launchers that the wrappers
    `flash_forward` and `flash_backward` look up at each call. The counts
    (`LAUNCHES`) stay the wrappers' own."""

    def __init__(self):
        self.tag = None
        self.seen = {"k1": {}, "k2": {}}
        self._saved = None

    def install(self):
        from ray_tpu_torch.ops import attention

        fwd, bwd = attention._flash_forward_cuda, attention._flash_backward_cuda

        def log(kernel, q, k, causal, layout):
            self.seen[kernel].setdefault(_shape_key(q, k, causal, layout), set()).add(self.tag)

        def fwd_logged(q, k, v, *, causal, scale, layout):
            log("k1", q, k, causal, layout)
            return fwd(q, k, v, causal=causal, scale=scale, layout=layout)

        def bwd_logged(q, k, v, out, lse, g, *, causal, scale, layout):
            log("k2", q, k, causal, layout)
            return bwd(q, k, v, out, lse, g, causal=causal, scale=scale, layout=layout)

        self._saved = (fwd, bwd)
        attention._flash_forward_cuda, attention._flash_backward_cuda = fwd_logged, bwd_logged

    def uninstall(self):
        from ray_tpu_torch.ops import attention

        attention._flash_forward_cuda, attention._flash_backward_cuda = self._saved


def phase_shapes(log: _ShapeLog, k1: list, k2: list) -> tuple:
    """Every shape a main path launched K1 or K2 at must be held against the
    plain version: a shape that no K1/K2 case of this run covered is checked
    now by `k1_case`/`k2_case` (S = T only; any other is a failure). Returns
    the record and the new cases' records."""
    import torch

    def key(rec):
        sh = rec["shape"]
        return tuple(sh[n] for n in ("B", "S", "T", "H", "Hkv", "D", "causal", "layout"))

    checked = {"k1": {key(r) for r in k1}, "k2": {key(r) for r in k2}}
    extra = {"k1": [], "k2": []}
    for kernel, case in (("k1", k1_case), ("k2", k2_case)):
        for (B, S, T, H, Hkv, D, causal, layout) in sorted(
                set(log.seen[kernel]) - checked[kernel], key=str):
            if S != T:
                extra[kernel].append({"phase": kernel, "ok": False, "shape": {
                    "B": B, "S": S, "T": T, "H": H, "Hkv": Hkv, "D": D, "causal": causal,
                    "layout": layout}, "error": "no check for S != T"})
                continue
            rec = (k1_case(S, H, Hkv, D, causal, layout, B=B) if kernel == "k1"
                   else k2_case(B, S, H, Hkv, D, causal, layout))
            rec["unlisted"] = True
            emit(rec)
            extra[kernel].append(rec)
            torch.cuda.empty_cache()

    def paths(kernel):
        return [{"shape": list(k), "paths": sorted(p for p in tags if p)}
                for k, tags in sorted(log.seen[kernel].items(), key=lambda kv: str(kv[0]))]

    rec = {"phase": "shapes", "k1": paths("k1"), "k2": paths("k2"),
           "unlisted": {kn: [r["shape"] for r in extra[kn]] for kn in extra}}
    rec["ok"] = all(r["ok"] for r in (*extra["k1"], *extra["k2"]))
    emit(rec)
    return rec, extra


def head_case(rows: int, K: int, N: int, seed: int = 0) -> dict:
    """`_matmul_f32` (the tied head: a [rows, K] bf16 @ the f32 table's
    transpose [K, N], as the train steps call it) forward and backward
    against f32 matmuls of the same bf16-rounded operands and cotangent."""
    import torch

    from ray_tpu_torch.models.transformer import _matmul_f32

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16)
    table = torch.randn(N, K, generator=gen, device="cuda") * K ** -0.5
    cot = torch.randn(rows, N, generator=gen, device="cuda")
    a.requires_grad_()
    table.requires_grad_()
    w = table.T
    out = _matmul_f32(a, w, w.detach().to(torch.bfloat16))
    out.backward(cot)
    with torch.no_grad():
        a32, w32, c32 = a.float(), w.to(torch.bfloat16).float(), cot.to(torch.bfloat16).float()
        rel = {"out": _rel_l2(out, a32 @ w32),
               "da": _rel_l2(a.grad, (c32 @ w32.T).to(torch.bfloat16)),
               "dtable": _rel_l2(table.grad, (a32.T @ c32).T)}
    ok = (out.dtype == torch.float32 and a.grad.dtype == torch.bfloat16
          and table.grad.dtype == torch.float32
          and rel["out"] <= HEAD_F32_REL_L2 and rel["dtable"] <= HEAD_F32_REL_L2
          and rel["da"] <= HEAD_BF16_REL_L2)
    return {"phase": "head", "shape": {"rows": rows, "K": K, "N": N}, "rel_l2": rel,
            "tol": {"f32": HEAD_F32_REL_L2, "bf16": HEAD_BF16_REL_L2}, "ok": ok}


def phase_head() -> list:
    import torch

    recs = []
    for case in HEAD_CASES:
        rec = head_case(*case)
        emit(rec)
        recs.append(rec)
        torch.cuda.empty_cache()
    return recs


def phase_model(name: str = "llama3-8b", device: str = "cuda", seq: int = 512,
                seed: int = 0) -> dict:
    """llama3-8b, full width and depth, random bf16 weights: the flash route
    (K1 in all 32 layers) against the plain-attention route on the same
    weights. Tolerance: both are bf16 evaluations of one function that round
    at different places, so each should sit about as far from the f32
    evaluation (same bf16-valued weights upcast, f32 activations) as the
    plain route does; their gap is then at most twice that distance."""
    import dataclasses

    import torch

    from ray_tpu_torch.models.transformer import Transformer, get_config
    from ray_tpu_torch.ops.attention import LAUNCHES

    cfg = get_config(name, param_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.time()
    flash = Transformer(cfg, device=device, generator=gen)
    _sync(device)
    init_s = time.time() - t0
    params = flash.param_tree()
    plain = Transformer(dataclasses.replace(cfg, attention="reference"), params,
                        device=device)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen, device=device)
    with torch.inference_mode():
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        t0 = time.time()
        lf = flash(tokens)
        _sync(device)
        flash_s = time.time() - t0
        launches = dict(LAUNCHES)
        lp = plain(tokens)
        del plain
        params32 = _tree_map(lambda t: t.float(), params)
        cfg32 = dataclasses.replace(cfg, attention="reference", dtype=torch.float32,
                                    param_dtype=torch.float32)
        l32 = Transformer(cfg32, params32, device=device)(tokens)
        del params32
    d_kp = float((lf - lp).abs().max())
    d_p32 = float((lp - l32).abs().max())
    d_k32 = float((lf - l32).abs().max())
    tol = 2.0 * d_p32
    finite = bool(torch.isfinite(lf).all() and torch.isfinite(lp).all())
    rec = {
        "phase": "model", "model": name, "layers": cfg.n_layers,
        "hidden": cfg.hidden, "params_b": cfg.num_params() / 1e9, "tokens": [1, seq],
        "init_s": init_s, "flash_forward_s": flash_s, "launches": launches,
        "max_abs_logit_diff_flash_vs_plain": d_kp,
        "max_abs_logit_diff_plain_vs_f32": d_p32,
        "max_abs_logit_diff_flash_vs_f32": d_k32, "tolerance": tol,
        "top1_agreement_flash_vs_plain":
            float((lf.argmax(-1) == lp.argmax(-1)).float().mean()),
        "logit_std": float(lp.float().std()),
        "ok": launches == {"flash_fwd": cfg.n_layers, "flash_bwd": 0} and finite and d_kp <= tol,
    }
    del flash, params, lf, lp, l32
    if device == "cuda":
        torch.cuda.empty_cache()
    emit(rec)
    return rec


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _empty_cache(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.empty_cache()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tf_logits(eng, seq):
    """Logits [len(seq), V] of one forward over seq with the engine's plain
    attention route (a fresh cache, the causal mask)."""
    import torch

    from ray_tpu_torch.llm._engine import _forward_cached

    cfg, L = eng.cfg, len(seq)
    shape = (1, L, cfg.n_kv_heads, cfg.head_dim)
    caches = [(torch.zeros(shape, dtype=cfg.dtype, device=eng.device),
               torch.zeros(shape, dtype=cfg.dtype, device=eng.device))
              for _ in range(cfg.n_layers)]
    pos = torch.arange(L, device=eng.device)
    mask = (pos[:, None] >= pos[None, :])[None]
    return _forward_cached(eng.params, cfg, torch.tensor([seq], device=eng.device),
                           pos[None], caches, torch.zeros(1, dtype=torch.long,
                                                         device=eng.device), mask)[0]


def _divergence(eng, prompts, ref, got) -> list:
    """Where each of `got`'s sequences first leaves `ref`'s (None where they
    agree), with the teacher-forced logits there over prompt + the common
    prefix: the top logit, ref's token's and got's token's, and their gap."""
    import torch

    out = []
    with torch.inference_mode():
        for p, a, b in zip(prompts, ref, got):
            i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
            if i is None:
                out.append(None)
                continue
            row = _tf_logits(eng, p + a[:i])[-1].float()
            out.append({"index": i, "ref_token": a[i], "got_token": b[i],
                        "top_logit": float(row.max()), "ref_logit": float(row[a[i]]),
                        "got_logit": float(row[b[i]]),
                        "gap": float(row[a[i]] - row[b[i]])})
    return out


def _teacher_forced(eng, prompts, answers, masks=None) -> tuple:
    """(exact, total, worst gap) of served answers against a teacher-forced
    forward over prompt + answer with the engine's plain attention (fresh
    cache): each served token is that forward's argmax or `gap` logits
    below it. masks (one per answer, [len(answer), V] numpy or None): a
    guided answer's host masks, added to the logits first, as the engine
    adds them before it samples."""
    import torch

    exact = total = 0
    worst_gap = 0.0
    with torch.inference_mode():
        for i, (p, answer) in enumerate(zip(prompts, answers)):
            logits = _tf_logits(eng, p + answer[:-1])
            preds = logits[len(p) - 1:]
            if masks is not None and masks[i] is not None:
                preds = preds + torch.as_tensor(masks[i], device=eng.device)
            served = torch.tensor(answer, device=eng.device)
            gap = preds.max(-1).values - preds.gather(-1, served[:, None])[:, 0]
            exact += int((preds.argmax(-1) == served).sum())
            total += len(served)
            worst_gap = max(worst_gap, float(gap.max()))
            del logits
    return exact, total, worst_gap


def phase_serve(margin: float, name: str = "llama3-8b", device: str = "cuda",
                lengths=(20, 100, 255, 300), max_seq: int = 2048,
                seed: int = 1) -> tuple:
    """LLMServer(llama3-8b) answers 4 concurrent greedy requests; every served
    token is held against a teacher-forced forward over prompt + answer with
    the engine's plain attention (fresh cache): it must be that forward's
    argmax or within `margin` logits of it (random weights give near-ties
    that bf16 rounding may flip). Every reply carries the flight recorder's
    `timing`. Returns the record and (cfg, params) for the prefix phase."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import LLMConfig, LLMServer
    from ray_tpu_torch.ops.attention import LAUNCHES

    t0 = time.time()
    server = LLMServer(LLMConfig(model_id=name, num_slots=4, max_seq=max_seq,
                                 seed=seed, device=device))
    load_s = time.time() - t0
    eng, cfg = server._engine, server._cfg
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]

    async def serve(batch, max_tokens):
        return await asyncio.gather(*(server.generate(p, max_tokens=max_tokens)
                                      for p in batch))

    asyncio.run(serve([prompts[0][:8]], 2))  # warm-up: allocator, cuBLAS handles
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    chunks0 = eng.scheduler_stats()["prefill_chunks"]
    LAUNCHES.update(flash_fwd=0, flash_bwd=0)
    t0 = time.time()
    results = asyncio.run(serve(prompts, 32))
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    chunks = eng.scheduler_stats()["prefill_chunks"] - chunks0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None

    exact, total, worst_gap = _teacher_forced(eng, prompts,
                                              [r["token_ids"] for r in results])
    asyncio.run(server.shutdown())
    profile = None
    if device == "cuda":
        profile = profile_engine(eng, prefill_len=K1_MAIN_SHAPE[0])
    n_tokens = [len(r["token_ids"]) for r in results]
    tpot = [(r["latency_s"] - r["ttft_s"]) / max(1, len(r["token_ids"]) - 1)
            for r in results]
    rec = {
        "phase": "serve", "model": name, "num_slots": 4, "max_seq": max_seq,
        "prompt_lengths": list(lengths), "completion_tokens": n_tokens,
        "load_s": load_s, "wall_s": wall,
        "ttft_s": [r["ttft_s"] for r in results],
        "latency_s": [r["latency_s"] for r in results],
        "tpot_s": tpot, "output_tokens_per_s": sum(n_tokens) / wall,
        "decode_tokens_per_s_per_request": [1.0 / t for t in tpot],
        "peak_memory_gb": peak_gb, "prefill_chunks": chunks,
        "launches": launches,
        "launches_expected": {"flash_fwd": cfg.n_layers * len(prompts), "flash_bwd": 0},
        "teacher_forced_exact": exact, "teacher_forced_total": total,
        "worst_logit_gap": worst_gap, "margin": margin, "profile": profile,
        "timing": [r["timing"] for r in results],
        # the default cache (llm_prefix_cache_bytes: 16 blocks at llama3-8b)
        "prefix_cache": eng.prefix_cache_stats(),
    }
    rec["ok"] = (launches == rec["launches_expected"] and chunks > len(prompts)
                 and all(n == 32 for n in n_tokens) and worst_gap <= margin
                 and all(t is not None and "decode" in t["phases"] for t in rec["timing"]))
    emit(rec)
    return rec, (cfg, eng.params)


def _serve_engine(eng, prompts, max_tokens: int, tag: str, loras=None) -> list:
    """Submit every prompt to the engine at once (greedy, request ids
    `tag-i`, each on its LoRA adapter of `loras` or the base model), wait for
    all, and return per request its tokens, host-clock TTFT (submit to first
    callback), TPOT (mean gap between the first and last callbacks) and the
    flight recorder's `request_timing`."""
    import threading

    from ray_tpu_torch.llm import SamplingParams

    runs = []
    for i, p in enumerate(prompts):
        run = {"rid": f"{tag}-{i}", "tokens": [], "times": [], "done": threading.Event()}

        def cb(token, last, run=run):
            run["times"].append(time.perf_counter())
            run["tokens"].append(token)
            if last:
                run["done"].set()

        run["t0"] = time.perf_counter()
        eng.submit(p, SamplingParams(max_tokens=max_tokens), cb, request_id=run["rid"],
                   lora=loras[i] if loras else "")
        runs.append(run)
    for run in runs:
        if not run["done"].wait(timeout=600):
            raise RuntimeError(f"request {run['rid']} did not finish: {eng.error}")
    out = []
    for run, p in zip(runs, prompts):
        tt = run["times"]
        out.append({"rid": run["rid"], "prompt_len": len(p), "token_ids": run["tokens"],
                    "ttft_s": tt[0] - run["t0"],
                    "tpot_s": (tt[-1] - tt[0]) / max(1, len(tt) - 1),
                    "timing": eng.request_timing(run["rid"])})
    return out


def _events(eng, rid: str) -> list:
    return eng._recorder.lookup(rid)["events"]


def phase_prefix(cfg, params, margin: float, name: str = "llama3-8b",
                 device: str = "cuda", seed: int = 2,
                 prefix_len: int = 1024, suffixes=(64, 100, 128, 192),
                 cold_suffix: int = 48, max_tokens: int = 32, max_seq: int = 2048) -> dict:
    """The paged KV prefix cache and the flight recorder on llama3-8b, over the
    serve phase's weights. Engine A holds a 1 GiB cache (512 blocks of 16
    tokens, 2 MiB each at this width); engine B has none. One shared prefix
    of `prefix_len` random tokens: a cold request (prefix + a suffix no other
    prompt has) fills A's cache, then 4 prefix + suffix prompts run at once
    on A (each a hit on exactly the prefix's blocks) and then on B. Gates:
    every hit prefills from `prefix_len`; K1 launches once per layer for the
    cold request and never for the hits (their chunks start past row 0, the
    masked route); the rows a hit attached equal the cold prefill's rows bit
    for bit; every hit token passes the serve phase's teacher-forced check;
    no lease is left; every reply's timing has `decode`, and the hits'
    `cache-attach`. Reported: per request TTFT, TPOT and timing on A and B,
    the attach spans, the insert's read-back and pool times, the cache's
    counters, and how many hit tokens equal B's. Each insert must read back
    only the blocks the cache lacked."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm._engine import DecodeEngine
    from ray_tpu_torch.llm.kvcache import PrefixCacheManager
    from ray_tpu_torch.ops.attention import LAUNCHES

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, prefix_len).tolist()
    cold = prefix + rng.integers(0, cfg.vocab_size, cold_suffix).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size, n).tolist() for n in suffixes]
    bs = 16
    eng = DecodeEngine(cfg, params, num_slots=4, max_seq=max_seq, seed=seed,
                       prefix_cache=PrefixCacheManager(bs, 1 << 30), device=device)
    cache = eng._prefix_cache
    block_bytes = cfg.n_layers * 2 * bs * cfg.n_kv_heads * cfg.head_dim * cfg.dtype.itemsize

    # The insert's cost, split: the read-back of the blocks the cache lacks
    # (a block-major device gather, one D2H copy, a host copy per block) and
    # the rest (the pool's planning, eviction and linking). The first
    # token's pull has already synchronised the stream, so the read-back
    # times the copies.
    inserts = []
    insert_prompt_kv, read_kv_blocks = eng._insert_prompt_kv, eng._read_kv_blocks
    insert_missing = cache.insert_missing

    def timed_read_kv_blocks(slot, first, stop):
        t0 = time.perf_counter()
        blocks = read_kv_blocks(slot, first, stop)
        inserts[-1].update(read_blocks=[first, stop],
                           readback_ms=(time.perf_counter() - t0) * 1e3,
                           readback_mib=(stop - first) * block_bytes / 2**20)
        return blocks

    def counted_insert_missing(*a, **kw):
        added = insert_missing(*a, **kw)
        inserts[-1]["blocks_added"] = added
        return added

    def timed_insert_prompt_kv(slot, prompt, adapter, cached_offset):
        inserts.append({"prompt_len": len(prompt), "cached_offset": cached_offset,
                        "read_blocks": None, "readback_ms": 0.0})
        t0 = time.perf_counter()
        insert_prompt_kv(slot, prompt, adapter, cached_offset)
        rec = inserts[-1]
        rec["total_ms"] = (time.perf_counter() - t0) * 1e3
        rec["pool_ms"] = rec["total_ms"] - rec["readback_ms"]

    eng._insert_prompt_kv, eng._read_kv_blocks = timed_insert_prompt_kv, timed_read_kv_blocks
    cache.insert_missing = counted_insert_missing
    try:
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        cold_res = _serve_engine(eng, [cold], max_tokens, "cold")
        launches_cold = dict(LAUNCHES)
        cold_prefill = dict(eng.last_prefill)
        cold_stats = cache.stats()
        cold_slot = next(e[3]["slot"] for e in _events(eng, "cold-0") if e[0] == "admitted")
        with torch.inference_mode():
            cold_rows = [torch.stack([ck[cold_slot, :prefix_len], cv[cold_slot, :prefix_len]])
                         for ck, cv in eng._caches]
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        t0 = time.time()
        hits = _serve_engine(eng, prompts, max_tokens, "hit")
        hits_wall = time.time() - t0
        launches_hits = dict(LAUNCHES)
        hit_prefill = dict(eng.last_prefill)
        stats = cache.stats()
        rows_equal, hit_offsets, attach_attrs = [], [], []
        with torch.inference_mode():
            for r in hits:
                ev = _events(eng, r["rid"])
                slot = next(e[3]["slot"] for e in ev if e[0] == "admitted")
                attach_attrs.append(next((e[3] for e in ev if e[0] == "cache-attach"), None))
                hit_offsets.append(next(e[3]["offset"] for e in ev if e[0] == "prefill-chunk"))
                rows_equal.append(all(
                    torch.equal(torch.stack([ck[slot, :prefix_len], cv[slot, :prefix_len]]), ref)
                    for (ck, cv), ref in zip(eng._caches, cold_rows)))
        del cold_rows
    finally:
        eng.shutdown()
    leases_active = cache.stats()["leases_active"]
    recorder = eng.recorder_stats()
    del eng
    _empty_cache(device)

    plain = DecodeEngine(cfg, params, num_slots=4, max_seq=max_seq, seed=seed,
                         prefix_cache=False, device=device)
    try:
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        t0 = time.time()
        misses = _serve_engine(plain, prompts, max_tokens, "plain")
        misses_wall = time.time() - t0
        launches_plain = dict(LAUNCHES)
        exact, total, worst_gap = _teacher_forced(plain, prompts,
                                                  [r["token_ids"] for r in hits])
    finally:
        plain.shutdown()
    del plain
    _empty_cache(device)

    same = sum(int(a == b) for r, m in zip(hits, misses)
               for a, b in zip(r["token_ids"], m["token_ids"]))
    attach_ms = [r["timing"]["phases"]["cache-attach"]["seconds"] * 1e3
                 if r["timing"] and "cache-attach" in r["timing"]["phases"] else None
                 for r in hits]
    rec = {
        "phase": "prefix", "model": name, "num_slots": 4, "max_seq": max_seq,
        "block_size": bs, "block_mib": block_bytes / 2**20, "capacity_blocks":
            (1 << 30) // block_bytes, "prefix_tokens": prefix_len,
        "suffix_tokens": list(suffixes), "cold_suffix_tokens": cold_suffix,
        "max_tokens": max_tokens,
        "cold": cold_res[0], "hits": hits, "no_cache": misses,
        "hits_wall_s": hits_wall, "no_cache_wall_s": misses_wall,
        "ttft_hit_over_miss": [h["ttft_s"] / m["ttft_s"] for h, m in zip(hits, misses)],
        "ttft_hits_over_cold": [h["ttft_s"] / cold_res[0]["ttft_s"] for h in hits],
        "attach_ms": attach_ms, "attach_attrs": attach_attrs, "inserts": inserts,
        "cold_prefill": cold_prefill, "hit_prefill": hit_prefill,
        "hit_prefill_offsets": hit_offsets, "cold_prefix_cache_stats": cold_stats,
        "prefix_cache_stats": stats, "leases_active_at_end": leases_active,
        "recorder": recorder,
        "launches": {"cold": launches_cold, "hits": launches_hits, "no_cache": launches_plain},
        "attached_rows_equal_cold_rows": rows_equal,
        "teacher_forced_exact": exact, "teacher_forced_total": total,
        "worst_logit_gap": worst_gap, "margin": margin,
        "hit_tokens_equal_no_cache": same,
        "hit_tokens_total": sum(len(r["token_ids"]) for r in hits),
    }
    n_prefix_blocks = prefix_len // bs
    # Each insert reads back only the blocks the cache lacked: all of the
    # cold prompt's, and past the shared prefix for each hit.
    expected_reads = [(0, len(cold) // bs)] + [(n_prefix_blocks, len(p) // bs) for p in prompts]
    read_blocks_ok = (
        sorted(tuple(r["read_blocks"]) for r in inserts if r["read_blocks"])
        == sorted(r for r in expected_reads if r[1] > r[0]))
    rec["inserts_read_only_new_blocks"] = read_blocks_ok
    rec["ok"] = (
        cold_prefill["offset"] == 0
        and cold_stats["inserted_blocks"] == len(cold) // bs
        and launches_cold == {"flash_fwd": cfg.n_layers, "flash_bwd": 0}
        and launches_hits == {"flash_fwd": 0, "flash_bwd": 0}
        and launches_plain == {"flash_fwd": cfg.n_layers * len(prompts), "flash_bwd": 0}
        and hit_prefill["offset"] == prefix_len
        and hit_offsets == [prefix_len] * len(prompts)
        and all(a is not None and a["cached_tokens"] == prefix_len for a in attach_attrs)
        and stats["hits"] == len(prompts)
        and stats["hit_tokens"] == len(prompts) * prefix_len
        and stats["inserted_blocks"] == len(cold) // bs + sum(
            len(p) // bs - n_prefix_blocks for p in prompts)
        and read_blocks_ok
        and leases_active == 0 and recorder["live"] == 0
        and all(rows_equal) and len(rows_equal) == len(prompts)
        and worst_gap <= margin
        and all(len(r["token_ids"]) == max_tokens for r in (*cold_res, *hits, *misses))
        and all(r["timing"] is not None and "decode" in r["timing"]["phases"]
                for r in (*cold_res, *hits, *misses))
        and all(a is not None for a in attach_ms)
    )
    emit(rec)
    return rec


@contextlib.contextmanager
def _engine_flags(**flags):
    """The engine module's flag table (`ray_tpu_torch/_config.py`, frozen)
    with `flags` replaced while the block runs: how a deployment sets the
    `llm_kv_*` flags in process."""
    import dataclasses

    from ray_tpu_torch.llm import _engine as engine_mod

    saved = engine_mod.CONFIG
    engine_mod.CONFIG = dataclasses.replace(saved, **flags)
    try:
        yield
    finally:
        engine_mod.CONFIG = saved


def phase_tiers(cfg, params, margin: float, card: str, name: str = "llama3-8b",
                device: str = "cuda", seed: int = 6, prefix_len: int = 1024,
                suffix: int = 48, max_tokens: int = 16, max_seq: int = 2048,
                host_blocks: int = 80, device_blocks: int = 128,
                spill_blocks: int = 512) -> dict:
    """The tiered prefix cache on llama3-8b, over the serve phase's weights:
    an engine built from the tier flags (budgets in 16-row blocks, 2 MiB
    each at llama3-8b's width: a host pool of 80, 160 MiB, which holds one
    1,024-token prefix plus its suffix; a device tier of 128, 256 MiB; a
    spill directory under the temporary directory, capped at 512, 1 GiB,
    removed at the end) serves p_a cold, p_a from the host
    pool (promoting the chain to the card), p_a from the card, p_b cold
    (whose insert evicts p_a's tail and spills it), and, once the spills are
    written, p_a from disk (its head still resident: the tail comes back in
    bf16 and is stitched to it). Then an engine without a cache serves p_a.
    Gates: K1 32 launches per cold request and none on a hit; the attached
    rows of every hit equal the cold prefill's rows bit for bit; the device
    hit's rows were on the card (no H2D copy); the three hits' tokens equal
    and through the teacher-forced check; one hit from each tier; every
    pool block in the cache dtype after the disk promotion; no spill
    dropped; no lease left; the spill worker stopped at shutdown.
    Reported per tier: the attach ms (synchronized, from the lease's rows
    to the slot's), TTFT, the promotion ms (host to card, synchronized),
    the spill seconds and the disk promotion ms."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch.llm._engine import DecodeEngine
    from ray_tpu_torch.llm.kvcache import TieredPrefixCacheManager
    from ray_tpu_torch.ops.attention import LAUNCHES

    rng = np.random.default_rng(seed)
    p_a = rng.integers(0, cfg.vocab_size, prefix_len + suffix).tolist()
    p_b = rng.integers(0, cfg.vocab_size, prefix_len + suffix).tolist()
    bs = 16
    block_bytes = cfg.n_layers * 2 * bs * cfg.n_kv_heads * cfg.head_dim * cfg.dtype.itemsize
    matched = (len(p_a) - 1) // bs * bs  # a hit's rows: the lookup leaves a token
    spill_dir = tempfile.mkdtemp(prefix="chip_smoke_kv_spill_")
    with _engine_flags(llm_kv_block_size=bs, llm_prefix_cache_bytes=host_blocks * block_bytes,
                       llm_kv_device_bytes=device_blocks * block_bytes,
                       llm_kv_spill_dir=spill_dir, llm_kv_spill_bytes=spill_blocks * block_bytes):
        eng = DecodeEngine(cfg, params, num_slots=4, max_seq=max_seq, seed=seed,
                           device=device)
    cache = eng._prefix_cache
    if not isinstance(cache, TieredPrefixCacheManager):
        eng.shutdown()
        raise RuntimeError(f"the tier flags built {type(cache).__name__}")
    timings = {"attach": [], "promote_device": [], "promote_disk": []}
    queued_at, written_at = [], []
    leased_kv, attach_kv = eng._leased_kv, eng._attach_kv
    promote_to_device, promote_from_disk = cache._promote_to_device, cache._promote_from_disk
    enqueue_spill, disk_put, disk_get = cache._enqueue_spill, cache._disk.put, cache._disk.get
    cache_insert = cache.insert
    split = {"read_ms": 0.0, "insert_ms": 0.0, "files": 0}

    def timed_leased_kv(lease):
        _sync(device)
        timings["attach"].append({"t0": time.perf_counter()})
        kv, tier = leased_kv(lease)
        timings["attach"][-1].update(tier=tier, rows_on_card=kv.is_cuda, rows=kv.shape[2])
        return kv, tier

    def timed_attach_kv(slot, kv):
        attach_kv(slot, kv)
        _sync(device)  # the rows have landed
        rec = timings["attach"][-1]
        rec["ms"] = (time.perf_counter() - rec.pop("t0")) * 1e3

    def timed_promote_to_device(block_ids):
        _sync(device)
        t0 = time.perf_counter()
        promote_to_device(block_ids)
        _sync(device)
        timings["promote_device"].append({"blocks": len(block_ids),
                                          "ms": (time.perf_counter() - t0) * 1e3})

    def timed_promote_from_disk(token_ids, namespace):
        with cache._lock:
            head = len(cache._radix.match(token_ids, namespace))
        split.update(read_ms=0.0, insert_ms=0.0, files=0)
        t0 = time.perf_counter()
        added = promote_from_disk(token_ids, namespace)
        if added:
            # The rest of the ms is the concatenation of head and tail.
            timings["promote_disk"].append({"head_blocks": head, "blocks": added,
                                            "ms": (time.perf_counter() - t0) * 1e3,
                                            **split})
        return added

    def timed_disk_get(key):
        t0 = time.perf_counter()
        kv = disk_get(key)
        split["read_ms"] += (time.perf_counter() - t0) * 1e3
        split["files"] += kv is not None
        return kv

    def timed_insert(token_ids, kv, namespace=0):
        t0 = time.perf_counter()
        added = cache_insert(token_ids, kv, namespace)
        split["insert_ms"] += (time.perf_counter() - t0) * 1e3
        return added

    def timed_enqueue_spill(key, kv):
        queued_at.append(time.perf_counter())
        enqueue_spill(key, kv)

    def timed_disk_put(key, kv):
        written = disk_put(key, kv)
        written_at.append(time.perf_counter())
        return written

    eng._leased_kv, eng._attach_kv = timed_leased_kv, timed_attach_kv
    cache._promote_to_device = timed_promote_to_device
    cache._promote_from_disk = timed_promote_from_disk
    cache._enqueue_spill, cache._disk.put = timed_enqueue_spill, timed_disk_put
    cache._disk.get, cache.insert = timed_disk_get, timed_insert
    runs, launches, rows_equal, tiers_seen = {}, {}, {}, {}
    spill = {}
    try:
        for tag, prompt in (("cold", p_a), ("host", p_a), ("device", p_a), ("evict", p_b),
                            ("disk", p_a)):
            if tag == "disk":
                # Every block p_b's insert evicted is on disk before p_a's
                # next lookup; the wait is bounded.
                want = cache.stats()["evicted_blocks"]
                t_wait = time.perf_counter()
                while (cache.stats()["tiers"]["spills"] < want
                       and time.perf_counter() - t_wait < 120):
                    time.sleep(0.005)
                tiers_now = cache.stats()["tiers"]
                # From the first eviction's queue put to the last commit
                # (tmp write, fsync, rename), on the spill worker.
                seconds = max(written_at) - min(queued_at) if written_at else None
                spill = {"evicted_blocks": want, "spills": tiers_now["spills"],
                         "spill_mib": tiers_now["spill_bytes"] / 2**20, "seconds": seconds,
                         "mib_per_s": (tiers_now["spill_bytes"] / 2**20 / seconds
                                       if seconds else None),
                         "wait_after_request_s": time.perf_counter() - t_wait,
                         "disk_mib": tiers_now["disk_bytes"] / 2**20}
            LAUNCHES.update(flash_fwd=0, flash_bwd=0)
            runs[tag] = _serve_engine(eng, [prompt], max_tokens, f"tiers-{tag}")[0]
            launches[tag] = dict(LAUNCHES)
            tiers_seen[tag] = (eng.last_attach or {}).get("tier") if tag in (
                "host", "device", "disk") else None
            slot = next(e[3]["slot"] for e in _events(eng, f"tiers-{tag}-0")
                        if e[0] == "admitted")
            with torch.inference_mode():
                rows = [torch.stack([ck[slot, :matched], cv[slot, :matched]])
                        for ck, cv in eng._caches]
            if tag == "cold":
                cold_rows = rows
            elif tag != "evict":
                rows_equal[tag] = all(torch.equal(a, b) for a, b in zip(rows, cold_rows))
            del rows
        del cold_rows
        pool_dtypes = sorted({str(b.kv.dtype) for b in cache._pool._blocks.values()})
        stats = cache.stats()
        spans = [e[3].get("tier") for tag in ("host", "device", "disk")
                 for e in _events(eng, f"tiers-{tag}-0") if e[0] == "cache-attach"]
        worker = cache._spill_thread
    finally:
        eng.shutdown()
        shutil.rmtree(spill_dir, ignore_errors=True)
    worker_stopped = (worker is None or not worker.is_alive()) and cache._spill_thread is None
    leases_active = cache.stats()["leases_active"]
    del eng, cache
    _empty_cache(device)

    plain = DecodeEngine(cfg, params, num_slots=4, max_seq=max_seq, seed=seed,
                         prefix_cache=False, device=device)
    try:
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        no_cache = _serve_engine(plain, [p_a], max_tokens, "tiers-plain")[0]
        launches["no_cache"] = dict(LAUNCHES)
        hits = [runs[t]["token_ids"] for t in ("host", "device", "disk")]
        exact, total, worst_gap = _teacher_forced(plain, [p_a] * 3, hits)
    finally:
        plain.shutdown()
    del plain
    _empty_cache(device)

    attach = {t["tier"]: t for t in timings["attach"]}
    rec = {
        "phase": "tiers", "model": name, "card": card, "num_slots": 4, "max_seq": max_seq,
        "block_size": bs, "block_mib": block_bytes / 2**20,
        "host_mib": host_blocks * block_bytes / 2**20,
        "device_mib": device_blocks * block_bytes / 2**20,
        "spill_cap_mib": spill_blocks * block_bytes / 2**20,
        "prompt_tokens": len(p_a), "hit_tokens": matched, "max_tokens": max_tokens,
        "ttft_s": {t: r["ttft_s"] for t, r in runs.items()},
        "tpot_s": {t: r["tpot_s"] for t, r in runs.items()},
        "no_cache_ttft_s": no_cache["ttft_s"],
        "attach": timings["attach"], "promote_device": timings["promote_device"],
        "promote_disk": timings["promote_disk"], "spill": spill,
        "last_attach_tiers": tiers_seen, "cache_attach_span_tiers": spans,
        "attached_rows_equal_cold_rows": rows_equal, "pool_dtypes": pool_dtypes,
        "prefix_cache_stats": stats, "leases_active_at_end": leases_active,
        "spill_worker_stopped": worker_stopped,
        "hit_tokens_equal": hits[0] == hits[1] == hits[2],
        "hit_tokens_equal_no_cache": sum(int(a == b) for a, b in
                                         zip(hits[0], no_cache["token_ids"])),
        "cold_tokens_equal_hits": runs["cold"]["token_ids"] == hits[0],
        "teacher_forced_exact": exact, "teacher_forced_total": total,
        "worst_logit_gap": worst_gap, "margin": margin,
        "launches": launches,
    }
    cold_k1 = {"flash_fwd": cfg.n_layers, "flash_bwd": 0}
    tiers = stats["tiers"]
    rec["ok"] = (
        launches["cold"] == launches["evict"] == launches["no_cache"] == cold_k1
        and all(launches[t] == {"flash_fwd": 0, "flash_bwd": 0}
                for t in ("host", "device", "disk"))
        and tiers_seen == {"cold": None, "host": "host", "device": "device",
                           "evict": None, "disk": "disk"}
        and spans == ["host", "device", "disk"]
        and rows_equal == {"host": True, "device": True, "disk": True}
        and attach.get("device", {}).get("rows_on_card") is True
        and all(a["rows"] == matched for a in timings["attach"])
        and tiers["hits_device"] == 1 and tiers["hits_disk"] == 1
        and tiers["hits_host"] == 1 and tiers["spill_drops"] == 0
        and spill.get("spills", 0) >= spill.get("evicted_blocks", 1) > 0
        and len(timings["promote_disk"]) == 1 and timings["promote_disk"][0]["head_blocks"] > 0
        and pool_dtypes == [str(cfg.dtype)]
        and rec["hit_tokens_equal"] and worst_gap <= margin
        and all(len(r["token_ids"]) == max_tokens for r in (*runs.values(), no_cache))
        and leases_active == 0 and worker_stopped
    )
    emit(rec)
    return rec


def _smoke_tokenizer():
    """ByteTokenizer's bytes for ids < 256, so guided specs mask as they do
    under the default tokenizer, and every other id rendered as "<id>", so
    the text of random weights (ids up to 128,255) shows every token."""
    from ray_tpu_torch.llm import ByteTokenizer

    class IdTokenizer(ByteTokenizer):
        def decode(self, ids):
            out, run = [], []
            for i in ids:
                if 0 <= i < 256:
                    run.append(i)
                elif i >= 256:
                    out.append(super().decode(run))
                    out.append(f"<{i}>")
                    run = []
            return "".join(out) + super().decode(run)

    return IdTokenizer()


def _guided_server(name: str = "llama3-8b", device: str = "cuda", max_seq: int = 2048,
                   seed: int = 1):
    """LLMServer over the serve phase's weights (its config and seed make
    them again) with `_smoke_tokenizer`; the guided and stream phases share
    it, the spec phase takes its weights."""
    from ray_tpu_torch.llm import LLMConfig, LLMServer

    return LLMServer(LLMConfig(model_id=name, num_slots=4, max_seq=max_seq, seed=seed,
                               device=device, tokenizer=_smoke_tokenizer()))


def _mask_walk(begin, answer, max_tokens) -> tuple:
    """The host masks the engine added before each token of a guided answer
    ([len(answer), V]), replayed on a new state from `begin` (a compiled
    constraint's), and the host ms per mask call."""
    import numpy as np

    state = begin("replay")
    rows, ms = [], []
    for j, token in enumerate(answer):
        t0 = time.perf_counter()
        rows.append(state.mask(None, budget=max_tokens - j))
        ms.append((time.perf_counter() - t0) * 1e3)
        state.advance(token)
    state.release()
    return np.stack(rows), ms


def _fingerprint(params) -> list:
    """Exact sums (f64) of two of a param tree's tensors: equal trees made
    from one seed give equal fingerprints."""
    return [float(params["embedding"].double().sum()),
            float(params["layer_0"]["attn"]["q"]["kernel"].double().sum())]


def phase_guided(server, margin: float, name: str = "llama3-8b", seed: int = 3,
                 lengths=(40, 60, 80, 100), plain_tokens: int = 32, pairs: int = 2,
                 serve_fingerprint=None) -> dict:
    """Guided decoding through LLMServer.generate(guided=...): a regex, a
    JSON schema and a grammar side by side with an unguided request, then
    the same 4 prompts unguided. Gates: the regex's text fullmatches it, the
    schema's parses with its keys and types, the grammar's fullmatches its
    lowered regex; every guided token is the argmax of the teacher-forced
    logits plus the replayed host mask, or within `margin` of it (every
    unguided token without a mask); K1 launches once per layer per
    admitted prompt; every ConstraintState begun is released; a constraint
    compiled for another logits width raises at submit; the server's
    weights are the serve phase's (`serve_fingerprint`, when it ran).
    Reported: each
    spec's compile ms at the model's vocab, the host mask's ms per token
    (cached rows, and a new compile's first walk), TTFT/TPOT per request,
    and the unguided request's TPOT beside guided slots (multi-step off for
    the batch) and without them: `pairs` times a mixed batch, then a control
    batch that differs only in its masks (new prompts of the same lengths,
    so neither batch hits the prefix cache, and each guided request
    replaced by an unguided one with the token budget it used)."""
    import numpy as np

    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.generate import compile_constraint, grammar_to_regex
    from ray_tpu_torch.ops.attention import LAUNCHES

    eng, cfg = server._engine, server._cfg
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    compile_ms, states, originals = {}, [], {}
    for key, (spec, _) in GUIDED_SPECS.items():
        t0 = time.perf_counter()
        constraint = server._constraints.get(spec)  # compiles, then cached
        compile_ms[key] = (time.perf_counter() - t0) * 1e3
        originals[key] = begin = constraint.begin

        def recording_begin(request_id="", begin=begin):
            states.append(begin(request_id))
            return states[-1]

        constraint.begin = recording_begin

    def batch(batch_prompts, budgets, guided: bool) -> tuple:
        """(replies, prefix-cache hit tokens) of the 3 guided (or unguided)
        requests with these budgets and one unguided request, at once."""
        async def calls():
            return await asyncio.gather(*(
                server.generate(p, max_tokens=n, guided=GUIDED_SPECS[key][0] if guided else None)
                for key, p, n in zip(GUIDED_SPECS, batch_prompts, budgets)),
                server.generate(batch_prompts[-1], max_tokens=plain_tokens))

        hits0 = eng.prefix_cache_stats()["hit_tokens"]
        replies = asyncio.run(calls())
        return replies, eng.prefix_cache_stats()["hit_tokens"] - hits0

    guided_budgets = [n for _, n in GUIDED_SPECS.values()]
    asyncio.run(server.generate(prompts[0][:8], max_tokens=2))  # warm-up
    LAUNCHES.update(flash_fwd=0, flash_bwd=0)
    t0 = time.time()
    mixed, mixed_hits = batch(prompts, guided_budgets, True)
    mixed_wall = time.time() - t0
    launches = dict(LAUNCHES)
    tpot_pairs = []
    for pair in range(pairs):
        m, m_hits = ((mixed, mixed_hits) if pair == 0 else
                     batch([rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths],
                           guided_budgets, True))
        budgets = [len(r["token_ids"]) for r in m[:len(GUIDED_SPECS)]]
        c, c_hits = batch([rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths],
                          budgets, False)
        tpot_pairs.append({
            "beside_guided_s": m[-1]["timing"]["tpot_s"],
            "without_guided_s": c[-1]["timing"]["tpot_s"],
            "ratio": m[-1]["timing"]["tpot_s"] / c[-1]["timing"]["tpot_s"],
            "budgets": budgets, "control_tokens": [len(r["token_ids"]) for r in c],
            "hit_tokens": [m_hits, c_hits],
            "same_makeup": ([len(r["token_ids"]) for r in c] == budgets + [plain_tokens]
                            and len(m[-1]["token_ids"]) == plain_tokens
                            and m_hits == c_hits == 0),
            "timed": all(r["timing"] is not None for r in (*m, *c))})

    texts = {key: r["text"] for key, r in zip(GUIDED_SPECS, mixed)}
    valid = {"regex": re.fullmatch(GUIDED_SPECS["regex"][0], texts["regex"]) is not None,
             "grammar": re.fullmatch(grammar_to_regex(GUIDED_SPECS["grammar"][0]["grammar"]),
                                     texts["grammar"]) is not None}
    try:
        obj = json.loads(texts["schema"])
        valid["schema"] = (set(obj) == {"ok", "n"} and isinstance(obj["ok"], bool)
                           and isinstance(obj["n"], int) and not isinstance(obj["n"], bool))
    except (ValueError, TypeError):
        valid["schema"] = False

    masks, mask_ms, cold_ms = [], [], []
    for key, r in zip(GUIDED_SPECS, mixed):
        spec, max_tokens = GUIDED_SPECS[key]
        rows, ms = _mask_walk(originals[key], r["token_ids"], max_tokens)
        masks.append(rows)
        mask_ms.extend(ms)
        cold = compile_constraint(spec, server._tokenizer, cfg.vocab_size)
        cold_ms.extend(_mask_walk(cold.begin, r["token_ids"], max_tokens)[1])
    masks.append(None)
    wrong_width = compile_constraint(GUIDED_SPECS["regex"][0], server._tokenizer,
                                     cfg.vocab_size + 64)
    try:
        eng.submit(prompts[0], SamplingParams(max_tokens=2), lambda t, f: None,
                   constraint=wrong_width)
        wrong_width_raises = False
    except ValueError:
        wrong_width_raises = True
    exact, total, worst_gap = _teacher_forced(
        eng, prompts + [prompts[-1]], [r["token_ids"] for r in mixed], masks)

    def brief(r):
        t = r["timing"]
        return {"tokens": len(r["token_ids"]), "text": r["text"][:200], "ttft_s": r["ttft_s"],
                "tpot_s": t["tpot_s"] if t else None, "latency_s": r["latency_s"]}

    rec = {
        "phase": "guided", "model": name,
        "vocab": cfg.vocab_size, "prompt_lengths": list(lengths),
        "compile_ms": compile_ms,
        "mask_ms_per_token": {"cached_median": statistics.median(mask_ms),
                              "cached_max": max(mask_ms),
                              "first_walk_median": statistics.median(cold_ms),
                              "first_walk_max": max(cold_ms)},
        "mixed": {key: brief(r) for key, r in zip([*GUIDED_SPECS, "unguided"], mixed)},
        "tpot_unguided_beside_and_without_guided": tpot_pairs,
        "mixed_wall_s": mixed_wall, "valid": valid,
        "launches": launches,
        "launches_expected": {"flash_fwd": cfg.n_layers * len(mixed), "flash_bwd": 0},
        "states_begun": len(states), "states_released": sum(st.released for st in states),
        "wrong_width_raises": wrong_width_raises,
        "weights_equal_serve": (None if serve_fingerprint is None
                                else _fingerprint(eng.params) == serve_fingerprint),
        "teacher_forced_exact": exact, "teacher_forced_total": total,
        "worst_logit_gap": worst_gap, "margin": margin,
    }
    rec["ok"] = (all(valid.values()) and worst_gap <= margin and wrong_width_raises
                 and rec["weights_equal_serve"] is not False
                 and launches == rec["launches_expected"]
                 and len(states) == len(GUIDED_SPECS) * pairs
                 and all(st.released for st in states)
                 and all(pr["same_makeup"] and pr["timed"] for pr in tpot_pairs))
    for key, begin in originals.items():
        server._constraints.get(GUIDED_SPECS[key][0]).begin = begin
    emit(rec)
    return rec


def phase_stream(server, seed: int = 4, prompt_len: int = 16, max_tokens: int = 32) -> dict:
    """Token streams on the guided phase's server, on a prompt of one
    16-token block, which the prefix cache never serves (a lookup leaves at
    least the last token to prefill), so every admission takes the same
    route (K1 over its first chunk): generate_stream's text
    (every id rendered by `_smoke_tokenizer`) equals generate's for the same
    greedy prompt, and DecodeEngine.open_stream's tokens equal generate's
    ids; then a guided stream of up to 300 digits is closed after 3 deltas:
    its slot must be free within one scheduler iteration (at most one
    iteration planned, `scheduler_stats()["iterations"]`, between the
    engine's receipt of the cancel and the slot found free), its record
    cancelled, its ConstraintState released and no record left live.
    Reported: cancel-to-free ms from aclose(), split at the engine's
    receipt of the cancel, beside the median gap between the stream's
    tokens, and the tokens decoded after the close. K1 launches once per
    layer per admitted prompt (4)."""
    import numpy as np

    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.ops.attention import LAUNCHES

    eng, cfg = server._engine, server._cfg
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, prompt_len).tolist()
    close_spec = {"regex": "[0-9]{300}"}
    constraint = server._constraints.get(close_spec)
    begun = []
    begin = constraint.begin

    def recording_begin(request_id=""):
        begun.append(begin(request_id))
        return begun[-1]

    constraint.begin = recording_begin
    cancels = []
    cancel = eng.cancel

    def recording_cancel(request_id):
        cancels.append({"rid": request_id, "t": time.perf_counter(),
                        "iterations": eng.scheduler_stats()["iterations"]})
        return cancel(request_id)

    eng.cancel = recording_cancel

    async def scenario():
        whole = await server.generate(prompt, max_tokens=max_tokens)
        streamed = [d async for d in server.generate_stream(prompt, max_tokens=max_tokens)]
        gen = server.generate_stream(prompt, max_tokens=300, guided=close_spec,
                                     request_id="stream-close")
        parts, times = [], []
        for _ in range(3):
            parts.append(await gen.__anext__())
            times.append(time.perf_counter())
        t0 = time.perf_counter()
        await gen.aclose()  # the client went away
        while any(s.active for s in eng._sched.slots) and time.perf_counter() - t0 < 30:
            await asyncio.sleep(0.0005)
        t_free = time.perf_counter()
        return (whole, streamed, parts, times, t0, t_free,
                eng.scheduler_stats()["iterations"])

    LAUNCHES.update(flash_fwd=0, flash_bwd=0)
    try:
        whole, streamed, parts, times, t0, t_free, iterations_free = asyncio.run(scenario())
    finally:
        del eng.cancel
    opened = list(eng.open_stream(prompt, SamplingParams(max_tokens=max_tokens)))
    launches = dict(LAUNCHES)
    constraint.begin = begin
    timing = eng.request_timing("stream-close")
    gaps = [b - a for a, b in zip(times, times[1:])]
    step_ms = statistics.median(gaps) * 1e3 if gaps else None
    stats = eng.recorder_stats()
    closing = next((c for c in cancels if c["rid"] == "stream-close"), None)
    iterations_to_free = None if closing is None else iterations_free - closing["iterations"]
    rec = {
        "phase": "stream", "prompt_len": prompt_len, "max_tokens": max_tokens,
        "generate_tokens": whole["token_ids"], "stream_text_equal": "".join(streamed) == whole["text"],
        "open_stream_equal": opened == whole["token_ids"],
        "stream_deltas": len(streamed), "closed_after": parts,
        "cancel_to_free_ms": (t_free - t0) * 1e3,
        "aclose_to_cancel_ms": None if closing is None else (closing["t"] - t0) * 1e3,
        "cancel_to_free_engine_ms": None if closing is None else (t_free - closing["t"]) * 1e3,
        "iterations_cancel_to_free": iterations_to_free,
        "stream_token_gaps_ms": [g * 1e3 for g in gaps], "stream_token_gap_ms": step_ms,
        "closed_record_tokens": timing["tokens"] if timing else None,
        "closed_state_released": bool(begun) and all(st.released for st in begun),
        "recorder": stats, "launches": launches,
        "launches_expected": {"flash_fwd": cfg.n_layers * 4, "flash_bwd": 0},
    }
    rec["ok"] = (rec["stream_text_equal"] and rec["open_stream_equal"]
                 and len(whole["token_ids"]) == max_tokens
                 and all(p.isdigit() for p in parts)
                 and not any(s.active for s in eng._sched.slots)
                 and iterations_to_free is not None and iterations_to_free <= 1
                 and rec["closed_state_released"] and len(begun) == 1
                 and stats["live"] == 0 and stats["cancelled"] >= 1
                 and launches == rec["launches_expected"])
    emit(rec)
    return rec


def phase_spec(cfg, params, margin: float, name: str = "llama3-8b", device: str = "cuda",
               lengths=(20, 100, 255, 300), seed: int = 1, max_tokens: int = 32,
               max_seq: int = 2048) -> dict:
    """Speculative decoding on the serve phase's weights and prompts (4 at
    once, greedy, 32 tokens, no prefix cache so K1's counts are exact): a
    plain engine, then one engine per draft of SPEC_DRAFTS: ngram (k 6) over
    the prompts twice (repeated traffic: the second pass is proposed from
    the first's continuations), the early-exit head of 8 layers (k 4) and
    the self-draft (k 4). Gates: every served token passes the teacher-forced
    check; K1 launches 32 per admitted prompt's first chunk plus the draft's
    layers per admission (its whole-prompt prefill; 0 for ngram); ngram's
    second pass and the self-draft accept proposals. Reported per run:
    TTFT, TPOT, output tokens/s, acceptance, tokens emitted per verify
    round and per slot-round, the verify round's and the draft's propose
    ms, where each sequence first leaves the plain engine's and the
    teacher-forced logits of both tokens there, and which runs served
    the same tokens."""
    import numpy as np

    from ray_tpu_torch.llm._engine import DecodeEngine
    from ray_tpu_torch.ops.attention import LAUNCHES

    rng = np.random.default_rng(seed)  # the serve phase's prompts
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]

    def run(tag, eng):
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        t0 = time.time()
        res = _serve_engine(eng, prompts, max_tokens, tag)
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        exact, total, gap = _teacher_forced(eng, prompts, [r["token_ids"] for r in res])
        n = [len(r["token_ids"]) for r in res]
        return {"wall_s": wall, "output_tokens_per_s": sum(n) / wall,
                "ttft_s": [r["ttft_s"] for r in res], "tpot_s": [r["tpot_s"] for r in res],
                "tokens": [r["token_ids"] for r in res],
                "slot_rounds": sum((r["timing"] or {}).get("phases", {}).get(
                    "spec-verify", {}).get("count", 0) for r in res),
                "launches": launches, "teacher_forced_exact": exact,
                "teacher_forced_total": total, "worst_logit_gap": gap,
                "ok": all(k == max_tokens for k in n) and gap <= margin}

    kw = dict(num_slots=4, max_seq=max_seq, seed=seed, prefix_cache=False, device=device)
    plain = DecodeEngine(cfg, params, **kw)
    try:
        runs = {"plain": run("plain", plain)}
    finally:
        plain.shutdown()
    runs["plain"]["launches_expected"] = {"flash_fwd": cfg.n_layers * len(prompts),
                                          "flash_bwd": 0}
    del plain
    gc.collect()
    _empty_cache(device)
    for draft_name, spec_config, passes in SPEC_DRAFTS:
        eng = DecodeEngine(cfg, params, spec_config=spec_config, **kw)
        draft = eng._draft
        layers = getattr(draft, "cfg", None)
        layers = layers.n_layers if layers is not None else 0
        rounds_ms, propose_ms = [], []
        spec_round, propose = eng._spec_round, draft.propose

        def timed_round(plan, spec_round=spec_round, rounds_ms=rounds_ms):
            t0 = time.perf_counter()
            spec_round(plan)  # ends in the acceptance pull: synchronized
            rounds_ms.append((time.perf_counter() - t0) * 1e3)

        def timed_propose(i, slot, propose=propose, propose_ms=propose_ms):
            t0 = time.perf_counter()
            out = propose(i, slot)  # a model draft ends in its proposal pull
            propose_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        eng._spec_round, draft.propose = timed_round, timed_propose
        try:
            for p in range(passes):
                before = dict(eng._spec_counters)
                n_rounds, n_proposes = len(rounds_ms), len(propose_ms)
                r = run(f"{draft_name}-{p}", eng)
                c = {k: eng._spec_counters[k] - before[k] for k in before}
                r.update(
                    spec=c, accept_rate=c["accepted_tokens"] / max(1, c["proposed_tokens"]),
                    emitted_per_round=c["emitted_tokens"] / max(1, c["rounds"]),
                    emitted_per_slot_round=c["emitted_tokens"] / max(1, r["slot_rounds"]),
                    verify_round_ms_median=statistics.median(rounds_ms[n_rounds:])
                    if len(rounds_ms) > n_rounds else None,
                    propose_ms_median=statistics.median(propose_ms[n_proposes:])
                    if len(propose_ms) > n_proposes else None,
                    propose_ms_per_round=sum(propose_ms[n_proposes:]) / max(1, c["rounds"]),
                    draft_layers=layers,
                    launches_expected={"flash_fwd": (cfg.n_layers + layers) * len(prompts),
                                       "flash_bwd": 0},
                    tokens_equal_plain=sum(int(a == b) for x, y in zip(
                        r["tokens"], runs["plain"]["tokens"]) for a, b in zip(x, y)),
                    first_divergence=_divergence(eng, prompts, runs["plain"]["tokens"],
                                                 r["tokens"]))
                runs[f"{draft_name}_pass{p + 1}" if passes > 1 else draft_name] = r
            stats = eng.scheduler_stats()["spec"]
        finally:
            eng.shutdown()
        runs[draft_name if passes == 1 else f"{draft_name}_pass{passes}"]["scheduler_stats"] = stats
        del eng, draft, spec_round, propose
        gc.collect()
        _empty_cache(device)
    for r in runs.values():
        r["ok"] = r["ok"] and r["launches"] == r["launches_expected"]
    groups: dict = {}
    for key, r in runs.items():  # runs whose 128 tokens are the same
        groups.setdefault(json.dumps(r["tokens"]), []).append(key)
    rec = {"phase": "spec", "model": name, "prompt_lengths": list(lengths),
           "max_tokens": max_tokens, "margin": margin, "runs": runs,
           "identical_tokens": list(groups.values()),
           "launches": {k: r["launches"] for k, r in runs.items()}}
    rec["ok"] = (all(r["ok"] for r in runs.values())
                 and runs["ngram_pass2"]["spec"]["accepted_tokens"] > 0
                 and runs["self"]["spec"]["accepted_tokens"] > 0
                 and all(runs[k]["spec"]["rounds"] > 0 for k in
                         ("ngram_pass2", "layers8", "self")))
    emit(rec)
    return rec


def _lora_adapters(cfg, params, seed: int) -> tuple:
    """Random rank-16 q and v factors on every layer for each of LORA_NAMES,
    numpy f32 (what add_lora takes), B scaled so that ||s A B||_F is a draw
    from [5 %, 10 %] of the layer's ||W||_F per adapter, layer and
    projection (s = alpha / rank). Returns the adapters and the ratios,
    computed from the scaled factors (||A B||_F^2 = sum((A^T A) * (B B^T)))."""
    import numpy as np

    r = LORA_CONFIG["rank"]
    s = LORA_ALPHA / r
    rng = np.random.default_rng(seed)
    outs = {"q": cfg.n_heads * cfg.head_dim, "v": cfg.n_kv_heads * cfg.head_dim}
    wnorm = {(i, p): float(params[f"layer_{i}"]["attn"][p]["kernel"].double().norm())
             for i in range(cfg.n_layers) for p in outs}

    def norm_ab(A, B):
        return math.sqrt(float(((A.T.astype(np.float64) @ A)
                                * (B.astype(np.float64) @ B.T)).sum()))

    adapters, ratios = {}, []
    for name in LORA_NAMES:
        layers = {}
        for i in range(cfg.n_layers):
            w = {}
            for p, out in outs.items():
                A = rng.standard_normal((cfg.hidden, r), dtype=np.float32)
                B = rng.standard_normal((r, out), dtype=np.float32)
                B *= np.float32(rng.uniform(0.05, 0.10) * wnorm[(i, p)] / (s * norm_ab(A, B)))
                ratios.append(s * norm_ab(A, B) / wnorm[(i, p)])
                w[f"{p}_A"], w[f"{p}_B"] = A, B
            layers[i] = w
        adapters[name] = layers
    return adapters, ratios


def _merged_params(params, cfg, adapter, device):
    """The param tree with each layer's q and v kernels replaced by W + s A B,
    merged in f32 and cast to the kernel's dtype; every other tensor is
    shared (1.34 GB of new kernels at llama3-8b)."""
    import torch

    s = LORA_ALPHA / LORA_CONFIG["rank"]
    out = dict(params)
    for i, w in adapter.items():
        layer = dict(params[f"layer_{i}"])
        attn = dict(layer["attn"])
        for p in ("q", "v"):
            W = attn[p]["kernel"]
            A = torch.from_numpy(w[f"{p}_A"]).to(device)
            B = torch.from_numpy(w[f"{p}_B"]).to(device)
            merged = W.float().reshape(cfg.hidden, -1) + s * (A @ B)
            attn[p] = {**attn[p], "kernel": merged.to(W.dtype).reshape(W.shape)}
        layer["attn"] = attn
        out[f"layer_{i}"] = layer
    return out


def phase_lora(cfg, params, margin: float, card: str, name: str = "llama3-8b",
               device: str = "cuda", lengths=(20, 100, 255, 300), seed: int = 1,
               adapter_seed: int = 5, max_tokens: int = 32, max_seq: int = 2048,
               ttft_pairs: int = 3) -> dict:
    """Multi-LoRA serving on the serve phase's weights and prompts. Three
    rank-16 adapters on q and v of every layer go through an engine with 2
    device slots (LORA_CONFIG): a batch of base, a0, a1, a2 (greedy, 32
    tokens; one adapter request waits for a pin) and the same 4 in reverse
    order. An engine whose table holds every adapter (it never pages) serves
    the same two batches, then the 4 prompts as base requests; an engine
    without lora_config serves those base requests before and after. No
    prefix cache, so every admission is cold and K1's counts are exact.
    Admission is FIFO (wfq=False): weighted-fair admission orders tenants
    (here the adapters) by the service each has had and prefers resident
    adapters, so the two engines' histories would admit in other orders,
    and a prompt's chunks depend on what decodes when it is admitted (256
    rows when nothing does, else 128): the tokens of two schedules may then
    differ at a near-tie. One engine is alive at a time: an idle engine's
    stepper polls and takes the GIL from the one that serves.

    Gates: the base request's tokens (and the base batch on the LoRA
    engine) equal the engine without lora_config's bit for bit, as do a
    base prompt's logits, and row 0's delta is exactly zero; every adapter
    token of both LoRA engines passes the teacher-forced check against
    merged weights (W + s A B, merged in f32); the paged engine's tokens
    equal the unpaged engine's; K1 runs 32 times per admission; no pin is
    left, and the page-ins, evictions and hits are the ones the order
    implies; every cold request pages in once and its warm repeat not at
    all. Reported with the card: each page-in's ms on the stepper (the H2D
    copy and the install, synchronized), cold- against warm-adapter TTFT,
    the TPOT of the mixed batch against the same prompts as base requests
    on that engine and on the engine without lora_config, and the decode
    step's kernels with and without LoRA (`profile_engine`)."""
    import types

    import numpy as np
    import torch

    from ray_tpu_torch.llm._engine import DecodeEngine, _lora_delta
    from ray_tpu_torch.ops.attention import LAUNCHES

    rng = np.random.default_rng(seed)  # the serve phase's prompts
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    forward = list(zip(prompts, ["", *LORA_NAMES]))
    batches = {"mixed": forward, "reversed": forward[::-1],
               "base": [(p, "") for p in prompts]}
    t0 = time.time()
    adapters, ratios = _lora_adapters(cfg, params, adapter_seed)
    make_s = time.time() - t0

    def run(eng, tag, reqs):
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        t0 = time.time()
        res = _serve_engine(eng, [p for p, _ in reqs], max_tokens, tag,
                            loras=[lora for _, lora in reqs])
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        return {"loras": [lora for _, lora in reqs],
                "prompt_lengths": [len(p) for p, _ in reqs], "wall_s": wall,
                "ttft_s": [r["ttft_s"] for r in res], "tpot_s": [r["tpot_s"] for r in res],
                "tpot_s_median": statistics.median(r["tpot_s"] for r in res),
                "tokens": [r["token_ids"] for r in res], "launches": launches,
                "launches_expected": {"flash_fwd": cfg.n_layers * len(reqs), "flash_bwd": 0}}

    def by_request(r):
        return {(n, lora): t for n, lora, t in zip(r["prompt_lengths"], r["loras"], r["tokens"])}

    kw = dict(num_slots=4, max_seq=max_seq, seed=seed, prefix_cache=False, wfq=False,
              device=device)

    @contextlib.contextmanager
    def engine(lora_config):
        eng = DecodeEngine(cfg, params, lora_config=lora_config, **kw)
        try:
            for n, a in adapters.items() if lora_config else ():
                eng.add_lora(n, a, alpha=LORA_ALPHA)
            _serve_engine(eng, [prompts[0][:8]], 2, "lora-warmup")  # allocator, cuBLAS
            yield eng
        finally:
            eng.shutdown()

    padded = torch.zeros((1, 32), dtype=torch.long, device=device)
    padded[0, :len(prompts[0])] = torch.tensor(prompts[0], device=device)
    runs, page_ms, profile = {}, [], {}
    with engine(None) as bare, torch.inference_mode():
        runs["bare_base"] = run(bare, "lora-bare", batches["base"])
        bare_logits = bare._prefill_at(padded, 0, 0, len(prompts[0]))
        profile["bare"] = profile_engine(bare, K1_MAIN_SHAPE[0]) if device == "cuda" else None
    with engine(LORA_CONFIG) as paged:
        cache = paged._adapters
        page_in = cache._page_in_locked

        def timed_page_in(entry):
            t0 = time.perf_counter()
            slot = page_in(entry)
            _sync(device)  # the H2D copy and the install have landed
            page_ms.append((time.perf_counter() - t0) * 1e3)
            return slot

        cache._page_in_locked = timed_page_in
        blob_bytes = sum(v.nbytes for v in cache._registry[LORA_NAMES[0]].blob.values())
        for b in ("mixed", "reversed"):
            runs[f"paged_{b}"] = run(paged, f"lora-paged-{b}", batches[b])
        paged_stats = paged.adapter_stats()
        traffic_page_ms = list(page_ms)
        # Cold- against warm-adapter TTFT, one request at a time: an adapter
        # that is not resident, then the same request again.
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        pairs = []
        for j in range(ttft_pairs):
            cold = next(n for n in LORA_NAMES if n not in cache.resident_adapters())
            pair = []
            for k in range(2):
                n_page_ins = len(page_ms)
                res = _serve_engine(paged, [prompts[1]], 4, f"lora-ttft-{j}-{k}", loras=[cold])
                pair.append((res[0]["ttft_s"], len(page_ms) - n_page_ins))
            pairs.append({"adapter": cold, "cold_ttft_s": pair[0][0], "warm_ttft_s": pair[1][0],
                          "page_ins": [pair[0][1], pair[1][1]]})
        ttft_launches = dict(LAUNCHES)
        with torch.inference_mode():
            # Row 0 adds exactly nothing: the delta itself, and a base
            # prompt's logits against the engine without lora_config's.
            x = torch.randn(4, 8, cfg.hidden, device=device, dtype=cfg.dtype)
            ids = torch.zeros(4, dtype=torch.long, device=device)
            t = cache.tables()
            zero_delta = not bool(_lora_delta(x, t["q_A"][0][ids], t["q_B"][0][ids],
                                              t["scale"][0][ids]).any())
            base_logits_equal = torch.equal(
                paged._prefill_at(padded, 0, 0, len(prompts[0]), 0), bare_logits)
        del cache, page_in, timed_page_in
    with engine({**LORA_CONFIG, "cache_slots": LORA_CONFIG["max_loras"]}) as unpaged:
        for b in ("mixed", "reversed", "base"):
            runs[f"unpaged_{b}"] = run(unpaged, f"lora-unpaged-{b}", batches[b])
        unpaged_stats = unpaged.adapter_stats()
        profile["lora"] = (profile_engine(unpaged, K1_MAIN_SHAPE[0]) if device == "cuda"
                           else None)
    with engine(None) as bare:  # the engine without lora_config again, last
        runs["bare_base_again"] = run(bare, "lora-bare-again", batches["base"])
    del paged, unpaged, bare, bare_logits
    gc.collect()
    _empty_cache(device)

    # Adapter tokens against a teacher-forced forward over merged weights,
    # and where the paged and unpaged engines' tokens differ (if they do),
    # the merged forward's logits of both tokens there.
    tf, first_divergence = {}, {}
    paging_equal = {b: by_request(runs[f"paged_{b}"]) == by_request(runs[f"unpaged_{b}"])
                    for b in ("mixed", "reversed")}
    for lora in LORA_NAMES:
        ref = types.SimpleNamespace(cfg=cfg, device=torch.device(device),
                                    params=_merged_params(params, cfg, adapters[lora], device))
        for eng_name in ("paged", "unpaged"):
            ps, answers = [], []
            for b in ("mixed", "reversed"):
                r = runs[f"{eng_name}_{b}"]
                i = r["loras"].index(lora)
                ps.append(prompts[lengths.index(r["prompt_lengths"][i])])
                answers.append(r["tokens"][i])
            exact, total, gap = _teacher_forced(ref, ps, answers)
            tf[f"{eng_name}_{lora}"] = {"teacher_forced_exact": exact,
                                        "teacher_forced_total": total, "worst_logit_gap": gap}
        for b, equal in paging_equal.items():
            got, want = by_request(runs[f"paged_{b}"]), by_request(runs[f"unpaged_{b}"])
            n = lengths[LORA_NAMES.index(lora) + 1]
            if not equal and got[(n, lora)] != want[(n, lora)]:
                first_divergence[f"{b}:{lora}"] = _divergence(
                    ref, [prompts[lengths.index(n)]], [want[(n, lora)]], [got[(n, lora)]])[0]
        del ref
        gc.collect()
        _empty_cache(device)

    base_tokens = runs["bare_base"]["tokens"][0]
    base_equal = {key: by_request(r)[(lengths[0], "")] == base_tokens
                  for key, r in runs.items() if key != "bare_base"}
    base_batch_equal = (runs["unpaged_base"]["tokens"] == runs["bare_base"]["tokens"]
                        == runs["bare_base_again"]["tokens"])
    expected_stats = {"page_ins": 4, "evictions": 2, "misses": 4, "hits": 2}
    for r in runs.values():
        r["ok"] = (r["launches"] == r["launches_expected"]
                   and all(len(t) == max_tokens for t in r["tokens"]))
    ttft_expected = {"flash_fwd": cfg.n_layers * 2 * ttft_pairs, "flash_bwd": 0}
    rec = {
        "phase": "lora", "model": name, "lora_config": LORA_CONFIG, "alpha": LORA_ALPHA,
        "adapters": list(LORA_NAMES), "prompt_lengths": list(lengths),
        "max_tokens": max_tokens, "margin": margin, "adapter_make_s": make_s,
        "delta_over_weight_ratio": {"min": min(ratios), "median": statistics.median(ratios),
                                    "max": max(ratios)},
        "runs": runs, "teacher_forced": tf, "base_tokens_equal_bare": base_equal,
        "base_batch_equal_bare": base_batch_equal, "base_logits_equal_bare": base_logits_equal,
        "row0_delta_zero": zero_delta, "paged_tokens_equal_unpaged": paging_equal,
        "first_divergence": first_divergence,
        "adapter_stats_paged": paged_stats, "adapter_stats_unpaged": unpaged_stats,
        "launches": {**{k: r["launches"] for k, r in runs.items()}, "ttft": ttft_launches},
    }
    rec["ok"] = (all(r["ok"] for r in runs.values()) and all(base_equal.values())
                 and base_batch_equal and base_logits_equal and zero_delta
                 and all(paging_equal.values())
                 and all(v["worst_logit_gap"] <= margin for v in tf.values())
                 and paged_stats["pinned"] == 0 and paged_stats["resident"] <= 2
                 and paged_stats["rejected_full"] > 0
                 and all(paged_stats[k] == v for k, v in expected_stats.items())
                 and unpaged_stats["pinned"] == 0 and unpaged_stats["evictions"] == 0
                 and ttft_launches == ttft_expected
                 and all(p["page_ins"] == [1, 0] for p in pairs))
    emit(rec)
    emit({"phase": "lora_page_in", "card": card, "page_in_ms_traffic": traffic_page_ms,
          "page_in_ms_all": page_ms, "page_in_ms_median": statistics.median(page_ms),
          "h2d_mib_per_page_in": blob_bytes / 2**20})
    emit({"phase": "lora_ttft", "card": card, "pairs": pairs,
          "cold_ttft_s_median": statistics.median(p["cold_ttft_s"] for p in pairs),
          "warm_ttft_s_median": statistics.median(p["warm_ttft_s"] for p in pairs)})
    tpot = {k: r["tpot_s_median"] for k, r in runs.items()}
    bare_tpot = statistics.mean([tpot["bare_base"], tpot["bare_base_again"]])
    emit({"phase": "lora_tpot", "card": card, "tpot_s_median": tpot,
          "mixed_over_base_same_engine": tpot["unpaged_mixed"] / tpot["unpaged_base"],
          "mixed_over_bare": tpot["unpaged_mixed"] / bare_tpot,
          "lora_base_over_bare": tpot["unpaged_base"] / bare_tpot,
          "paged_over_unpaged": tpot["paged_mixed"] / tpot["unpaged_mixed"]})
    emit({"phase": "lora_kernels_per_step", "card": card, "profile": {
        k: p and {"decode_step": {f: p["decode_step"][f] for f in
                                  ("device_kernels", "wall_ms", "device_busy_ms", "idle_share")},
                  "prefill_chunk": {f: p["prefill_chunk"][f] for f in
                                    ("device_kernels", "wall_ms", "device_busy_ms", "bucket")}}
        for k, p in profile.items()}})
    return rec


def _pd_run(pre_out, dec, prompts, max_tokens: int, tag: str, form, device: str) -> dict:
    """The decode half of the PD pair: each detached prefill's kv put into
    the transfer form (`form`, timed and synchronized: the record's
    `pd-transfer` span), all of them before the first submit, so no copy
    runs beside an attach; then every request submitted to `dec` at once
    with its token ids; waits for all."""
    import threading

    from ray_tpu_torch.llm import SamplingParams

    payloads = []
    for _, kv, _ in pre_out:
        t0 = time.perf_counter()
        payload = form(kv)
        _sync(device)
        payloads.append((payload, time.perf_counter() - t0))
    runs = []
    for i, ((first, _, plen), (payload, transfer_s), p) in enumerate(
            zip(pre_out, payloads, prompts)):
        run = {"rid": f"{tag}-{i}", "tokens": [], "times": [], "done": threading.Event(),
               "transfer_ms": transfer_s * 1e3}

        def cb(token, last, run=run):
            run["times"].append(time.perf_counter())
            run["tokens"].append(token)
            if last:
                run["done"].set()

        run["t0"] = time.perf_counter()
        dec.submit_prefilled(payload, plen, first, SamplingParams(max_tokens=max_tokens), cb,
                             token_ids=p, request_id=run["rid"], transfer_s=transfer_s)
        runs.append(run)
    for run in runs:
        if not run["done"].wait(timeout=600):
            raise RuntimeError(f"request {run['rid']} did not finish: {dec.error}")
    attach = [next(a for n, _, _, a in _events(dec, r["rid"]) if n == "pd-attach") for r in runs]
    return {"tokens": [r["tokens"] for r in runs],
            "transfer_ms": [r["transfer_ms"] for r in runs],
            "ttft_s": [r["times"][0] - r["t0"] for r in runs],
            "tpot_s": [(r["times"][-1] - r["times"][0]) / max(1, len(r["times"]) - 1)
                       for r in runs],
            "on_device": [a["on_device"] for a in attach],
            "attach_buckets": [a["bucket"] for a in attach],
            "timing": [dec.request_timing(r["rid"]) for r in runs]}


def phase_pd(cfg, params, margin: float, card: str, name: str = "llama3-8b",
             device: str = "cuda", lengths=(20, 100, 255, 300), seed: int = 1,
             max_tokens: int = 32, max_seq: int = 2048) -> dict:
    """The PD handoff in process on the serve phase's weights and prompts:
    a prefill engine (no stepper, no slot taken) runs `prefill_detached` on
    each prompt, and a decode engine admits them from the transferred rows
    and first logits (`submit_prefilled`), three times: the rows as the
    host tensor prefill_detached returns, as f32 numpy, and as a CUDA
    tensor on the card. A mono engine serves the same 4 prompts first. All
    engines admit FIFO with no token budget (each prompt is one offset-0
    chunk, as the detached prefill is one offset-0 forward) and no prefix
    cache, so the two paths run the same K1 launches on the same inputs.

    Gates: each detached prompt's rows equal the mono engine's prefill rows
    bit for bit; every pair run's tokens equal the mono engine's (and pass
    the teacher-forced check); K1 runs 32 times per prompt on the mono
    engine and on the detached prefill, never on the decode engine; the
    prefill engine takes no slot and the decode engine runs no prefill
    chunk; the attach is on the device exactly for the CUDA form; every
    reply's timing has pd-transfer, pd-attach and decode. Reported with the
    card: each attach's ms on the stepper (synchronized) per form, the
    transfer form's ms, the detached prefill's ms (host clock, ending in its
    read-back) beside the mono engine's TTFT, and TPOT per run."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm._engine import DecodeEngine
    from ray_tpu_torch.ops.attention import LAUNCHES

    rng = np.random.default_rng(seed)  # the serve phase's prompts
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    kw = dict(num_slots=4, max_seq=max_seq, seed=seed, prefix_cache=False, wfq=False,
              token_budget=0, device=device)
    expected_k1 = {"flash_fwd": cfg.n_layers * len(prompts), "flash_bwd": 0}

    def rows(eng, slot, n):
        return torch.stack([torch.stack([ck[slot, :n], cv[slot, :n]]) for ck, cv in eng._caches])

    mono = DecodeEngine(cfg, params, **kw)
    try:
        _serve_engine(mono, [prompts[0][:8]], 2, "pd-warmup")  # allocator, cuBLAS
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        mono_res = _serve_engine(mono, prompts, max_tokens, "pd-mono")
        mono_launches = dict(LAUNCHES)
        slots = [next(a["slot"] for n, _, _, a in _events(mono, r["rid"]) if n == "admitted")
                 for r in mono_res]
        mono_rows = [rows(mono, s, len(p)).clone() for s, p in zip(slots, prompts)]
    finally:
        mono.shutdown()
    del mono
    mono_tokens = [r["token_ids"] for r in mono_res]

    pre = DecodeEngine(cfg, params, **{**kw, "num_slots": 1, "decode_loop": False})
    dec = DecodeEngine(cfg, params, **kw)
    attach_ms = []
    attach = dec._attach_kv

    def timed_attach(slot, kv):
        t0 = time.perf_counter()
        attach(slot, kv)
        _sync(device)  # the rows have landed
        attach_ms.append((time.perf_counter() - t0) * 1e3)

    dec._attach_kv = timed_attach
    forms = {"host_tensor": lambda kv: kv, "numpy_f32": lambda kv: kv.float().numpy(),
             "cuda_tensor": lambda kv: kv.to(device)}
    pairs = {}
    try:
        pre.prefill_detached(prompts[0][:8])  # warm-up
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        pre_out, detached_ms = [], []
        for i, p in enumerate(prompts):
            t0 = time.perf_counter()
            pre_out.append(pre.prefill_detached(p, request_id=f"pd-pre-{i}"))
            detached_ms.append((time.perf_counter() - t0) * 1e3)
        detached_launches = dict(LAUNCHES)
        rows_equal = [torch.equal(kv.to(device), ref)
                      for (_, kv, _), ref in zip(pre_out, mono_rows)]
        del mono_rows
        for form_name, form in forms.items():
            n_attach = len(attach_ms)
            LAUNCHES.update(flash_fwd=0, flash_bwd=0)
            t0 = time.time()
            run = _pd_run(pre_out, dec, prompts, max_tokens, f"pd-{form_name}", form, device)
            run.update(wall_s=time.time() - t0, launches=dict(LAUNCHES),
                       attach_ms=attach_ms[n_attach:])
            pairs[form_name] = run
        pre_admitted = pre._sched.stats()["admitted"]
        dec_chunks = dec._sched.stats()["prefill_chunks"]
        pre_timing = [pre.request_timing(f"pd-pre-{i}") for i in range(len(prompts))]
        exact, total, gap = _teacher_forced(dec, prompts, pairs["host_tensor"]["tokens"])
    finally:
        pre.shutdown()
        dec.shutdown()
    kv_mib = [kv.numel() * kv.element_size() / 2**20 for _, kv, _ in pre_out]
    del pre, dec, pre_out
    gc.collect()
    _empty_cache(device)

    for form_name, r in pairs.items():
        r["tokens_equal_mono"] = r["tokens"] == mono_tokens
        r["ok"] = (r["tokens_equal_mono"] and r["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
                   and r["on_device"] == [form_name == "cuda_tensor"] * len(prompts)
                   and all(t is not None and {"pd-transfer", "pd-attach", "decode"}
                           <= set(t["phases"]) for t in r["timing"]))
    rec = {
        "phase": "pd", "model": name, "prompt_lengths": list(lengths),
        "max_tokens": max_tokens, "margin": margin,
        "mono": {"tokens": mono_tokens, "launches": mono_launches,
                 "ttft_s": [r["ttft_s"] for r in mono_res],
                 "tpot_s": [r["tpot_s"] for r in mono_res]},
        "detached": {"ms": detached_ms, "launches": detached_launches,
                     "rows_equal_mono": rows_equal, "kv_mib": kv_mib,
                     "timing": pre_timing},
        "launches_expected": expected_k1, "pairs": pairs,
        "prefill_engine_admitted": pre_admitted, "decode_engine_prefill_chunks": dec_chunks,
        "teacher_forced_exact": exact, "teacher_forced_total": total, "worst_logit_gap": gap,
        "launches": {"mono": mono_launches, "detached": detached_launches,
                     **{f"decode_{k}": r["launches"] for k, r in pairs.items()}},
    }
    rec["ok"] = (mono_launches == expected_k1 and detached_launches == expected_k1
                 and all(rows_equal) and all(r["ok"] for r in pairs.values())
                 and all(len(t) == max_tokens for t in mono_tokens)
                 and pre_admitted == 0 and dec_chunks == 0 and gap <= margin
                 and all(t is not None and "prefill-detached" in t["phases"]
                         for t in pre_timing))
    emit(rec)
    emit({"phase": "pd_attach", "card": card, "prompt_lengths": list(lengths),
          "kv_mib": kv_mib,
          "attach_ms": {k: r["attach_ms"] for k, r in pairs.items()},
          "transfer_ms": {k: r["transfer_ms"] for k, r in pairs.items()},
          "detached_prefill_ms": detached_ms,
          "mono_ttft_ms": [r["ttft_s"] * 1e3 for r in mono_res],
          "tpot_s_median": {"mono": statistics.median(rec["mono"]["tpot_s"]),
                            **{k: statistics.median(r["tpot_s"]) for k, r in pairs.items()}},
          "k1_launches_detached": detached_launches["flash_fwd"]})
    return rec


# Device time by kind of kernel, from the kernel's name.
KERNEL_CLASSES = (
    ("k1", ("flash_fwd_kernel",)),
    ("k2", ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
    ("foreach", ("multi_tensor_apply",)),
)


def _kernel_class(name: str) -> str:
    for cls, keys in KERNEL_CLASSES:
        if any(key in name for key in keys):
            return cls
    return "other"


def _device_profile(fn, reps: int = 5) -> dict:
    """Host wall time of fn (median of `reps`, synchronized, no profiler) and
    the device busy time of one call from torch.profiler's CUDA kernel
    events, in total and by kind of kernel; idle share = 1 - busy / wall.
    None for the busy time when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    n_kernels = 0
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            spans.append((e.time_range.start, e.time_range.end))
    busy_ms = sum(by_name.values()) or None
    # Kernels on several streams (FSDP2's copies) overlap: their union is
    # the time the device was busy at all.
    union_us, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            union_us, reach = union_us + (end - start), end
        elif end > reach:
            union_us, reach = union_us + (end - reach), end
    by_class: dict = {}
    for name, ms in by_name.items():
        by_class[_kernel_class(name)] = by_class.get(_kernel_class(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
            "device_busy_union_ms": union_us / 1e3 if spans else None,
            "idle_share_union": 1.0 - union_us / 1e3 / wall_ms if spans else None,
            "device_kernels": n_kernels, "by_class_ms": by_class,
            "top_ms": [[name[:80], ms] for name, ms in top]}


def profile_engine(eng, prefill_len: int) -> dict:
    """Where the engine's time goes: one batched decode step over all slots
    (write gate off, so the pool is untouched) and one offset-0 prefill
    chunk of `prefill_len` tokens rounded up to its bucket."""
    import torch

    B, bucket = eng.B, eng._bucket(prefill_len)
    last = torch.zeros(B, dtype=torch.long, device=eng.device)
    lens = torch.full((B,), 400, dtype=torch.long, device=eng.device)
    gate = torch.zeros(B, dtype=torch.bool, device=eng.device)
    tokens = torch.ones((1, bucket), dtype=torch.long, device=eng.device)
    with torch.inference_mode():
        decode = _device_profile(lambda: eng._decode_step(last, lens, gate))
        prefill = _device_profile(lambda: eng._prefill_at(tokens, 0, 0, bucket))
    return {"decode_step": decode, "prefill_chunk": dict(prefill, bucket=bucket)}


def _grads(model, batch):
    import torch

    from ray_tpu_torch.parallel.optim import tree_leaves
    from ray_tpu_torch.parallel.spmd import train_loss

    loss = train_loss(model, batch)
    grads = torch.autograd.grad(loss, tree_leaves(model.param_tree(trainable=True)))
    return loss.item(), grads


def _leaf_names(tree, prefix=()) -> list:
    """'/'-joined paths of a nested dict's leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for key in sorted(tree) for n in _leaf_names(tree[key], prefix + (key,))]
    return ["/".join(prefix)]


def _leaf_distances(a, b) -> list:
    """L2 norm of the difference of two gradient lists, leaf by leaf."""
    import torch

    return torch.stack([torch.linalg.vector_norm(x.float() - y.float())
                        for x, y in zip(a, b)]).tolist()


def _l2(values) -> float:
    return math.sqrt(sum(v * v for v in values))


def _reference_grads(cfg, params, data, device):
    """Step-1 gradients of `params` under `cfg` evaluated in f32 (plain
    attention, f32 activations) and by the bf16 plain-attention route:
    (leaf names, f32 loss, f32 gradients, plain loss, the plain route's
    distance from f32 leaf by leaf)."""
    import dataclasses

    import torch

    from ray_tpu_torch.models.transformer import Transformer

    names = _leaf_names(params)
    cfg32 = dataclasses.replace(cfg, attention="reference", dtype=torch.float32)
    loss32, g32 = _grads(Transformer(cfg32, params, device=device), data)
    loss_plain, g = _grads(Transformer(dataclasses.replace(cfg, attention="reference"),
                                       params, device=device), data)
    dl_p32 = _leaf_distances(g, g32)
    del g
    return names, loss32, g32, loss_plain, dl_p32


def _distance_check(names, dl_f32, dl_p32, g32, g) -> dict:
    """The flash route's step-1 gradients `g` (distances `dl_f32` from the
    f32 evaluation, leaf by leaf) against the plain route's (`dl_p32`): no
    farther than twice over all leaves and for every attention projection
    leaf alone, and finite. Its record fields, with "ok"."""
    import torch

    d_p32, d_f32 = _l2(dl_p32), _l2(dl_f32)
    attn = [i for i, n in enumerate(names) if "/attn/" in n]
    worst = max(attn, key=lambda i: dl_f32[i] / dl_p32[i])
    g32_norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x) for x in g32])))
    finite = all(bool(torch.isfinite(x).all()) for x in g)
    return {
        "grad_l2_dist_plain_vs_f32": d_p32, "grad_l2_dist_flash_vs_f32": d_f32,
        "grad_l2_norm_f32": g32_norm, "grad_tolerance": 2.0 * d_p32,
        "attn_leaves": len(attn),
        "attn_grad_l2_dist_plain_vs_f32": _l2(dl_p32[i] for i in attn),
        "attn_grad_l2_dist_flash_vs_f32": _l2(dl_f32[i] for i in attn),
        "attn_leaf_worst_ratio": {"leaf": names[worst], "flash_vs_f32": dl_f32[worst],
                                  "plain_vs_f32": dl_p32[worst],
                                  "ratio": dl_f32[worst] / dl_p32[worst]},
        "ok": finite and d_f32 <= 2.0 * d_p32
        and all(dl_f32[i] <= 2.0 * dl_p32[i] for i in attn),
    }


def phase_train(name: str, batch: int, seq: int, remat: bool, steps: int,
                seed: int = 0, device: str = "cuda") -> dict:
    """init_state/build_train_step on `name` at full width and depth, random
    f32 weights from a seed, AdamW as bench.py (3e-4, weight decay 0.01, bf16
    first moment), a repeated random batch with targets = tokens as bench.py.

    Step-1 gradient check: the flash route (K1 forward, K2 backward) and the
    plain-attention route are bf16 evaluations of one function that round at
    different places; each should sit about as far from the f32 evaluation
    of the same weights as the other, so the flash route's gradients must be
    no farther from it than twice the plain route's: over all leaves (global
    L2 distance), and leaf by leaf for every attention projection (q, k, v,
    o of each layer), which the tied table's large gradient would otherwise
    hide in the global sum.
    Then `steps` steps with K1/K2 counted from 0: the loss must stay finite
    and fall, K2 must launch once per layer per step and K1 once (twice
    under remat, whose backward reruns the forward). Step time is the median
    of the steps after the first; MFU counts bench.py's model flops (6N +
    12*L*E*S per token) against the bf16 dense peak; one further step is
    profiled for the device's busy and idle share."""
    import torch

    from ray_tpu_torch.models.transformer import Transformer, get_config
    from ray_tpu_torch.ops.attention import LAUNCHES
    from ray_tpu_torch.parallel.optim import adamw
    from ray_tpu_torch.parallel.spmd import build_train_step, fused_ce_enabled, init_state

    cfg = get_config(name, remat=remat)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.time()
    model = Transformer(cfg, device=device, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device)
    data = {"tokens": tokens, "targets": tokens}
    _sync(device)
    init_s = time.time() - t0
    fused = fused_ce_enabled(model, tokens.shape)

    # Step-1 gradients of the three evaluations, one held at a time beside
    # the f32 one.
    params = model.param_tree()
    names, loss32, g32, loss_plain, dl_p32 = _reference_grads(cfg, params, data, device)
    LAUNCHES.update(flash_fwd=0, flash_bwd=0)
    loss_flash, g = _grads(model, data)
    grad_launches = dict(LAUNCHES)
    check = _distance_check(names, _leaf_distances(g, g32), dl_p32, g32, g)
    del g, g32, params
    _empty_cache(device)

    opt = adamw(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    state, _ = init_state(model, cfg, opt)
    step_fn, placement = build_train_step(model, opt)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    LAUNCHES.update(flash_fwd=0, flash_bwd=0)
    losses, norms, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data)
        losses.append(float(metrics["loss"]))  # synchronizes
        times.append(time.perf_counter() - t0)
        norms.append(float(metrics["grad_norm"]))
    launches = dict(LAUNCHES)
    peak_gb = profile = None
    if device == "cuda":
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        profile = _device_profile(lambda: step_fn(state, data), reps=2)

    step_s = statistics.median(times[1:])
    tokens_per_s = batch * seq / step_s
    flops_per_token = _flops_per_token(cfg, seq)
    mfu = tokens_per_s * flops_per_token / PEAK_BF16_FLOPS
    per_layer = 2 if remat else 1
    expected = {"flash_fwd": per_layer * cfg.n_layers * steps,
                "flash_bwd": cfg.n_layers * steps}
    ok_check = check.pop("ok")
    rec = {
        "phase": "train", "model": name, "layers": cfg.n_layers, "hidden": cfg.hidden,
        "params_b": cfg.num_params() / 1e9, "tokens": [batch, seq], "remat": remat,
        "remat_policy": cfg.remat_policy, "fused_ce": fused, "init_s": init_s,
        "loss_step1": {"flash": loss_flash, "plain": loss_plain, "f32": loss32},
        **check,
        "grad_check_launches": grad_launches,
        "losses": losses, "grad_norms": norms, "step_s": times,
        "steady_step_ms": step_s * 1e3, "tokens_per_s": tokens_per_s,
        "model_flops_per_step": flops_per_token * batch * seq, "mfu": mfu,
        "step_bound_ms": flops_per_token * batch * seq / PEAK_BF16_FLOPS * 1e3,
        "launches": launches, "launches_expected": expected, "peak_memory_gb": peak_gb,
        "profile": profile,
    }
    rec["loss_monotone"] = all(b < a for a, b in zip(losses, losses[1:]))
    rec["ok"] = (ok_check and launches == expected
                 and all(placement[k] == tokens.device for k in ("tokens", "targets"))
                 and all(math.isfinite(x) for x in losses + norms)
                 and losses[-1] < losses[0]
                 and grad_launches == {"flash_fwd": per_layer * cfg.n_layers,
                                       "flash_bwd": cfg.n_layers})
    del state, step_fn, model, opt
    gc.collect()
    _empty_cache(device)
    emit(rec)
    return rec


def _flops_per_token(cfg, seq: int) -> int:
    """bench.py's model flops per trained token: 6N + 12*L*E*S."""
    return 6 * cfg.num_params() + 12 * cfg.n_layers * cfg.hidden * seq


def _steps_record(model, cfg, data, steps: int, device: str) -> dict:
    """`steps` train steps (AdamW as the train phase) on `model`'s current
    weights after one untimed step: the median step time, tokens/s, MFU,
    peak device memory of the steps (reset after the optimizer state is
    made), the losses, the K1/K2 launches of the timed steps, and a profile
    of one more step (device busy and idle share, time by kind of kernel)."""
    import torch

    from ray_tpu_torch.ops.attention import LAUNCHES
    from ray_tpu_torch.parallel.optim import adamw
    from ray_tpu_torch.parallel.spmd import build_train_step, init_state

    opt = adamw(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    state, _ = init_state(model, cfg, opt)
    step_fn, _ = build_train_step(model, opt)
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state, metrics = step_fn(state, data)
    losses = [float(metrics["loss"])]
    LAUNCHES.update(flash_fwd=0, flash_bwd=0)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data)
        losses.append(float(metrics["loss"]))  # synchronizes
        times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak_gb = profile = None
    if device == "cuda":
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        profile = _device_profile(lambda: step_fn(state, data), reps=2)
    del state, step_fn, opt
    gc.collect()
    _empty_cache(device)
    batch, seq = data["tokens"].shape
    step_s = statistics.median(times)
    return {"step_s": times, "steady_step_ms": step_s * 1e3,
            "tokens_per_s": batch * seq / step_s,
            "mfu": batch * seq / step_s * _flops_per_token(cfg, seq) / PEAK_BF16_FLOPS,
            "peak_memory_gb": peak_gb, "losses": losses, "launches": launches,
            "profile": profile}


# The remat phase's policies and K1's launches per layer per step under each
# (JAX's traced gradient holds the same: only "selective" keeps the flash
# forward's outputs, so only it spares K1's rerun).
REMAT_K1_PER_LAYER = {"full": 2, "attn": 2, "dots": 2, "selective": 1}
# Step-1 gradients under a policy against "full"'s: bit for bit, or within
# this relative L2 distance per leaf (the policies recompute the same ops on
# the same inputs; only a sum taken with atomics may differ).
REMAT_GRAD_REL_L2 = 1e-5


def _rel_l2s(got, ref) -> list:
    """||g - r|| / ||r|| per leaf (||g - r|| where ||r|| is 0)."""
    import torch

    out = []
    for g, r in zip(got, ref):
        d = float(torch.linalg.vector_norm(g.float() - r.float()))
        n = float(torch.linalg.vector_norm(r.float()))
        out.append(d / n if n else d)
    return out


def phase_remat(name: str = "llama3-1b", batch: int = 4, seq: int = 2048,
                steps: int = 3, seed: int = 0, device: str = "cuda") -> dict:
    """llama3-1b at the train phase's shape under each remat policy (full,
    attn, dots, selective), one set of random weights (shared by the four
    models) and one batch. Step-1 gradients under each policy against
    "full"'s (REMAT_GRAD_REL_L2), with K1 and K2 launched exactly
    REMAT_K1_PER_LAYER and once per layer; the device memory allocated at
    the end of the forward pass (what the policy keeps for the backward) and
    the forward and backward pass's peak, each above what was allocated
    before it; then `steps` timed steps per policy (after an untimed one)
    with their launches, step time, tokens/s, MFU and peak memory, all from
    this run."""
    import dataclasses

    import torch

    from ray_tpu_torch.models.transformer import Transformer, get_config
    from ray_tpu_torch.ops.attention import LAUNCHES
    from ray_tpu_torch.parallel.optim import tree_leaves
    from ray_tpu_torch.parallel.spmd import train_loss

    cfg = get_config(name, remat=True, remat_policy="full")
    gen = torch.Generator(device=device).manual_seed(seed)
    base = Transformer(cfg, device=device, generator=gen)
    params = base.param_tree()
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device)
    data = {"tokens": tokens, "targets": tokens}
    models = {p: base if p == "full" else Transformer(
        dataclasses.replace(cfg, remat_policy=p), params, device=device)
        for p in REMAT_K1_PER_LAYER}
    L = cfg.n_layers
    recs, ref, ok = {}, None, True
    for policy, model in models.items():
        _sync(device)
        before = torch.cuda.memory_allocated() if device == "cuda" else 0
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        loss = train_loss(model, data)
        _sync(device)
        # What the forward pass leaves for the backward: the block inputs
        # and what the policy keeps.
        kept = torch.cuda.memory_allocated() - before if device == "cuda" else None
        g = torch.autograd.grad(loss, tree_leaves(model.param_tree(trainable=True)))
        loss = loss.item()
        launches = dict(LAUNCHES)
        rec = {"loss_step1": loss, "grad_check_launches": launches,
               "fwd_kept_above_base_gb": kept / 1e9 if device == "cuda" else None,
               "fwd_bwd_peak_above_base_gb": (torch.cuda.max_memory_allocated() - before) / 1e9
               if device == "cuda" else None}
        want = {"flash_fwd": REMAT_K1_PER_LAYER[policy] * L, "flash_bwd": L}
        good = launches == want and all(bool(torch.isfinite(x).all()) for x in g)
        if ref is None:
            ref = g
        else:
            rel = _rel_l2s(g, ref)
            worst = max(range(len(rel)), key=rel.__getitem__)
            rec.update(bitwise_equal_to_full=all(torch.equal(a, b) for a, b in zip(g, ref)),
                       grad_max_rel_l2_vs_full=rel[worst],
                       grad_worst_leaf=_leaf_names(params)[worst])
            good = good and (rec["bitwise_equal_to_full"] or rel[worst] <= REMAT_GRAD_REL_L2)
        del g
        recs[policy] = rec
        ok = ok and good
    del ref
    _empty_cache(device)
    for policy, model in models.items():
        timed = _steps_record(model, model.cfg, data, steps, device)
        want = {"flash_fwd": REMAT_K1_PER_LAYER[policy] * L * steps, "flash_bwd": L * steps}
        timed["launches_expected"] = want
        ok = ok and timed["launches"] == want and all(math.isfinite(x) for x in timed["losses"])
        recs[policy].update(timed)
    rec = {"phase": "remat", "model": name, "layers": L, "tokens": [batch, seq],
           "timed_steps": steps, "grad_tol_rel_l2": REMAT_GRAD_REL_L2, "policies": recs,
           "launches": {p: r["launches"] for p, r in recs.items()}, "ok": ok}
    del models, base, params
    gc.collect()
    _empty_cache(device)
    emit(rec)
    return rec


def _fused_params(params, cfg) -> dict:
    """The fused-qkv twin of an unfused param tree: each layer's q, k, v
    kernels concatenated on the heads axis into qkv, gate and up on the
    output axis into gate_up."""
    import torch

    out = {k: v for k, v in params.items() if not k.startswith("layer_")}
    for i in range(cfg.n_layers):
        layer = params[f"layer_{i}"]
        a, m = layer["attn"], layer["mlp"]
        out[f"layer_{i}"] = dict(layer, attn={
            "qkv": {"kernel": torch.cat([a[n]["kernel"] for n in ("q", "k", "v")], dim=1)},
            "o": a["o"]}, mlp={
            "gate_up": {"kernel": torch.cat([m["gate"]["kernel"], m["up"]["kernel"]], dim=1)},
            "down": m["down"]})
    return out


def _split_fused_grads(names, fused_names, grads, cfg) -> list:
    """A fused model's gradients in the unfused model's leaf order `names`:
    qkv's split into q, k, v and gate_up's into gate, up."""
    by_name = dict(zip(fused_names, grads))
    H, Hkv, F = cfg.n_heads, cfg.n_kv_heads, cfg.mlp_dim
    out = []
    for n in names:
        layer, _, rest = n.partition("/")
        if rest in ("attn/q/kernel", "attn/k/kernel", "attn/v/kernel"):
            parts = by_name[f"{layer}/attn/qkv/kernel"].split([H, Hkv, Hkv], dim=1)
            out.append(parts["qkv".index(rest[5])])
        elif rest in ("mlp/gate/kernel", "mlp/up/kernel"):
            parts = by_name[f"{layer}/mlp/gate_up/kernel"].split([F, F], dim=1)
            out.append(parts[0 if rest == "mlp/gate/kernel" else 1])
        else:
            out.append(by_name[n])
    return out


def phase_fused(name: str = "llama3-1b", batch: int = 4, seq: int = 2048, steps: int = 3,
                seed: int = 0, device: str = "cuda") -> dict:
    """llama3-1b with fused_qkv=True at the train phase's shape, its weights
    the unfused model's concatenated (q|k|v, gate|up): the step-1 gradients,
    split back, pass the train phase's f32-distance check against the f32
    and plain-attention evaluations of the unfused weights, with K1 and K2
    launched as under "full" (K1 and K2 now in the bshd layout); then the
    fused and the unfused model's timed steps (remat "full")."""
    import torch

    from ray_tpu_torch.models.transformer import Transformer, get_config
    from ray_tpu_torch.ops.attention import LAUNCHES

    cfg = get_config(name, remat=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Transformer(cfg, device=device, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device)
    data = {"tokens": tokens, "targets": tokens}
    params = model.param_tree()
    names, loss32, g32, loss_plain, dl_p32 = _reference_grads(cfg, params, data, device)
    fcfg = get_config(name, remat=True, fused_qkv=True)
    fused = Transformer(fcfg, _fused_params(params, cfg), device=device)
    LAUNCHES.update(flash_fwd=0, flash_bwd=0)
    loss_fused, g = _grads(fused, data)
    grad_launches = dict(LAUNCHES)
    g = _split_fused_grads(names, _leaf_names(fused.param_tree()), g, cfg)
    check = _distance_check(names, _leaf_distances(g, g32), dl_p32, g32, g)
    del g, g32
    _empty_cache(device)
    L = cfg.n_layers
    timed = {"fused": _steps_record(fused, fcfg, data, steps, device),
             "unfused": _steps_record(model, cfg, data, steps, device)}
    want = {"flash_fwd": 2 * L * steps, "flash_bwd": L * steps}
    rec = {"phase": "fused", "model": name, "layers": L, "tokens": [batch, seq],
           "loss_step1": {"fused_flash": loss_fused, "plain": loss_plain, "f32": loss32},
           **check, "grad_check_launches": grad_launches, "timed_steps": steps,
           "steps": timed, "launches": timed["fused"]["launches"],
           "launches_expected": want,
           "fused_over_unfused_step": timed["fused"]["steady_step_ms"]
           / timed["unfused"]["steady_step_ms"]}
    rec["ok"] = (rec.pop("ok") and grad_launches == {"flash_fwd": 2 * L, "flash_bwd": L}
                 and all(t["launches"] == want for t in timed.values())
                 and all(math.isfinite(x) for t in timed.values() for x in t["losses"]))
    del fused, model, params
    gc.collect()
    _empty_cache(device)
    emit(rec)
    return rec


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.detach().clone() if hasattr(tree, "detach") else tree.copy()


def _tree_leaves_any(tree) -> list:
    """Leaves of nested dicts, tuples and lists, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves_any(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tree_leaves_any(v)]
    return [tree]


def _load_tree_(state, snap) -> None:
    """Copy a snapshot (a state_tree clone) back into `state`, in place."""
    import torch

    from ray_tpu_torch.parallel.spmd import state_tree

    with torch.no_grad():
        for dst, src in zip(_tree_leaves_any(state_tree(state)), _tree_leaves_any(snap)):
            if hasattr(dst, "copy_"):
                dst.copy_(src)
    state.step = int(snap["step"])
    state.opt_state.count = int(snap["opt_state"][0][0])


def _max_abs_gap(a, b) -> float:
    import torch

    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(a, b)
               if isinstance(x, torch.Tensor))


def _greedy(engine, prompts, max_tokens: int) -> list:
    """Greedy tokens of each prompt, one request at a time (a batch of one,
    so both engines compared batch alike); the engine shut down."""
    import threading

    from ray_tpu_torch.llm import SamplingParams

    out = []
    try:
        for p in prompts:
            toks, done = [], threading.Event()

            def cb(token, last, toks=toks, done=done):
                toks.append(token)
                if last:
                    done.set()

            engine.submit(p, SamplingParams(max_tokens=max_tokens), cb)
            if not done.wait(timeout=300):
                raise RuntimeError("engine did not finish")
            out.append(toks)
    finally:
        engine.shutdown()
    return out


def phase_ckpt(name: str = "gpt2-125m", batch: int = 8, seq: int = 1024, seed: int = 0,
               device: str = "cuda", max_tokens: int = 16) -> dict:
    """A run saved and resumed: gpt2-125m (the train phase's shape and
    AdamW) takes 2 steps; its whole TrainState ({"step", "params",
    "opt_state"}, bf16 first moment) is saved with AsyncCheckpointWriter
    while step 3 runs (the loop's blocked ms and the write's seconds
    printed), into a temporary directory removed at the end. Restored into a
    fresh model and state, every leaf equals the snapshot bit for bit; step
    3 from it differs from the uninterrupted step 3 by no more than two
    uninterrupted runs of step 3 differ from each other. Then LLMServer
    warm-starts from the checkpoint and serves 2 greedy requests, whose
    tokens must equal a DecodeEngine's over the snapshot's params cast the
    same way (load_model's bf16)."""
    import dataclasses
    import tempfile

    import torch

    from ray_tpu_torch import checkpoint as ckpt
    from ray_tpu_torch.llm import DecodeEngine, LLMConfig, LLMServer
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.transformer import Transformer, get_config
    from ray_tpu_torch.parallel.optim import adamw
    from ray_tpu_torch.parallel.spmd import (
        build_train_step,
        init_state,
        state_from_tree,
        state_tree,
    )

    cfg = get_config(name, remat=False)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Transformer(cfg, device=device, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device)
    data = {"tokens": tokens, "targets": tokens}

    def optimizer():
        return adamw(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)

    opt = optimizer()
    state, _ = init_state(model, cfg, opt)
    step_fn, _ = build_train_step(model, opt)
    for _ in range(2):
        state, _ = step_fn(state, data)
    _sync(device)
    snap = _clone_tree(state_tree(state))
    snap_leaves = _tree_leaves_any(snap)
    nbytes = sum(x.numel() * x.element_size() for x in snap_leaves if hasattr(x, "numel"))
    writer = ckpt.AsyncCheckpointWriter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        path = os.path.join(tmp, "checkpoint_000002")
        try:
            t0 = time.perf_counter()
            writer.save(path, state_tree(state))
            blocked_s = time.perf_counter() - t0
            state, m3 = step_fn(state, data)  # runs while the writer writes
            losses3 = [float(m3["loss"])]
            step3_s = time.perf_counter() - t0 - blocked_s
            writer.wait_until_finished()
            write_s = time.perf_counter() - t0
            # A second save, as a run saves again later: its host buffers
            # come from the pinned allocator's cache.
            t0 = time.perf_counter()
            writer.save(os.path.join(tmp, "checkpoint_000003"), state_tree(state))
            blocked2_s = time.perf_counter() - t0
            writer.wait_until_finished()
            write2_s = time.perf_counter() - t0
        finally:
            writer.shutdown()
        runs = [_clone_tree(state.params)]
        _load_tree_(state, snap)
        state, m3b = step_fn(state, data)
        losses3.append(float(m3b["loss"]))
        runs.append(_clone_tree(state.params))
        del state, step_fn, opt
        gc.collect()
        _empty_cache(device)
        t0 = time.perf_counter()
        tree = ckpt.restore(path)
        model2 = Transformer(cfg, device=device)
        opt2 = optimizer()
        state2 = state_from_tree(model2, cfg, opt2, tree)
        _sync(device)
        restore_s = time.perf_counter() - t0
        del tree
        restored = _tree_leaves_any(state_tree(state2))
        bitwise = len(restored) == len(snap_leaves) and all(
            torch.equal(a, b) and a.dtype == b.dtype if isinstance(a, torch.Tensor)
            else int(a) == int(b) for a, b in zip(restored, snap_leaves))
        step_fn2, _ = build_train_step(model2, opt2)
        state2, m3r = step_fn2(state2, data)
        loss3_restored = float(m3r["loss"])
        after = _tree_leaves_any(state2.params)
        gap_runs = _max_abs_gap(_tree_leaves_any(runs[1]), _tree_leaves_any(runs[0]))
        gap_restored = _max_abs_gap(after, _tree_leaves_any(runs[0]))
        del state2, step_fn2, opt2, model2, runs, after
        gc.collect()
        _empty_cache(device)

        rng = torch.Generator().manual_seed(seed + 1)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
                   for n in (24, 57)]
        server = LLMServer(LLMConfig(model_id=name, checkpoint_path=path, num_slots=2,
                                     max_seq=256, device=device))

        async def serve():
            try:
                return [(await server.generate(p, max_tokens=max_tokens))["token_ids"]
                        for p in prompts]
            finally:
                await server.shutdown()

        served = asyncio.run(serve())
    del server
    scfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)
    engine = DecodeEngine(scfg, params_from_jax(snap["params"], scfg, device), num_slots=2,
                          max_seq=256, device=device)
    reference = _greedy(engine, prompts, max_tokens)
    del engine, snap, snap_leaves
    gc.collect()
    _empty_cache(device)
    rec = {"phase": "ckpt", "model": name, "tokens": [batch, seq], "state_bytes": nbytes,
           "blocked_ms": blocked_s * 1e3, "write_s": write_s,
           "second_save": {"blocked_ms": blocked2_s * 1e3, "write_s": write2_s},
           "step3_beside_write_s": step3_s, "restore_s": restore_s,
           "restored_bitwise": bitwise, "loss_step3": {"uninterrupted": losses3,
                                                       "restored": loss3_restored},
           "param_max_abs_gap": {"uninterrupted_runs": gap_runs, "restored": gap_restored},
           "served_tokens": served, "engine_tokens": reference}
    rec["ok"] = (bitwise and gap_restored <= gap_runs and served == reference
                 and all(len(t) == max_tokens for t in served)
                 and all(math.isfinite(x) for x in losses3))
    emit(rec)
    return rec


# The mesh phase's gate: its loss and grad_norm at each step against the
# one-device step's (the same arithmetic: FSDP2 over one rank gathers and
# reduces by copying; the norm sums its squares in another order).
MESH_REL_TOL = 1e-5


def phase_mesh(name: str = "llama3-1b", batch: int = 4, seq: int = 2048, steps: int = 3,
               seed: int = 0, device: str = "cuda") -> dict:
    """Training over a mesh on one card: one rank (NCCL refuses two ranks
    on one device) in a process group rendezvousing through a FileStore in
    a temporary directory, `create_mesh({"fsdp": 1})`, and `name` built on
    the meta device and sharded with FSDP2 by `init_state`, its weights
    drawn leaf by leaf from the train phase's seed (the train phase's
    weights, then its batch from the same generator); full remat, fused
    cross-entropy, AdamW as the train phase. Beside it the same `steps` on
    one device (the train phase's path, its model freed first). Gates: loss
    and grad_norm at every step within MESH_REL_TOL relative of the
    one-device step's (bit for bit reported); every weight a DTensor with
    the rules' placement; K1 twice and K2 once per layer per step; a save
    of the step and the params by process 0 of 1 (AsyncCheckpointWriter,
    its blocked ms) committed, and restored onto the mesh bit for bit.
    Reports step times, peak memory and a profiled step's device idle
    share (from the union of kernel intervals: FSDP2 copies on streams of
    its own) beside the one-device steps', and the init's peak memory."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import checkpoint as ckpt
    from ray_tpu_torch.models.transformer import Transformer, get_config, param_axes
    from ray_tpu_torch.ops.attention import LAUNCHES
    from ray_tpu_torch.parallel.mesh import create_mesh, logical_to_placements
    from ray_tpu_torch.parallel.optim import adamw
    from ray_tpu_torch.parallel.spmd import build_train_step, init_state

    cfg = get_config(name, remat=True, remat_policy="full")

    def optimizer():
        return adamw(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)

    def run_steps(step_fn, state, data):
        losses, norms, times = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, data)
            losses.append(float(metrics["loss"]))  # synchronizes
            times.append(time.perf_counter() - t0)
            norms.append(float(metrics["grad_norm"]))
        return state, losses, norms, times

    # The one-device steps: the train phase's model, weights and batch.
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Transformer(cfg, device=device, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device)
    data = {"tokens": tokens, "targets": tokens}
    opt = optimizer()
    state, _ = init_state(model, cfg, opt)
    step_fn, _ = build_train_step(model, opt)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state, ref_losses, ref_norms, ref_times = run_steps(step_fn, state, data)
    ref_peak_gb = ref_profile = None
    if device == "cuda":
        ref_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ref_profile = _device_profile(lambda: step_fn(state, data), reps=2)
    del state, step_fn, opt, model
    gc.collect()
    _empty_cache(device)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo", store=store, rank=0,
                            world_size=1)
    writer = ckpt.AsyncCheckpointWriter()
    try:
        mesh = create_mesh({"fsdp": 1}, device=device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=device).manual_seed(seed)
        model = Transformer(cfg, device="meta")
        opt = optimizer()
        t0 = time.perf_counter()
        state, shardings = init_state(model, cfg, opt, mesh, rng=gen)
        _sync(device)
        init_s = time.perf_counter() - t0
        init_peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device)
        step_fn, place = build_train_step(model, opt, mesh)
        local = place({"tokens": tokens, "targets": tokens})
        placed = {}
        for path, _ in model.named_tree_params():
            p = state.params
            for key in path:
                p = p[key]
            placed["/".join(path)] = isinstance(p, DTensor) and tuple(p.placements) == \
                logical_to_placements(param_axes(path), p.device_mesh)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        LAUNCHES.update(flash_fwd=0, flash_bwd=0)
        state, losses, norms, times = run_steps(step_fn, state, local)
        launches = dict(LAUNCHES)
        peak_gb = profile = None
        if device == "cuda":
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            profile = _device_profile(lambda: step_fn(state, local), reps=2)
        # Save the step and the params (process 0 of 1), then restore onto
        # the mesh with the state's placements and compare bit for bit.
        path = os.path.join(tmp, "checkpoint")
        tree = {"step": np.asarray(state.step, np.int32), "params": state.params}
        t0 = time.perf_counter()
        writer.save(path, tree, process_index=0, process_count=1)
        blocked_s = time.perf_counter() - t0
        writer.wait_until_finished()
        write_s = time.perf_counter() - t0
        nbytes = sum(p.to_local().numel() * p.to_local().element_size()
                     for p in _tree_leaves_any(state.params))
        want = {k: v for k, v in shardings.items() if k.startswith("params/")}
        t0 = time.perf_counter()
        restored = ckpt.restore(path, mesh=mesh, placements=want)
        _sync(device)
        restore_s = time.perf_counter() - t0
        names = [f"params/{n}" for n in _leaf_names(state.params)]
        pairs = list(zip(names, _tree_leaves_any(restored["params"]),
                         _tree_leaves_any(state.params)))
        bitwise = (int(restored["step"]) == state.step and len(pairs) == len(placed) and all(
            isinstance(a, DTensor) and tuple(a.placements) == want[n]
            and torch.equal(a.to_local(), b.detach().to_local()) for n, a, b in pairs))
        manifest = ckpt.load_manifest(path)
        del restored, pairs, state, step_fn, opt, model, local, mesh
    finally:
        writer.shutdown()
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    _empty_cache(device)

    def rel(a, b):
        return abs(a - b) / abs(b)

    per_layer = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd": cfg.n_layers}
    expected = {k: v * steps for k, v in per_layer.items()}
    step_ms, ref_ms = (statistics.median(t[1:] or t) * 1e3 for t in (times, ref_times))
    rec = {
        "phase": "mesh", "model": name, "layers": cfg.n_layers, "tokens": [batch, seq],
        "mesh": {"fsdp": 1}, "ranks": 1, "backend": "nccl" if device == "cuda" else "gloo",
        "remat_policy": cfg.remat_policy, "init_s": init_s, "init_peak_memory_gb": init_peak_gb,
        "losses": losses, "grad_norms": norms, "one_device": {
            "losses": ref_losses, "grad_norms": ref_norms, "step_s": ref_times,
            "steady_step_ms": ref_ms, "peak_memory_gb": ref_peak_gb, "profile": ref_profile},
        "loss_max_rel": max(rel(a, b) for a, b in zip(losses, ref_losses)),
        "grad_norm_max_rel": max(rel(a, b) for a, b in zip(norms, ref_norms)),
        "bitwise_losses": losses == ref_losses, "bitwise_grad_norms": norms == ref_norms,
        "rel_tol": MESH_REL_TOL, "weights_placed": sum(placed.values()),
        "weights": len(placed), "step_s": times, "steady_step_ms": step_ms,
        "step_ms_over_one_device": step_ms / ref_ms,
        "launches": launches, "launches_expected": expected, "peak_memory_gb": peak_gb,
        "profile": profile, "ckpt": {
            "bytes": nbytes, "blocked_ms": blocked_s * 1e3, "write_s": write_s,
            "restore_s": restore_s, "process_count": manifest["process_count"],
            "restored_bitwise": bitwise},
    }
    rec["ok"] = (rec["loss_max_rel"] <= MESH_REL_TOL and rec["grad_norm_max_rel"] <= MESH_REL_TOL
                 and all(placed.values()) and bitwise and manifest["process_count"] == 1
                 and all(math.isfinite(x) for x in losses + norms)
                 and (device != "cuda" or launches == expected))
    emit(rec)
    return rec


def _k1_record(k1: list, case) -> dict:
    """K1's record at (S, H, Hkv, D, causal, layout) with B = 1."""
    return next(r for r in k1 if r["shape"]["B"] == 1 and tuple(r["shape"][key] for key in (
        "S", "H", "Hkv", "D", "causal", "layout")) == case)


def _ratio_summary(k1: list, k2: list) -> dict:
    """kernel_ms / library_ms at the shapes the kernels are judged by: K2 at
    llama3-1b's train shape and at D = 128, K1 at both train shapes, the
    served max_seq and the served S = 128 chunk."""
    def brief(rec):
        return {"shape": rec["shape"], "kernel_ms": rec["kernel_ms"],
                "library_ms": rec["library_ms"], "ratio": rec["kernel_over_library"],
                "bound_ms": rec["bound_ms"]}

    out = {"k2": [brief(r) for r in k2 if (r["shape"]["S"], r["shape"]["D"]) in
                  ((2048, 64), (2048, 128))],
           "k1_train": [brief(r) for r in k1 if r["shape"]["B"] > 1]}
    if k1:
        out["k1_served_max_seq"] = brief(_k1_record(k1, K1_MAX_SEQ_SHAPE))
        out["k1_served_chunk"] = brief(_k1_record(k1, K1_MAIN_SHAPE))
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES) +
                        "; the result lines are printed only when all run")
    phases = parser.parse_args(argv).phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs the port "
              "on a GPU", file=sys.stderr)
        return 2
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ray_tpu_torch package is not beside this script "
              f"({e})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = phase_card()
    build = phase_build() if "build" in phases else None
    k1 = phase_k1() if "k1" in phases else []
    k2 = phase_k2() if "k2" in phases else []
    head = phase_head() if "head" in phases else []
    shapes = _ShapeLog()  # from here on, the main paths
    shapes.install()
    shapes.tag = "model"
    model = phase_model() if "model" in phases else None
    serve = prefix = tiers = guided = stream = spec = lora = pd = serve_fingerprint = None
    serving = {"serve", "prefix", "tiers", "guided", "stream", "spec", "lora", "pd"} & set(phases)
    margin = (model["tolerance"] if model else phase_model()["tolerance"]) if serving else None
    if {"serve", "prefix", "tiers"} & set(phases):
        shapes.tag = "serve"
        serve, weights = phase_serve(margin=margin)
        if "prefix" in phases:
            shapes.tag = "prefix"
            prefix = phase_prefix(*weights, margin=margin)
        if "tiers" in phases:
            shapes.tag = "tiers"
            tiers = phase_tiers(*weights, margin=margin, card=card["nvidia_smi"])
        serve_fingerprint = _fingerprint(weights[1])
        del weights
        gc.collect()
        torch.cuda.empty_cache()
    if {"guided", "stream", "spec", "lora", "pd"} & set(phases):
        server = _guided_server()
        try:
            shapes.tag = "guided"
            guided = (phase_guided(server, margin, serve_fingerprint=serve_fingerprint)
                      if "guided" in phases else None)
            shapes.tag = "stream"
            stream = phase_stream(server) if "stream" in phases else None
        finally:
            asyncio.run(server.shutdown())
        weights = (server._cfg, server._engine.params)
        del server
        gc.collect()
        torch.cuda.empty_cache()
        shapes.tag = "spec"
        spec = phase_spec(*weights, margin=margin) if "spec" in phases else None
        shapes.tag = "lora"
        lora = (phase_lora(*weights, margin=margin, card=card["nvidia_smi"])
                if "lora" in phases else None)
        shapes.tag = "pd"
        pd = (phase_pd(*weights, margin=margin, card=card["nvidia_smi"])
              if "pd" in phases else None)
        del weights
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "free", "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    shapes.tag = "train"
    train = [phase_train(*run) for run in TRAIN_RUNS] if "train" in phases else []
    shapes.tag = "remat"
    remat = phase_remat() if "remat" in phases else None
    shapes.tag = "fused"
    fused = phase_fused() if "fused" in phases else None
    shapes.tag = "ckpt"
    ckpt = phase_ckpt() if "ckpt" in phases else None
    shapes.tag = "mesh"
    mesh = phase_mesh() if "mesh" in phases else None
    shapes.uninstall()
    shape_rec, _ = phase_shapes(shapes, k1, k2)
    lora_shapes = None
    if lora is not None:
        # Every K1 shape of the lora phase is a listed case: none of them
        # may have been found unlisted.
        unlisted = {tuple(sh[n] for n in ("B", "S", "T", "H", "Hkv", "D", "causal", "layout"))
                    for sh in shape_rec["unlisted"]["k1"]}
        mine = [e["shape"] for e in shape_rec["k1"] if "lora" in e["paths"]]
        lora_shapes = {"phase": "lora_shapes", "k1": mine,
                       "unlisted": [sh for sh in mine if tuple(sh) in unlisted]}
        lora_shapes["ok"] = bool(mine) and not lora_shapes["unlisted"]
        emit(lora_shapes)
    records = [r for r in (*k1, *k2, *head, model, serve, prefix, tiers, guided, stream, spec,
                           lora, lora_shapes, pd, *train, remat, fused, ckpt, mesh, shape_rec)
               if r is not None]
    failed = [r.get("phase") for r in records if not r["ok"]]
    if build is not None and build["spill_bytes"]:
        failed.append("build")  # a kernel spills registers to local memory
    emit({"phase": "summary", "seconds": time.time() - t_start, "failed": failed,
          "phases": phases, "kernel_over_library": _ratio_summary(k1, k2)})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if set(phases) != set(PHASES):
        print("chip_smoke: a subset of the phases ran; no result line", file=sys.stderr)
        return 4
    main_rec = _k1_record(k1, K1_MAIN_SHAPE)
    k2_rec = k2[K2_CASES.index(K2_MAIN_SHAPE)]
    by_path = {"model_llama3-8b": model["launches"], "serve_llama3-8b": serve["launches"]}
    by_path.update({f"prefix_{p}_llama3-8b": c for p, c in prefix["launches"].items()})
    by_path.update({f"tiers_{p}_llama3-8b": c for p, c in tiers["launches"].items()})
    by_path["guided_llama3-8b"] = guided["launches"]
    by_path["stream_llama3-8b"] = stream["launches"]
    by_path.update({f"spec_{p}_llama3-8b": c for p, c in spec["launches"].items()})
    by_path.update({f"lora_{p}_llama3-8b": c for p, c in lora["launches"].items()})
    by_path.update({f"pd_{p}_llama3-8b": c for p, c in pd["launches"].items()})
    by_path.update({f"train_{r['model']}": r["launches"] for r in train})
    by_path.update({f"remat_{p}_llama3-1b": c for p, c in remat["launches"].items()})
    by_path["fused_llama3-1b"] = fused["launches"]
    by_path["mesh_llama3-1b"] = mesh["launches"]
    kernels = {"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:60",
        "launches": serve["launches"]["flash_fwd"],
        "launches_by_path": {p: c["flash_fwd"] for p, c in by_path.items()},
        "max_abs_err": main_rec["out_max_abs_err"],
        "ms": main_rec["kernel_ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"], "shape": main_rec["shape"],
    }, {
        "name": "flash_bwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "ray_tpu/ops/attention.py:182",
        "launches": train[0]["launches"]["flash_bwd"],
        "launches_by_path": {p: c["flash_bwd"] for p, c in by_path.items()},
        "max_abs_err": max(k2_rec["max_abs_err"].values()),
        "ms": k2_rec["kernel_ms"], "plain_ms": k2_rec["plain_ms"],
        "bound_ms": k2_rec["bound_ms"], "bound_by": k2_rec["bound_by"],
        "library_ms": k2_rec["library_ms"], "shape": k2_rec["shape"],
    }]}
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["device"],
                                 "count": card["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
