#!/usr/bin/env python3
"""Drive the PyTorch port (`ray_tpu_torch`) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON record per line:
  card     the card's name and power limit (nvidia-smi)
  build    K1's and K2's CUDA sources compiled with nvcc for sm_90a, one nvcc
           each, started together (ptxas report)
  k1       the flash-attention forward kernel held against its plain PyTorch
           version on the card, per shape, with times (CUDA events, median of
           >= 20 after warmup) beside SDPA as a yardstick and the card's bound
  k2       the flash-attention backward kernel held against its plain PyTorch
           version the same way, beside SDPA's backward
  head     the tied head's bf16-operand, f32-result GEMM (`_matmul_f32`,
           cuBLAS) forward and backward against f32 matmuls on the card, at
           the train phase's head shapes
  model    llama3-8b at full width and depth, random weights: the Transformer's
           flash route (K1 in every layer) against its plain-attention route
  serve    LLMServer(llama3-8b) answering 4 concurrent greedy requests, each
           answer held against a teacher-forced plain-attention forward; then
           one decode step and one prefill chunk profiled (wall time against
           device busy time, torch.profiler)
  train    init_state/build_train_step on llama3-1b (full width and depth,
           [4, 2048], remat, fused cross-entropy) and on gpt2-125m ([8, 1024],
           no remat, plain cross-entropy): step-1 gradients of the flash route
           (K1 + K2) against the plain-attention route and an f32 evaluation,
           then steps on a repeated batch with their loss, exact K1/K2 launch
           counts, step time, MFU, device idle share and peak memory
Then the kernels line and, last, {"ok": true, "device": {...}}. The kernel
launch counts, both kernels', are set to 0 just before each main path (the
model's forward, the served requests, each configuration's train steps) and
read just after; the kernels line's
`launches` are K1's on the served requests and K2's on llama3-1b's steps,
with every path's counts beside them.

Exits non-zero (and prints no result) without a GPU, without the package
beside it, or when any phase fails. The only process it starts besides
itself is nvcc (and nvidia-smi), both waited for.
"""

from __future__ import annotations

import asyncio
import gc
import json
import math
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
# and no mask.
K2_CASES = [
    (4, 2048, 32, 8, 64, True, "bhsd"),
    (8, 1024, 12, 12, 64, True, "bhsd"),
    (1, 2048, 32, 8, 128, True, "bshd"),
    (1, 100, 32, 8, 128, True, "bhsd"),
    (2, 200, 12, 12, 64, True, "bshd"),
    (1, 130, 8, 2, 64, False, "bhsd"),
    (1, 256, 32, 8, 128, False, "bshd"),
]
K2_MAIN_SHAPE = K2_CASES[0]

# (S = T, H, Hkv, D, causal, layout). The serve phase's offset-0 prefill
# chunks are buckets 32, 128, 128 and 128 (the 256-token budget less one
# token per slot already decoding, rounded down to a bucket); 256 is the
# largest bucket under that budget; 512 is the model phase's sequence; 2048 is
# the served max_seq.
K1_CASES = [
    (16, 32, 8, 128, True, "bshd"),
    (32, 32, 8, 128, True, "bshd"),
    (100, 32, 8, 128, True, "bshd"),
    (128, 32, 8, 128, True, "bshd"),
    (256, 32, 8, 128, True, "bshd"),
    (2048, 32, 8, 128, True, "bshd"),
    (16, 32, 8, 64, True, "bhsd"),
    (100, 32, 8, 64, True, "bhsd"),
    (2048, 32, 8, 64, True, "bhsd"),
    (512, 32, 8, 128, True, "bhsd"),
    (100, 32, 8, 128, False, "bshd"),
]
# K1 at the train phase's shapes, batch included: (B, S, H, Hkv, D, causal, layout).
K1_TRAIN_CASES = [(4, 2048, 32, 8, 64, True, "bhsd"), (8, 1024, 12, 12, 64, True, "bhsd")]

# The train phase's configurations: (model, batch, seq, remat, timed steps).
TRAIN_RUNS = [("llama3-1b", 4, 2048, True, 6), ("gpt2-125m", 8, 1024, False, 6)]
K1_MAIN_SHAPE = (128, 32, 8, 128, True, "bshd")  # 3 of the 4 served offset-0 chunks


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


def phase_build() -> dict:
    from ray_tpu_torch.ops import _build

    names = ["flash_fwd", "flash_bwd"]
    t0 = time.time()
    _build.build(names)
    rec = {"phase": "build", "seconds": round(time.time() - t0, 3), "ptxas": [
        line.strip() for name in names for line in _build.BUILD_LOG.get(name, "").splitlines()
        if "registers" in line or "bytes stack" in line or "Compiling" in line
    ]}
    emit(rec)
    return rec


def k1_case(S, H, Hkv, D, causal, layout, seed=0, B=1) -> dict:
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import flash_forward, flash_forward_reference

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

    if layout == "bshd":
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    else:
        qh, kh, vh = q, k, v
    kernel_ms = time_ms(lambda: flash_forward(q, k, v, causal=causal, scale=scale,
                                              layout=layout))
    plain_ms = time_ms(lambda: flash_forward_reference(q, k, v, causal=causal,
                                                       scale=scale, layout=layout))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, scale=scale, enable_gqa=True))
    bound_ms, bound_by = k1_bound(B, H, Hkv, S, S, D, causal)
    return {
        "phase": "k1", "shape": {"B": B, "S": S, "T": S, "H": H, "Hkv": Hkv, "D": D,
                                 "causal": causal, "layout": layout},
        "out_max_abs_err": float(err.max()), "out_tol": [OUT_ATOL, OUT_RTOL],
        "lse_max_abs_err": lse_err, "lse_tol": LSE_ATOL,
        "ok": out_ok and lse_err <= LSE_ATOL and finite,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
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
    ok = ok and min(fault_rel.values()) > GRAD_REL_L2
    del got, ref, fault
    kernel_ms = time_ms(lambda: flash_backward(q, k, v, out, lse, g, causal=causal,
                                               scale=scale, layout=layout))
    plain_ms = time_ms(lambda: flash_backward_reference(q, k, v, out, lse, g, causal=causal,
                                                        scale=scale, layout=layout), iters=5)
    tr = (lambda t: t.transpose(1, 2)) if layout == "bshd" else (lambda t: t)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(tr(ql), tr(kl), tr(vl), is_causal=causal,
                                              scale=scale, enable_gqa=True)
    library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (ql, kl, vl), tr(g),
                                                     retain_graph=True))
    bound_ms, bound_by = k2_bound(B, H, Hkv, S, S, D, causal)
    return {
        "phase": "k2", "shape": {"B": B, "S": S, "T": S, "H": H, "Hkv": Hkv, "D": D,
                                 "causal": causal, "layout": layout},
        "max_abs_err": errs, "atol_needed_at_rtol": need_atol, "rel_l2": rel,
        "fault_delta_dropped_rel_l2": fault_rel,
        "tol": {"atol": GRAD_ATOL, "rtol": GRAD_RTOL, "rel_l2": GRAD_REL_L2}, "ok": ok,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
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


def phase_serve(margin: float, name: str = "llama3-8b", device: str = "cuda",
                lengths=(20, 100, 255, 300), max_seq: int = 2048,
                seed: int = 1) -> dict:
    """LLMServer(llama3-8b) answers 4 concurrent greedy requests; every served
    token is held against a teacher-forced forward over prompt + answer with
    the engine's plain attention (fresh cache): it must be that forward's
    argmax or within `margin` logits of it (random weights give near-ties
    that bf16 rounding may flip)."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import LLMConfig, LLMServer
    from ray_tpu_torch.llm._engine import _forward_cached
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

    exact = total = 0
    worst_gap = 0.0
    with torch.inference_mode():
        for p, r in zip(prompts, results):
            seq = p + r["token_ids"][:-1]
            L = len(seq)
            shape = (1, L, cfg.n_kv_heads, cfg.head_dim)
            caches = [(torch.zeros(shape, dtype=cfg.dtype, device=eng.device),
                       torch.zeros(shape, dtype=cfg.dtype, device=eng.device))
                      for _ in range(cfg.n_layers)]
            pos = torch.arange(L, device=eng.device)
            mask = (pos[:, None] >= pos[None, :])[None]
            logits = _forward_cached(eng.params, cfg, torch.tensor([seq], device=eng.device),
                                     pos[None], caches, torch.zeros(1, dtype=torch.long,
                                                                   device=eng.device), mask)[0]
            preds = logits[len(p) - 1:]
            served = torch.tensor(r["token_ids"], device=eng.device)
            gap = preds.max(-1).values - preds.gather(-1, served[:, None])[:, 0]
            exact += int((preds.argmax(-1) == served).sum())
            total += len(served)
            worst_gap = max(worst_gap, float(gap.max()))
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
    }
    rec["ok"] = (launches == rec["launches_expected"] and chunks > len(prompts)
                 and all(n == 32 for n in n_tokens) and worst_gap <= margin)
    emit(rec)
    return rec


# Device time by kind of kernel, from the kernel's name.
KERNEL_CLASSES = (
    ("k1", ("flash_fwd_kernel",)),
    ("k2", ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")),
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
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values()) or None
    by_class: dict = {}
    for name, ms in by_name.items():
        by_class[_kernel_class(name)] = by_class.get(_kernel_class(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
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
    import dataclasses

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
    names = _leaf_names(params)
    cfg32 = dataclasses.replace(cfg, attention="reference", dtype=torch.float32)
    loss32, g32 = _grads(Transformer(cfg32, params, device=device), data)
    loss_plain, g = _grads(Transformer(dataclasses.replace(cfg, attention="reference"),
                                       params, device=device), data)
    dl_p32 = _leaf_distances(g, g32)
    del g
    LAUNCHES.update(flash_fwd=0, flash_bwd=0)
    loss_flash, g = _grads(model, data)
    grad_launches = dict(LAUNCHES)
    dl_f32 = _leaf_distances(g, g32)
    d_p32, d_f32 = _l2(dl_p32), _l2(dl_f32)
    attn = [i for i, n in enumerate(names) if "/attn/" in n]
    worst = max(attn, key=lambda i: dl_f32[i] / dl_p32[i])
    attn_leaves_ok = all(dl_f32[i] <= 2.0 * dl_p32[i] for i in attn)
    g32_norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x) for x in g32])))
    finite_grads = all(bool(torch.isfinite(x).all()) for x in g)
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
    flops_per_token = 6 * cfg.num_params() + 12 * cfg.n_layers * cfg.hidden * seq
    mfu = tokens_per_s * flops_per_token / PEAK_BF16_FLOPS
    per_layer = 2 if remat else 1
    expected = {"flash_fwd": per_layer * cfg.n_layers * steps,
                "flash_bwd": cfg.n_layers * steps}
    rec = {
        "phase": "train", "model": name, "layers": cfg.n_layers, "hidden": cfg.hidden,
        "params_b": cfg.num_params() / 1e9, "tokens": [batch, seq], "remat": remat,
        "remat_policy": cfg.remat_policy, "fused_ce": fused, "init_s": init_s,
        "loss_step1": {"flash": loss_flash, "plain": loss_plain, "f32": loss32},
        "grad_l2_dist_plain_vs_f32": d_p32, "grad_l2_dist_flash_vs_f32": d_f32,
        "grad_l2_norm_f32": g32_norm, "grad_tolerance": 2.0 * d_p32,
        "attn_leaves": len(attn),
        "attn_grad_l2_dist_plain_vs_f32": _l2(dl_p32[i] for i in attn),
        "attn_grad_l2_dist_flash_vs_f32": _l2(dl_f32[i] for i in attn),
        "attn_leaf_worst_ratio": {"leaf": names[worst], "flash_vs_f32": dl_f32[worst],
                                  "plain_vs_f32": dl_p32[worst],
                                  "ratio": dl_f32[worst] / dl_p32[worst]},
        "grad_check_launches": grad_launches,
        "losses": losses, "grad_norms": norms, "step_s": times,
        "steady_step_ms": step_s * 1e3, "tokens_per_s": tokens_per_s,
        "model_flops_per_step": flops_per_token * batch * seq, "mfu": mfu,
        "step_bound_ms": flops_per_token * batch * seq / PEAK_BF16_FLOPS * 1e3,
        "launches": launches, "launches_expected": expected, "peak_memory_gb": peak_gb,
        "profile": profile,
    }
    rec["loss_monotone"] = all(b < a for a, b in zip(losses, losses[1:]))
    rec["ok"] = (finite_grads and d_f32 <= 2.0 * d_p32 and attn_leaves_ok
                 and launches == expected
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


def main() -> int:
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
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    head = phase_head()
    model = phase_model()
    serve = phase_serve(margin=model["tolerance"])
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "free", "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    train = [phase_train(*run) for run in TRAIN_RUNS]
    main_rec = next(r for r in k1 if tuple(r["shape"][k] for k in (
        "S", "H", "Hkv", "D", "causal", "layout")) == K1_MAIN_SHAPE and r["shape"]["B"] == 1)
    k2_rec = k2[K2_CASES.index(K2_MAIN_SHAPE)]
    by_path = {"model_llama3-8b": model["launches"], "serve_llama3-8b": serve["launches"]}
    by_path.update({f"train_{r['model']}": r["launches"] for r in train})
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
    failed = [r.get("phase") for r in (*k1, *k2, *head, model, serve, *train)
              if not r["ok"]]
    emit({"phase": "summary", "seconds": time.time() - t_start, "failed": failed})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["device"],
                                 "count": card["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
