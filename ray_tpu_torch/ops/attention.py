"""Attention ops: the flash-attention kernels (K1 forward, K2 backward) and
the plain paths.

Twin of `ray_tpu/ops/attention.py`. On the TPU the forward is the Pallas
kernel `_flash_fwd_kernel` and the backward `_flash_bwd_fused_kernel`; here
they are the hand-written Hopper kernels in `csrc/flash_fwd.cu` and
`csrc/flash_bwd.cu` (CUDA C++ for sm_90a, loaded with ctypes). The wrappers
`flash_forward` and `flash_backward` launch those kernels for CUDA tensors,
and for CPU tensors take `flash_forward_reference` and
`flash_backward_reference`, the same functions in plain PyTorch. There is no
fallback from a kernel to its plain version on the GPU: a tensor the kernel
does not take raises.

The two wrappers are registered as the custom ops `ray_tpu_torch::flash_fwd`
(returning out and lse) and `ray_tpu_torch::flash_bwd`, with `flash_bwd` as
`flash_fwd`'s gradient and the residuals of JAX's `_flash_fwd_rule`
(q, k, v, out, lse). Being dispatched ops, both are visible to a
selective-checkpoint policy (`torch.utils.checkpoint`): the `selective`
remat policy keeps `flash_fwd`'s outputs, JAX's `flash_residuals`, so K1 is
not rerun in the backward pass. `flash_attention` and `flash_attention_bhsd`
call `flash_fwd`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30

# Launch counts of the port's kernels: each wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}
# Runs of the custom ops `flash_fwd` and `flash_bwd` on any device: what
# LAUNCHES counts on the GPU, and what the CPU tests count (they run the
# plain versions). A selective-checkpoint replay of saved outputs does not
# run the op and counts nothing in either.
CALLS = {"flash_fwd": 0, "flash_bwd": 0}


def _use_kernel(t: torch.Tensor) -> bool:
    """Counterpart of ray_tpu's `_use_pallas()`: the kernel runs exactly when
    the tensor lives on the GPU."""
    return t.is_cuda


def reference_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                        positions_q=None, positions_kv=None):
    """Plain attention. q:[B,S,H,D] k/v:[B,T,Hkv,D] -> [B,S,H,D]."""
    out, _ = _attention_with_lse(q, k, v, causal=causal, scale=scale,
                                 positions_q=positions_q, positions_kv=positions_kv)
    return out


def _attention_with_lse(q, k, v, *, causal, scale, positions_q=None, positions_kv=None):
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        # jnp.repeat order: query head h reads kv head h // rep.
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if causal:
        pos_q = positions_q if positions_q is not None else torch.arange(S, device=q.device)
        pos_k = positions_kv if positions_kv is not None else torch.arange(T, device=q.device)
        mask = pos_q[:, None] >= pos_k[None, :]
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)  # [B,H,S]
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v)
    return out, lse


# ------------------------------------------------------------------ K1 kernel

def _to_bhsd(q, k, v, layout):
    if layout == "bshd":
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if layout == "bhsd":
        return q, k, v
    raise ValueError(f"layout must be 'bshd' or 'bhsd', got {layout!r}")


def flash_forward_reference(q, k, v, *, causal: bool, scale: float,
                            layout: str = "bshd") -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch: the same contract as `flash_forward`.

    Logits in f32 (products of the inputs are exact in f32), -1e30 above the
    top-left causal diagonal, p = exp(s - max) rounded to v's dtype before
    p.v with an f32 sum, then out = acc / max(l, 1e-30) in the input dtype
    and lse = max + log(max(l, 1e-30)) in f32."""
    qh, kh, vh = _to_bhsd(q, k, v, layout)
    B, H, S, D = qh.shape
    Hkv, T = kh.shape[1], kh.shape[2]
    if Hkv != H:
        kh = kh.repeat_interleave(H // Hkv, dim=1)
        vh = vh.repeat_interleave(H // Hkv, dim=1)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale  # [B,H,S,T]
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), vh.float())
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    if layout == "bshd":
        out = out.transpose(1, 2).contiguous()
    return out, lse


@functools.lru_cache(maxsize=None)
def _flash_lib():
    """K1's library, built at first use, with its C signatures declared: the
    launch's arguments packed into one block (`_FWD_ARGS`) and the stream as
    c_void_p (as an int, ctypes would cut it to 32 bits)."""
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    lib.ray_tpu_torch_flash_fwd.restype = ctypes.c_int
    lib.ray_tpu_torch_flash_fwd.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.ray_tpu_torch_cuda_error_string.restype = ctypes.c_char_p
    lib.ray_tpu_torch_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


# The kernels' argument blocks (FwdArgs, BwdArgs in csrc/): pointers, then
# extents and (batch, head, seq) strides, scale, causal; 8 bytes a field.
_FWD_ARGS = struct.Struct("<5Q6q12qdq")
_BWD_ARGS = struct.Struct("<10Q6q24qdq")
_FWD_FN = None


def _flash_fwd_fn():
    """K1's bound entry point, looked up once."""
    global _FWD_FN
    if _FWD_FN is None:
        _FWD_FN = _flash_lib().ray_tpu_torch_flash_fwd
    return _FWD_FN


def _aligned(t: torch.Tensor) -> bool:
    return t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:-1]) and not t.data_ptr() % 16


def _kernel_operand(fn: str, name: str, t: torch.Tensor, device):
    """t's data pointer and strides, after the checks a kernel operand needs:
    on q's device, bfloat16, a contiguous head dim and 16-byte aligned rows."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(
            f"{fn}: the CUDA kernel takes bfloat16 operands; {name} is "
            f"{t.dtype}. Cast to bfloat16 (f32 runs only through the CPU path)."
        )
    st, ptr = t.stride(), t.data_ptr()
    if st[3] != 1 or ptr % 16 or (st[0] | st[1] | st[2]) % 8:
        raise ValueError(
            f"{fn}: {name} needs a contiguous head dim and 16-byte "
            f"aligned rows (strides {st})"
        )
    return ptr, st


def _kernel_dims(q, k, v, layout, fn):
    """(B, H, Hkv, S, T, D, s_dim, h_dim) of a kernel call, after the checks
    both kernels share: agreeing shapes, head_dim 64 or 128, Hkv dividing H."""
    if layout == "bshd":
        B, S, H, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        s_dim, h_dim = 1, 2
    elif layout == "bhsd":
        B, H, S, D = q.shape
        Hkv, T = k.shape[1], k.shape[2]
        s_dim, h_dim = 2, 1
    else:
        raise ValueError(f"layout must be 'bshd' or 'bhsd', got {layout!r}")
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B or k.shape[-1] != D:
        raise ValueError(f"{fn}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree ({layout})")
    if D not in (64, 128):
        raise ValueError(f"{fn}: the CUDA kernel takes head_dim 64 or 128, got {D}")
    if Hkv <= 0 or H % Hkv:
        raise ValueError(f"{fn}: {H} query heads over {Hkv} kv heads")
    if S <= 0 or T <= 0 or max(S, T) > 32 * 65535:  # a grid dimension counts tiles
        raise ValueError(f"{fn}: unsupported extent S={S} T={T}")
    return B, H, Hkv, S, T, D, s_dim, h_dim


def _launch(device: torch.device, fn, *args):
    """Calls a kernel library's entry point with `device` current and its
    current stream as the last argument; enters `torch.cuda.device` only when
    another device is current (the served chunks are launch-bound, so the
    common case stays cheap)."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _flash_forward_cuda(q, k, v, *, causal, scale, layout):
    fn = "flash_forward"
    B, H, Hkv, S, T, D, s_dim, h_dim = _kernel_dims(q, k, v, layout, fn)
    device = q.device
    qp, qst = _kernel_operand(fn, "q", q, device)
    kp, kst = _kernel_operand(fn, "k", k, device)
    vp, vst = _kernel_operand(fn, "v", v, device)
    out = torch.empty(q.shape, dtype=q.dtype, device=device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=device)
    ost = out.stride()
    err = _launch(device, _flash_fwd_fn(), _FWD_ARGS.pack(
        qp, kp, vp, out.data_ptr(), lse.data_ptr(), B, H, Hkv, S, T, D,
        qst[0], qst[h_dim], qst[s_dim], kst[0], kst[h_dim], kst[s_dim],
        vst[0], vst[h_dim], vst[s_dim], ost[0], ost[h_dim], ost[s_dim],
        scale, bool(causal)))
    if err:
        msg = _flash_lib().ray_tpu_torch_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_forward(q, k, v, *, causal: bool, scale: float,
                  layout: str = "bshd") -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 wrapper, the contract of ray_tpu's `_flash_forward`.

    q:[B,S,H,D] k/v:[B,T,Hkv,D] (layout="bshd") or q:[B,H,S,D]
    k/v:[B,Hkv,T,D] (layout="bhsd") -> (out in q's layout, lse [B,H,S] f32).
    kv heads may be pre-expanded (Hkv == H) or not: query head h reads kv
    head h // (H // Hkv) either way. Layouts are taken through strides; no
    transpose is copied. CUDA tensors launch the kernel (bf16, head_dim 64 or
    128) or raise; CPU tensors take `flash_forward_reference`."""
    if not _use_kernel(q):
        return flash_forward_reference(q, k, v, causal=causal, scale=scale, layout=layout)
    return _flash_forward_cuda(q, k, v, causal=causal, scale=scale, layout=layout)


# ------------------------------------------------------------------ K2 kernel

def flash_backward_reference(q, k, v, out, lse, g, *, causal: bool, scale: float,
                             layout: str = "bshd"):
    """K2's function in plain PyTorch: the same contract as `flash_backward`.

    The numerics of ray_tpu's `_flash_bwd_fused_kernel`: s = q.k^T * scale in
    f32 with -1e30 above the top-left causal diagonal; p = exp(s - lse) in
    f32; dv = p^T.g with p rounded to v's dtype; dp = g.v^T;
    ds = p * (dp - delta) * scale rounded to q's dtype; dk = ds^T.q;
    dq = ds.k; products summed in f32. delta = rowsum(g * out) in f32, taken
    outside the kernel as `_flash_backward` does, and g is cast to q's dtype.
    GQA (Hkv < H): query head h reads kv head h // (H // Hkv), and dk/dv are
    summed over the repeat axis in f32 before the cast to k's and v's dtype.
    Returns (dq, dk, dv) in q's, k's and v's dtype and layout."""
    qh, kh, vh = _to_bhsd(q, k, v, layout)
    gh, oh = (g.transpose(1, 2), out.transpose(1, 2)) if layout == "bshd" else (g, out)
    B, H, S, D = qh.shape
    Hkv, T = kh.shape[1], kh.shape[2]
    rep = H // Hkv
    if rep > 1:
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    delta = (gh.float() * oh.float()).sum(-1, keepdim=True)  # [B,H,S,1]
    g32 = gh.to(q.dtype).float()
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale  # [B,H,S,T]
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask, s, _NEG_INF)
    p = torch.exp(s - lse.float()[..., None])
    del s
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), g32)  # [B,H,T,D]
    dp = torch.matmul(g32, vh.float().transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    del p, dp
    dk = torch.matmul(ds.transpose(-1, -2), qh.float())
    dq = torch.matmul(ds, kh.float())
    if rep > 1:
        dk = dk.view(B, Hkv, rep, T, D).sum(2)
        dv = dv.view(B, Hkv, rep, T, D).sum(2)
    dq, dk, dv = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if layout == "bshd":
        dq, dk, dv = (t.transpose(1, 2).contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _flash_bwd_lib():
    """K2's library, built at first use (see `_flash_lib`)."""
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    lib.ray_tpu_torch_flash_bwd.restype = ctypes.c_int
    lib.ray_tpu_torch_flash_bwd.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.ray_tpu_torch_flash_bwd_error_string.restype = ctypes.c_char_p
    lib.ray_tpu_torch_flash_bwd_error_string.argtypes = [ctypes.c_int]
    return lib


def _flash_backward_cuda(q, k, v, out, lse, g, *, causal, scale, layout):
    fn = "flash_backward"
    B, H, Hkv, S, T, D, s_dim, h_dim = _kernel_dims(q, k, v, layout, fn)
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"{fn}: out {tuple(out.shape)} and g {tuple(g.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"{fn}: lse must be f32 [B,H,S] = {(B, H, S)} on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    g = g.to(q.dtype)
    if not _aligned(g):
        g = g.contiguous()  # autograd may hand over an expanded or odd-strided grad
    device = q.device
    ops = [_kernel_operand(fn, name, t, device)
           for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("g", g))]
    lse = lse.contiguous()
    # delta = rowsum(g * out), [B,H,S] f32: computed by the library's first kernel.
    delta = torch.empty((B, H, S), dtype=torch.float32, device=device)
    grads = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in (q, k, v)]
    lib = _flash_bwd_lib()
    ptrs = [p for p, _ in ops] + [lse.data_ptr(), delta.data_ptr()] + [t.data_ptr() for t in grads]
    strides = [st for _, st in ops] + [t.stride() for t in grads]
    err = _launch(device, lib.ray_tpu_torch_flash_bwd, _BWD_ARGS.pack(
        *ptrs, B, H, Hkv, S, T, D, *(x for st in strides for x in (st[0], st[h_dim], st[s_dim])),
        scale, bool(causal)))
    if err:
        msg = lib.ray_tpu_torch_flash_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES["flash_bwd"] += 1
    return tuple(grads)


def flash_backward(q, k, v, out, lse, g, *, causal: bool, scale: float,
                   layout: str = "bshd"):
    """K2 wrapper, the contract of ray_tpu's `_flash_backward` with GQA
    folded in: q/out/g in q's layout, k/v with Hkv heads (Hkv divides H),
    lse [B,H,S] f32 from the forward -> (dq, dk, dv) in q's, k's and v's
    dtype and layout, dk/dv already summed over each kv head's query heads.
    CUDA tensors launch the kernel (bf16, head_dim 64 or 128) or raise; CPU
    tensors take `flash_backward_reference`."""
    if not _use_kernel(q):
        return flash_backward_reference(q, k, v, out, lse, g, causal=causal, scale=scale,
                                        layout=layout)
    return _flash_backward_cuda(q, k, v, out, lse, g, causal=causal, scale=scale,
                                layout=layout)


# ------------------------------------------------------------------ custom ops

@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  scale: float, layout: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_forward` as a dispatched op: (out, lse)."""
    CALLS["flash_fwd"] += 1
    return flash_forward(q, k, v, causal=causal, scale=scale, layout=layout)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, scale, layout):
    B, H, S = (q.shape[0], q.shape[2], q.shape[1]) if layout == "bshd" else q.shape[:3]
    return q.new_empty(q.shape), q.new_empty((B, H, S), dtype=torch.float32)


@torch.library.custom_op("ray_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  lse: torch.Tensor, g: torch.Tensor, causal: bool, scale: float,
                  layout: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`flash_backward` as a dispatched op: (dq, dk, dv)."""
    CALLS["flash_bwd"] += 1
    return flash_backward(q, k, v, out, lse, g, causal=causal, scale=scale, layout=layout)


@_flash_bwd_op.register_fake
def _(q, k, v, out, lse, g, causal, scale, layout):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, causal, scale, layout = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.scale, ctx.layout = causal, scale, layout


def _flash_fwd_grad(ctx, g, _g_lse):
    # lse is a residual, never differentiated (JAX's flash_attention returns
    # out alone), so its cotangent is ignored.
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_op(q, k, v, out, lse, g, ctx.causal, ctx.scale, ctx.layout)
    return dq, dk, dv, None, None, None


_flash_fwd_op.register_autograd(_flash_fwd_grad, setup_context=_flash_fwd_setup)

# The op a selective-checkpoint policy keeps to spare K1's rerun.
FLASH_FWD_OP = torch.ops.ray_tpu_torch.flash_fwd.default


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Flash attention. q:[B,S,H,D], k/v:[B,T,Hkv,D] (GQA: Hkv divides H).
    Under a non-reentrant checkpoint that does not keep `flash_fwd`'s
    outputs, the forward reruns in the backward pass and K2 reads the lse of
    that rerun."""
    eff_scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _flash_fwd_op(q, k, v, causal, eff_scale, "bshd")[0]


def flash_attention_bhsd(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Flash attention in the kernel's native layout: q:[B,H,S,D],
    k/v:[B,Hkv,T,D] -> [B,H,S,D]."""
    eff_scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _flash_fwd_op(q, k, v, causal, eff_scale, "bhsd")[0]
