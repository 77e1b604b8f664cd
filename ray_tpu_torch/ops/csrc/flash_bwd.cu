// K2 on Hopper: flash-attention backward.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_bwd_fused_kernel
// (launched by _flash_backward through pl.pallas_call). Computes the same
// function, from the forward's out and lse:
//   delta = rowsum(g * out) in f32 (JAX takes it outside its kernel; here a
//           kernel of this library takes it, reading g and out once in bf16)
//   s  = (q . k^T) * scale in f32, entries above the top-left causal diagonal
//        (col > row, both counted from 0) masked out
//   p  = exp(s - lse) in f32
//   dv = p^T . g      with p rounded to bf16, f32 sums
//   dp = g . v^T      f32
//   ds = p * (dp - delta) * scale, rounded to bf16
//   dk = ds^T . q,  dq = ds . k   f32 sums, written in bf16
//
// What bounds it on an H100: per (row, col) pair the mask keeps, the function
// needs 5 products of depth D (10*D flops); at the training shapes (S = T =
// 1024..2048, D = 64) that is far above the card's ~295 flop/byte ridge, so
// the tensor cores bound it.
//
// The TPU kernel walks (k block, q block) in order on one core, keeps dk/dv in
// VMEM scratch across the inner q axis and accumulates dq in an HBM block it
// revisits for every k block. GPU blocks run in no order, so the work is split
// into kernels that each own what they write and sum it in a fixed order: no
// atomics, and a rerun repeats bit for bit. The price is that the dq kernel
// recomputes s and dp (7 products per pair where the bound counts 5). Three
// launches on one stream (helpers in attn_sm90.cuh; mma.sync m16n8k16 bf16
// with f32 sums throughout):
//   delta: D/8 lanes per row, one 16-byte load of g and of out per lane, a
//          shuffle sum; [B,H,S] f32.
//   dkdv:  grid (batch*kv head, 64-row k tile), 4 warps, each owning 16 keys.
//          k tile 0, which the most q tiles see under the causal mask, is
//          launched first. The block loops over the H/Hkv query heads of its
//          kv head and, for each, over the q tiles from the diagonal on
//          (BQ = 64 rows at D = 64, 32 at D = 128); Q, dO, lse and delta
//          arrive through a 2-stage cp.async ring, tile i+1 in flight while
//          tile i is used. The warp computes the transposed products:
//          S^T = K_w.Q^T and dP^T = V_w.dO^T with K_w and V_w as A fragments
//          (held in registers for the whole loop at D = 64, read from shared
//          memory per q tile at D = 128) and Q, dO as B fragments; then P^T
//          and dS^T in the accumulator registers; rounded to bf16 they are the
//          A fragments of dV_w += P^T.dO and dK_w += dS^T.Q (B fragments by
//          ldmatrix.trans). So P and dS never leave registers, and dK, dV stay
//          f32 in registers for the whole loop: GQA's sum over the repeat axis
//          is f32, in registers.
//   dq:    grid (batch*head, 64-row q tile), 4 warps of 16 query rows, last
//          q tiles first. Q and dO are A fragments in registers, lse and
//          delta per row in registers; K and V (BK = 64 keys at D = 64, 32
//          at D = 128) arrive through a 2-stage cp.async ring. S and dP are
//          register accumulators, dS is repacked into A fragments and
//          dQ += dS.K takes K's B fragments from ldmatrix.trans.
//   Epilogues write bf16 through the warp's own rows of a tile in shared
//   memory, with 16-byte stores.
// Tile sizes are set by registers: at D = 128 the dK and dV accumulators take
// 128 f32 per thread, and Q, dO and dQ 128, so the q tile of dkdv and the k
// tile of dq shrink to 32 there. Shared memory: dkdv 2*64*D*2 bytes of K and V
// plus 2 stages of 2*BQ*D*2 bytes and 2*BQ*8 bytes of lse and delta (49 KB at
// D = 64, 64.5 KB at D = 128); dq 2*64*D*2 bytes of Q and dO plus 2 stages of
// 2*BK*D*2 (48 KB at D = 64, 64 KB at D = 128). Registers (ptxas, CUDA 12.8,
// sm_90a; chip_smoke.py's build record prints them): dkdv 226 at D = 64 and
// 246 at D = 128, dq 168 (capped for 3 blocks an SM, which also keeps ptxas
// from spilling) and 234, delta 26; no spills.
//
// What this design does about the costs of the first, wmma-based design:
// (1) S, dP, P and dS never go through shared memory (wmma's opaque layout
// staged each through f32 scratch); (2) loads overlap products (cp.async
// rings, where every tile waited between two barriers); (3) a row lives in a
// quad of lanes and no f32 scratch tile exists: the D = 128 kernels fit in
// registers without spilling (the first dkdv spilled 44 bytes there); (4)
// the heaviest tiles are launched first in both grids, and a warp skips a
// tile that lies wholly on the masked side of its diagonal; (5) delta is one
// bf16 pass in a kernel, not four f32 passes and a transpose in PyTorch; the
// dq pass's recompute stays, for determinism.
//
// Layouts ([B,S,H,D] or [B,H,S,D]) arrive as (batch, head, seq) strides; the
// head dim must be contiguous and rows 16-byte aligned. lse and delta are
// contiguous [B,H,S] f32. Ragged edges: rows past S or T load as zeros, pairs
// past them are masked. Plain C interface, loaded with ctypes; the entry point
// returns cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attn_sm90.cuh"

namespace {

using namespace attn_sm90;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, gb, gh, gs;
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
};

// ------------------------------------------------------------------ delta

template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ g,
                       float* __restrict__ delta, int H, int S, long long rows, Strides st) {
  constexpr int LPR = D / 8;  // lanes per row, 8 values each
  constexpr int RPB = 256 / LPR;
  const long long r = (long long)blockIdx.x * RPB + threadIdx.x / LPR;
  const int c = (threadIdx.x % LPR) * 8;
  float sum = 0.f;
  if (r < rows) {
    const int s = (int)(r % S);
    const long long bh = r / S;
    const int h = (int)(bh % H);
    const long long b = bh / H;
    const uint4 o4 = *reinterpret_cast<const uint4*>(out + b * st.ob + h * st.oh + s * st.os + c);
    const uint4 g4 = *reinterpret_cast<const uint4*>(g + b * st.gb + h * st.gh + s * st.gs + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]);
      const float2 gf = __bfloat1622float2(g2[i]);
      sum = fmaf(of.x, gf.x, sum);
      sum = fmaf(of.y, gf.y, sum);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (r < rows && threadIdx.x % LPR == 0) delta[r] = sum;
}

// ------------------------------------------------------------------ dk, dv

template <int D>
struct KV {
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BK = 16 * WARPS;         // keys per block, 16 per warp
  static constexpr int BQ = D == 64 ? 64 : 32;  // query rows per ring stage
  static constexpr int K_ELEMS = BK * D;
  static constexpr int Q_ELEMS = BQ * D;
  static constexpr size_t SMEM =
      size_t(2 * K_ELEMS + 4 * Q_ELEMS) * sizeof(bf16) + size_t(4 * BQ) * sizeof(float);
};

template <int D>
__device__ __forceinline__ void dkdv_issue(bf16* sQ, bf16* sG, float* sL, float* sDl,
                                           const bf16* q, const bf16* g, const float* lse,
                                           const float* delta, const Strides& st, int b, int h,
                                           int H, int S, int q0) {
  using P = KV<D>;
  load_tile_async<P::BQ, D, P::THREADS>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_tile_async<P::BQ, D, P::THREADS>(sG, g + b * st.gb + h * st.gh, st.gs, q0, S);
  if (threadIdx.x < P::BQ) {
    const int row = q0 + threadIdx.x;
    const bool ok = row < S;
    const long long at = ((long long)b * H + h) * S + (ok ? row : 0);
    cp_async_4(smem_u32(sL + threadIdx.x), lse + at, ok);
    cp_async_4(smem_u32(sDl + threadIdx.x), delta + at, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(KV<D>::THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int S,
                      int T, Strides st, float scale, int causal) {
  using P = KV<D>;
  constexpr int BQ = P::BQ;
  constexpr int BK = P::BK;
  constexpr int THREADS = P::THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + P::K_ELEMS;
  bf16* sQ = sV + P::K_ELEMS;       // [2][BQ, D]
  bf16* sG = sQ + 2 * P::Q_ELEMS;   // [2][BQ, D]
  float* sL = reinterpret_cast<float*>(sG + 2 * P::Q_ELEMS);  // [2][BQ]
  float* sDl = sL + 2 * BQ;                                   // [2][BQ]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BK;  // k tile 0 first: it has the most q tiles
  const int rep = H / Hkv;
  const int kw = k0 + warp * 16;   // this warp's first key
  const float scale_log2 = scale * LOG2E;

  load_tile_async<BK, D, THREADS>(sK, k + b * st.kb + hk * st.kh, st.ks, k0, T);
  load_tile_async<BK, D, THREADS>(sV, v + b * st.vb + hk * st.vh, st.vs, k0, T);
  cp_async_commit();

  const int nq = (S + BQ - 1) / BQ;
  // Top-left causal: rows before k0 see none of this tile's keys.
  const int i0 = causal ? min(nq, k0 / BQ) : 0;
  const int per_head = nq - i0;
  const int n_iter = rep * per_head;
  if (n_iter > 0) dkdv_issue<D>(sQ, sG, sL, sDl, q, g, lse, delta, st, b, hk * rep, H, S, i0 * BQ);
  cp_async_commit();

  // At D = 64 the warp's K and V rows live in registers as A fragments for
  // the whole loop; at D = 128 the registers go to dK and dV, and the
  // fragments are read from shared memory for each q tile.
  const uint32_t off_a = lane_off_a<D>(lane);
  const uint32_t off_br = lane_off_b_rows<D>(lane);
  const uint32_t off_bc = lane_off_b_cols<D>(lane);
  const uint32_t uK = smem_u32(sK);
  const uint32_t uV = smem_u32(sV);
  constexpr bool KV_IN_REGS = D == 64;
  uint32_t kf[KV_IN_REGS ? D / 16 : 1][4], vf[KV_IN_REGS ? D / 16 : 1][4];
  if constexpr (KV_IN_REGS) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      load_a<D>(kf[kk], uK, off_a, warp * 16, kk * 16);
      load_a<D>(vf[kk], uV, off_a, warp * 16, kk * 16);
    }
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      const int nxt = (it + 1) & 1;
      const int hn = hk * rep + (it + 1) / per_head;
      const int qn = (i0 + (it + 1) % per_head) * BQ;
      dkdv_issue<D>(sQ + nxt * P::Q_ELEMS, sG + nxt * P::Q_ELEMS, sL + nxt * BQ,
                    sDl + nxt * BQ, q, g, lse, delta, st, b, hn, H, S, qn);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int q0 = (i0 + it % per_head) * BQ;
    if (!(causal && q0 + BQ - 1 < kw)) {  // else every row of the tile precedes the warp's keys
      const int cur = it & 1;
      const uint32_t cQ = smem_u32(sQ + cur * P::Q_ELEMS);
      const uint32_t cG = smem_u32(sG + cur * P::Q_ELEMS);
      const float* cL = sL + cur * BQ;
      const float* cDl = sDl + cur * BQ;

      // S^T = K_w . Q^T and dP^T = V_w . dO^T, [16 keys, BQ rows].
      float sT[BQ / 8][4], dpT[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        if constexpr (KV_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i] = kf[kk][i];
            av[i] = vf[kk][i];
          }
        } else {
          load_a<D>(ak, uK, off_a, warp * 16, kk * 16);
          load_a<D>(av, uV, off_a, warp * 16, kk * 16);
        }
#pragma unroll
        for (int np = 0; np < BQ / 16; ++np) {
          uint32_t bq[4], bg[4];
          load_b_rows<D>(bq, cQ, off_br, np * 16, kk * 16);
          load_b_rows<D>(bg, cG, off_br, np * 16, kk * 16);
          mma_16816(sT[2 * np], ak, bq[0], bq[1]);
          mma_16816(sT[2 * np + 1], ak, bq[2], bq[3]);
          mma_16816(dpT[2 * np], av, bg[0], bg[1]);
          mma_16816(dpT[2 * np + 1], av, bg[2], bg[3]);
        }
      }

      // P^T and dS^T in place; element (key kw + gq + 8*(e/2), row q0 + col).
      const bool edge = (causal && q0 < kw + 15) || q0 + BQ > S;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const int col = n * 8 + 2 * t;
        const float2 L = *reinterpret_cast<const float2*>(cL + col);
        const float2 Dl = *reinterpret_cast<const float2*>(cDl + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_e = (e & 1) ? L.y : L.x;
          const float dl_e = (e & 1) ? Dl.y : Dl.x;
          float p = fast_exp2(fmaf(sT[n][e], scale_log2, -lse_e * LOG2E));
          if (edge) {
            const int row = q0 + col + (e & 1);
            const int key = kw + gq + (e >> 1) * 8;
            if (row >= S || (causal && key > row)) p = 0.f;
          }
          sT[n][e] = p;
          dpT[n][e] = p * (dpT[n][e] - dl_e) * scale;
        }
      }

      // dV_w += P^T . dO and dK_w += dS^T . Q, A fragments from registers.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], ads[4];
        a_from_c(ap, sT[2 * kk], sT[2 * kk + 1]);
        a_from_c(ads, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bg[4], bq[4];
          load_b_cols<D>(bg, cG, off_bc, kk * 16, np * 16);
          load_b_cols<D>(bq, cQ, off_bc, kk * 16, np * 16);
          mma_16816(dv_acc[2 * np], ap, bg[0], bg[1]);
          mma_16816(dv_acc[2 * np + 1], ap, bg[2], bg[3]);
          mma_16816(dk_acc[2 * np], ads, bq[0], bq[1]);
          mma_16816(dk_acc[2 * np + 1], ads, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  cp_async_wait<0>();  // with no q tile, the K/V copies may still be landing
  __syncthreads();
  // The warp's own rows of the K and V tiles are free now.
  stage_rows<D>(sK, dk_acc, warp * 16, 1.f, 1.f, lane);
  stage_rows<D>(sV, dv_acc, warp * 16, 1.f, 1.f, lane);
  __syncwarp();
  store_rows<D>(dk + b * st.dkb + hk * st.dkh, st.dks, sK, warp * 16, kw, T, lane);
  store_rows<D>(dv + b * st.dvb + hk * st.dvh, st.dvs, sV, warp * 16, kw, T, lane);
}

// ------------------------------------------------------------------ dq

template <int D>
struct Q {
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;         // query rows per block, 16 per warp
  static constexpr int BK = D == 64 ? 64 : 32;  // keys per ring stage
  static constexpr int Q_ELEMS = BQ * D;
  static constexpr int K_ELEMS = BK * D;
  static constexpr size_t SMEM = size_t(2 * Q_ELEMS + 4 * K_ELEMS) * sizeof(bf16);
};

// At D = 64, 3 blocks an SM (at most 168 registers) fit without spilling.
template <int D>
__global__ void __launch_bounds__(Q<D>::THREADS, D == 64 ? 3 : 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Hkv, int S, int T, Strides st,
                    float scale, int causal) {
  using P = Q<D>;
  constexpr int BQ = P::BQ;
  constexpr int BK = P::BK;
  constexpr int THREADS = P::THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + P::Q_ELEMS;
  bf16* sK = sG + P::Q_ELEMS;       // [2][BK, D]
  bf16* sV = sK + 2 * P::K_ELEMS;   // [2][BK, D]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last q tiles first
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int qw = q0 + warp * 16;  // this warp's first query row
  const float scale_log2 = scale * LOG2E;

  const bf16* kb = k + b * st.kb + hk * st.kh;
  const bf16* vb = v + b * st.vb + hk * st.vh;
  load_tile_async<BQ, D, THREADS>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_tile_async<BQ, D, THREADS>(sG, g + b * st.gb + h * st.gh, st.gs, q0, S);
  cp_async_commit();
  load_tile_async<BK, D, THREADS>(sK, kb, st.ks, 0, T);
  load_tile_async<BK, D, THREADS>(sV, vb, st.vs, 0, T);
  cp_async_commit();

  // lse (as a log2 offset) and delta of rows gq and gq + 8.
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + gq + 8 * i;
    const long long at = (long long)bh * S + row;
    lse2[i] = row < S ? lse[at] * LOG2E : 0.f;
    dl[i] = row < S ? delta[at] : 0.f;
  }

  const uint32_t off_a = lane_off_a<D>(lane);
  const uint32_t off_br = lane_off_b_rows<D>(lane);
  const uint32_t off_bc = lane_off_b_cols<D>(lane);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<D>(qf[kk], smem_u32(sQ), off_a, warp * 16, kk * 16);
    load_a<D>(gf[kk], smem_u32(sG), off_a, warp * 16, kk * 16);
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  const int n_kt = (T + BK - 1) / BK;
  const int n_visible = causal ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt;
  for (int j = 0; j < n_visible; ++j) {
    if (j + 1 < n_visible) {
      const int nxt = (j + 1) & 1;
      load_tile_async<BK, D, THREADS>(sK + nxt * P::K_ELEMS, kb, st.ks, (j + 1) * BK, T);
      load_tile_async<BK, D, THREADS>(sV + nxt * P::K_ELEMS, vb, st.vs, (j + 1) * BK, T);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int k0 = j * BK;
    if (!(causal && k0 > qw + 15)) {  // else the whole tile is above this warp's diagonal
      const uint32_t cK = smem_u32(sK + (j & 1) * P::K_ELEMS);
      const uint32_t cV = smem_u32(sV + (j & 1) * P::K_ELEMS);

      // S = Q_w . K^T and dP = dO_w . V^T, [16 rows, BK keys].
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t bk[4], bv[4];
          load_b_rows<D>(bk, cK, off_br, np * 16, kk * 16);
          load_b_rows<D>(bv, cV, off_br, np * 16, kk * 16);
          mma_16816(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          mma_16816(dp[2 * np], gf[kk], bv[0], bv[1]);
          mma_16816(dp[2 * np + 1], gf[kk], bv[2], bv[3]);
        }
      }

      const bool edge = k0 + BK > T || (causal && k0 + BK - 1 > qw);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
          if (edge) {
            const int col = k0 + n * 8 + 2 * t + (e & 1);
            const int row = qw + gq + (e >> 1) * 8;
            if (col >= T || (causal && col > row)) p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - dl[e >> 1]) * scale;
        }
      }

      // dQ_w += dS . K, dS from registers.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a_from_c(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bk[4];
          load_b_cols<D>(bk, cK, off_bc, kk * 16, np * 16);
          mma_16816(dq_acc[2 * np], a, bk[0], bk[1]);
          mma_16816(dq_acc[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // The warp's own rows of the Q tile are free once Q is in registers.
  stage_rows<D>(sQ, dq_acc, warp * 16, 1.f, 1.f, lane);
  __syncwarp();
  store_rows<D>(dq + b * st.dqb + h * st.dqh, st.dqs, sQ, warp * 16, qw, S, lane);
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out, const void* g,
                   const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H,
                   int Hkv, int S, int T, const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory needs the opt-in, once per device
  // and kernel; setting it twice from racing threads is harmless.
  static int configured_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (configured_device != device) {
    err = allow_smem(flash_bwd_dkdv_kernel<D>, KV<D>::SMEM);
    if (err != cudaSuccess) return err;
    err = allow_smem(flash_bwd_dq_kernel<D>, Q<D>::SMEM);
    if (err != cudaSuccess) return err;
    configured_device = device;
  }
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* gp = static_cast<const bf16*>(g);
  const auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<float*>(delta);

  const long long rows = (long long)B * H * S;
  constexpr int RPB = 256 / (D / 8);
  flash_bwd_delta_kernel<D><<<(unsigned)((rows + RPB - 1) / RPB), 256, 0, stream>>>(
      static_cast<const bf16*>(out), gp, dp, H, S, rows, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_kv(B * Hkv, (T + KV<D>::BK - 1) / KV<D>::BK);
  flash_bwd_dkdv_kernel<D><<<grid_kv, KV<D>::THREADS, KV<D>::SMEM, stream>>>(
      qp, kp, vp, gp, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, S, T, st,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_q(B * H, (S + Q<D>::BQ - 1) / Q<D>::BQ);
  flash_bwd_dq_kernel<D><<<grid_q, Q<D>::THREADS, Q<D>::SMEM, stream>>>(
      qp, kp, vp, gp, lp, dp, static_cast<bf16*>(dq), H, Hkv, S, T, st, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// The launch's arguments in one block, 8 bytes a field, packed by the caller
// (ops/attention.py, `_BWD_ARGS`).
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* g;
  const void* lse;
  void* delta;
  void* dq;
  void* dk;
  void* dv;
  long long B, H, Hkv, S, T, D;
  Strides st;  // q, k, v, out, g, dq, dk, dv: (batch, head, seq) each
  double scale;
  long long causal;
};
static_assert(sizeof(BwdArgs) == 42 * 8, "BwdArgs must match ops/attention.py:_BWD_ARGS");

extern "C" int ray_tpu_torch_flash_bwd(const void* packed, void* stream) {
  BwdArgs args;  // copied out: the caller's buffer need not be 8-byte aligned
  memcpy(&args, packed, sizeof args);
  const BwdArgs* a = &args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = (int)a->B, H = (int)a->H, Hkv = (int)a->Hkv, S = (int)a->S, T = (int)a->T;
  const float scale = (float)a->scale;
  const int causal = (int)a->causal;
  cudaError_t err;
  if (a->D == 64) {
    err = launch<64>(a->q, a->k, a->v, a->out, a->g, a->lse, a->delta, a->dq, a->dk, a->dv, B,
                     H, Hkv, S, T, a->st, scale, causal, s);
  } else if (a->D == 128) {
    err = launch<128>(a->q, a->k, a->v, a->out, a->g, a->lse, a->delta, a->dq, a->dk, a->dv, B,
                      H, Hkv, S, T, a->st, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* ray_tpu_torch_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
