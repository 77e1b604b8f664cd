// K1 on Hopper: flash-attention forward.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel (launched
// by _flash_forward through pl.pallas_call). Computes the same function:
//   s   = (q . k^T) * scale in f32, with entries above the top-left causal
//         diagonal (col > row, both counted from 0) masked out
//   out = softmax(s) . v, with p rounded to bf16 before p . v and the
//         product accumulated in f32; out in bf16
//   lse = m + log(max(l, 1e-30)) in f32 (natural log), one value per query row
//
// What bounds it on an H100: per (row, col) pair the mask keeps it does two
// products of depth D (4*D flops) against q, k, v read and out written once;
// at S = T >= 512 that is far above the card's ~295 flop/byte ridge, so the
// tensor cores bound it. The served chunks (S = 16..256) are bound by the
// host's launch path and one block's latency (at most four k/v tiles).
//
// Design (FlashAttention-2's shape on mma.sync m16n8k16, helpers in
// attn_sm90.cuh):
//   - Grid (batch*head, q tile); q tiles are launched last-first, so those
//     with the most k/v tiles under the causal mask start first. A block has
//     4 warps; each warp owns MT m-tiles of 16 query rows. BK = 64 keys per
//     k/v tile. D = 64: MT = 2 (BQ = 128 rows a block), so every K and V
//     fragment read from shared memory feeds two products. D = 128: MT = 1
//     (BQ = 64), because O alone takes 64 registers per m-tile. When that grid
//     has fewer blocks than the card has SMs (a served chunk: S = 128 over 32
//     heads is 32 blocks of 128 rows or 64 of 64), blocks of 2 warps and 32
//     rows are launched instead.
//   - The Q tile arrives by cp.async and is held as A fragments in registers
//     (MT x D/16 x 4 b32) for the whole loop. K and V flow through a 2-stage
//     cp.async ring: tile j+1 is in flight while tile j is used.
//   - S = Q.K^T accumulates in registers (8 C tiles of 16 x 8 per m-tile).
//     The online softmax (max, exp2 with scale*log2(e) folded in, row sums)
//     runs on those registers with quad shuffles; the mask is applied only on
//     k/v tiles that cross the diagonal or the ragged end. Tiles wholly above
//     a warp's diagonal are skipped by that warp, and those above the block's
//     are never loaded.
//   - P is rounded to bf16 and repacked in registers into A fragments of
//     O += P.V; V's B fragments come from ldmatrix.trans. O stays f32 in
//     registers (D/8 C tiles per m-tile).
//   - Epilogue: O / l as bf16 through the warp's own rows of a tile in shared
//     memory, then 16-byte stores; lse from the row's max and sum.
// Shared memory: 2 stages x (K, V) tiles, bf16, swizzled (no padding); the Q
// tile is first loaded into stage 1, which it leaves for registers before
// the ring refills it: 4 * 64 * D * 2 bytes = 32 KB at D = 64 and 64 KB at
// D = 128. Registers (ptxas, CUDA 12.8, sm_90a; chip_smoke.py's build record
// prints them): 254 at <D=64, 4 warps, MT=2>, 175 at <128, 4, 1>, 138 and
// 224 at the 2-warp blocks; no spills. That is 2 blocks (8 warps) an SM in
// the training and long-prefill shapes.
//
// What this design does about the costs of the first, wmma-based design:
// (1) S, P and P.V never go through shared memory: wmma's opaque layout
// forced three round trips per k/v tile and warp; (2) loads overlap the
// products through the cp.async ring, where every tile waited between two
// barriers; (3) a row lives in a quad of lanes with its S in mma C tiles,
// not a lane pair walking 32 columns, and the block needs 64 KB at D = 128,
// not 93 KB; (4) the heaviest q tiles start first, and at D = 64 each block
// covers 128 rows, halving the K/V reads per row; (5) K1 does no redundant
// products, and its wrapper was trimmed to checks, two allocations and one
// call with the arguments packed in one block (see ops/attention.py).
//
// GQA: query head h reads kv head h / (H / Hkv), the order jnp.repeat gives.
// Layouts ([B,S,H,D] or [B,H,S,D]) arrive as (batch, head, seq) strides; the
// head dim must be contiguous and rows 16-byte aligned. Rows past S or T load
// as zeros; columns past T are masked. Plain C interface, loaded with ctypes;
// the entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attn_sm90.cuh"

namespace {

using namespace attn_sm90;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;  // keys per k/v tile
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// A block of WARPS warps, each owning MT m-tiles of 16 query rows.
template <int D, int WARPS, int MT>
struct Fwd {
  static constexpr int BQ = 16 * MT * WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int KV_ELEMS = BK * D;
  // Two ring stages of (K, V); the Q tile is first loaded into stage 1.
  static constexpr size_t SMEM = size_t(4 * KV_ELEMS) * sizeof(bf16);
  static_assert(BQ <= 2 * BK, "the Q tile must fit in one ring stage");
};

template <int D, int WARPS, int MT>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int Hkv, int S, int T, Strides st, float scale, int causal) {
  using F = Fwd<D, WARPS, MT>;
  constexpr int BQ = F::BQ;
  constexpr int THREADS = F::THREADS;
  constexpr int STAGE = 2 * F::KV_ELEMS;  // elements of one (K, V) stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage s: K at s*STAGE, V after it
  bf16* sQ = ring + STAGE;                         // [BQ, D], until Q is in registers

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last q tiles first
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const float scale_log2 = scale * LOG2E;

  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + hk * st.kh;
  const bf16* vb = v + b * st.vb + hk * st.vh;

  const int n_kt = (T + BK - 1) / BK;
  // With top-left causal masking, k tiles past the block's last row are empty.
  const int n_visible = causal ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt;

  load_tile_async<BQ, D, THREADS>(sQ, qb, st.qs, q0, S);
  cp_async_commit();
  load_tile_async<BK, D, THREADS>(ring, kb, st.ks, 0, T);
  load_tile_async<BK, D, THREADS>(ring + F::KV_ELEMS, vb, st.vs, 0, T);
  cp_async_commit();

  const int wr = warp * 16 * MT;  // this warp's first row in the tile
  const int qw = q0 + wr;         // ... and in the sequence
  const uint32_t off_a = lane_off_a<D>(lane);
  const uint32_t off_br = lane_off_b_rows<D>(lane);
  const uint32_t off_bc = lane_off_b_cols<D>(lane);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[MT][D / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      load_a<D>(qf[mt][kk], smem_u32(sQ), off_a, wr + 16 * mt, kk * 16);
  }
  __syncthreads();  // stage 1 is refilled next

  float acc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }
  // Running max (raw q.k units) and this lane's share of the row sums, for
  // rows g and g + 8 of each of the warp's m-tiles.
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int j = 0; j < n_visible; ++j) {
    if (j + 1 < n_visible) {
      bf16* nxt = ring + ((j + 1) & 1) * STAGE;
      load_tile_async<BK, D, THREADS>(nxt, kb, st.ks, (j + 1) * BK, T);
      load_tile_async<BK, D, THREADS>(nxt + F::KV_ELEMS, vb, st.vs, (j + 1) * BK, T);
    }
    cp_async_commit();  // possibly empty: keeps "tile j is the older group" true
    cp_async_wait<1>();
    __syncthreads();

    const int k0 = j * BK;
    if (!(causal && k0 > qw + 16 * MT - 1)) {  // else the tile is above the warp's diagonal
      const uint32_t cK = smem_u32(ring + (j & 1) * STAGE);
      const uint32_t cV = cK + F::KV_ELEMS * sizeof(bf16);

      float s[MT][BK / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t bfr[4];
          load_b_rows<D>(bfr, cK, off_br, np * 16, kk * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(s[mt][2 * np], qf[mt][kk], bfr[0], bfr[1]);
            mma_16816(s[mt][2 * np + 1], qf[mt][kk], bfr[2], bfr[3]);
          }
        }
      }

      const bool edge = k0 + BK > T || (causal && k0 + BK - 1 > qw);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (edge) {
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + n * 8 + 2 * t + (e & 1);
              const int row = qw + 16 * mt + g + (e >> 1) * 8;
              if (col >= T || (causal && col > row)) s[mt][n][e] = -INFINITY;
            }
          }
        }

        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
        }
        float alpha[2], mb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = quad_max(mx[i]);
          // A row with nothing visible yet keeps max -inf; subtract 0 then.
          mb[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;
          alpha[i] = fast_exp2(m[mt][i] * scale_log2 - mb[i]);
          m[mt][i] = mx[i];
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][n][e] = fast_exp2(fmaf(s[mt][n][e], scale_log2, -mb[e >> 1]));
            rs[e >> 1] += s[mt][n][e];
          }
        }
        l[mt][0] = l[mt][0] * alpha[0] + rs[0];
        l[mt][1] = l[mt][1] * alpha[1] + rs[1];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[mt][n][0] *= alpha[0];
          acc[mt][n][1] *= alpha[0];
          acc[mt][n][2] *= alpha[1];
          acc[mt][n][3] *= alpha[1];
        }
      }

      // O += P . V, P from registers; each V fragment serves every m-tile.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) a_from_c(a[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bfr[4];
          load_b_cols<D>(bfr, cV, off_bc, kk * 16, np * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(acc[mt][2 * np], a[mt], bfr[0], bfr[1]);
            mma_16816(acc[mt][2 * np + 1], a[mt], bfr[2], bfr[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Every stage is free after the loop's last barrier: each warp stages its
  // own rows of a [BQ, D] tile at sQ and stores them.
  float* lse_bh = lse + (long long)bh * S;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float lc0 = fmaxf(quad_sum(l[mt][0]), 1e-30f);
    const float lc1 = fmaxf(quad_sum(l[mt][1]), 1e-30f);
    stage_rows<D>(sQ, acc[mt], wr + 16 * mt, 1.f / lc0, 1.f / lc1, lane);
    const int r0 = qw + 16 * mt + g;
    if (t == 0) {
      if (r0 < S) lse_bh[r0] = m[mt][0] * scale + logf(lc0);
      if (r0 + 8 < S) lse_bh[r0 + 8] = m[mt][1] * scale + logf(lc1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows<D>(o + b * st.ob + h * st.oh, st.os, sQ, wr + 16 * mt, qw + 16 * mt, S, lane);
}

template <int D, int WARPS, int MT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int H, int Hkv, int S, int T, const Strides& st, float scale, int causal,
                   int device, cudaStream_t stream) {
  using F = Fwd<D, WARPS, MT>;
  // Above 48 KB of dynamic shared memory needs the opt-in, once per device
  // and kernel; setting it twice from racing threads is harmless.
  static int configured_device = -1;
  if (configured_device != device) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, WARPS, MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)F::SMEM);
    if (err != cudaSuccess) return err;
    configured_device = device;
  }
  dim3 grid(B * H, (S + F::BQ - 1) / F::BQ);
  flash_fwd_kernel<D, WARPS, MT><<<grid, F::THREADS, F::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, Hkv, S, T, st, scale, causal);
  return cudaGetLastError();
}

// The full block: 4 warps of MT m-tiles (D = 64: MT = 2, 128 rows a block,
// so that each K and V fragment serves two products; D = 128: MT = 1, 64
// rows, as the registers allow). When that grid has fewer blocks than the card
// has SMs (a served chunk), blocks of 2 warps of one m-tile: 32 rows a block,
// two or four times as many blocks.
template <int D, int WARPS, int MT>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                     int H, int Hkv, int S, int T, const Strides& st, float scale, int causal,
                     cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  constexpr int BQ = Fwd<D, WARPS, MT>::BQ;
  const long long blocks = (long long)B * H * ((S + BQ - 1) / BQ);
  if (blocks >= sms)
    return launch<D, WARPS, MT>(q, k, v, o, lse, B, H, Hkv, S, T, st, scale, causal, device,
                                stream);
  return launch<D, 2, 1>(q, k, v, o, lse, B, H, Hkv, S, T, st, scale, causal, device, stream);
}

}  // namespace

// The launch's arguments in one block, 8 bytes a field, packed by the caller
// (ops/attention.py, `_FWD_ARGS`): one pointer crosses the C boundary instead
// of 26 arguments, which the served chunks' launch-bound calls feel.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* lse;
  long long B, H, Hkv, S, T, D;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
  double scale;
  long long causal;
};
static_assert(sizeof(FwdArgs) == 25 * 8, "FwdArgs must match ops/attention.py:_FWD_ARGS");

extern "C" int ray_tpu_torch_flash_fwd(const void* packed, void* stream) {
  FwdArgs args;  // copied out: the caller's buffer need not be 8-byte aligned
  memcpy(&args, packed, sizeof args);
  const FwdArgs* a = &args;
  const Strides st{a->qb, a->qh, a->qs, a->kb, a->kh, a->ks,
                   a->vb, a->vh, a->vs, a->ob, a->oh, a->os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = (int)a->B, H = (int)a->H, Hkv = (int)a->Hkv, S = (int)a->S, T = (int)a->T;
  const float scale = (float)a->scale;
  const int causal = (int)a->causal;
  cudaError_t err;
  if (a->D == 64) {
    err = launch_d<64, 4, 2>(a->q, a->k, a->v, a->o, a->lse, B, H, Hkv, S, T, st, scale, causal, s);
  } else if (a->D == 128) {
    err = launch_d<128, 4, 1>(a->q, a->k, a->v, a->o, a->lse, B, H, Hkv, S, T, st, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
