// K2 on Hopper: flash-attention backward.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_bwd_fused_kernel
// (launched by _flash_backward through pl.pallas_call). Computes the same
// function, from the forward's lse and delta = rowsum(g * out) (f32, taken by
// the caller, as JAX takes it outside the kernel):
//   s  = (q . k^T) * scale in f32, entries above the top-left causal diagonal
//        (col > row, both counted from 0) masked out
//   p  = exp(s - lse) in f32
//   dv = p^T . g      with p rounded to bf16, f32 sums
//   dp = g . v^T      f32
//   ds = p * (dp - delta) * scale, rounded to bf16
//   dk = ds^T . q,  dq = ds . k   f32 sums, written in bf16
//
// The TPU kernel walks (k block, q block) in order on one core, keeps dk/dv in
// VMEM scratch across the inner q axis and accumulates dq in an HBM block it
// revisits for every k block. GPU blocks run in no order, so the work is split
// into two kernels that each recompute p, and no sum crosses blocks (the
// result is the same on every run; no atomics):
//   dkdv: one block of 4 warps per (batch, kv head, 64-row k tile). It keeps
//         its K and V tiles in shared memory and loops over the H/Hkv query
//         heads that read this kv head and, for each, over the 64-row q tiles
//         from the causal diagonal on. Each warp owns 16 k rows and keeps their
//         dK and dV in wmma accumulator fragments for the whole loop, so GQA's
//         sum over the repeat axis happens here, in f32.
//   dq:   one block of 4 warps per (batch*head, 64-row q tile), looping over
//         the k tiles up to the diagonal; each warp keeps its 16 rows of dQ in
//         accumulator fragments.
// The tensor-core products are nvcuda::wmma bf16 16x16x16 with f32
// accumulation, as in K1. wmma's accumulator layout is opaque, so each warp
// stages S (and dP) through its own f32 shared-memory scratch for the
// elementwise softmax-gradient step; p stays in registers between the two.
//
// What bounds it on an H100: per (row, col) pair kept by the mask the
// function needs 5 products of depth D (s, dp, dv, dk, dq: 10*D flops); at the
// training shapes (S = T = 1024..2048, D = 64) that is far above the card's
// ~295 flop/byte ridge, so the tensor cores bound it. This first design
// recomputes s and dp in the dq kernel (7 products instead of 5), does no
// cp.async/TMA pipelining and no wgmma: those are later work.
//
// Layouts ([B,S,H,D] or [B,H,S,D]) arrive as (batch, head, seq) strides; the
// head dim must be contiguous and rows 16-byte aligned. lse and delta are
// contiguous [B,H,S] f32. Ragged edges: rows past S or T load as zeros and
// their p is 0. Plain C interface, loaded with ctypes; the entry point returns
// cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // query rows per q tile
constexpr int BK = 64;  // key rows per k tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int HC = 32;  // columns of a warp's 16 x 64 tile held by one lane

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, gb, gh, gs;
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
};

template <int D>
struct Smem {
  static constexpr int LDQ = D + 8;                   // bf16 row stride, Q/G/K/V tiles
  static constexpr int LDP = 64 + 8;                  // bf16 row stride, a warp's P/dS tile
  static constexpr int LDS = (D > 64 ? D : 64) + 4;   // f32 row stride, a warp's scratch
  static constexpr int TILE = 64 * LDQ;
  static constexpr int P_ELEMS = WARPS * 16 * LDP;
  static constexpr size_t BYTES =
      size_t(4 * TILE + P_ELEMS) * sizeof(__nv_bfloat16) +
      size_t(WARPS * 16 * LDS + 2 * BQ) * sizeof(float);
};

// 64 rows x D columns from global (row stride `stride` elements) into shared
// memory (row stride D + 8); rows at or past `nrows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int r0, int nrows) {
  constexpr int VEC = 8;  // bf16 values per 16-byte load
  constexpr int PER_ROW = D / VEC;
#pragma unroll
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int rr = i / PER_ROW;
    const int cc = (i % PER_ROW) * VEC;
    const int gr = r0 + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows) val = *reinterpret_cast<const uint4*>(src + gr * stride + cc);
    *reinterpret_cast<uint4*>(dst + rr * (D + 8) + cc) = val;
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out [16 x 64] (f32, row stride LDS) = A [16 x D] . B^T, where A's 16 rows
// and B's 64 rows are row-major bf16 tiles in shared memory (row stride LDQ).
template <int D>
__device__ __forceinline__ void rows_dot_rowsT(float* out, const __nv_bfloat16* a,
                                               const __nv_bfloat16* b) {
  using SM = Smem<D>;
#pragma unroll
  for (int n = 0; n < 64 / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, SM::LDQ);
      wmma::load_matrix_sync(fb, b + (n * 16) * SM::LDQ + kk * 16, SM::LDQ);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, SM::LDS, wmma::mem_row_major);
  }
}

// acc[n] (16 x D, as D/16 fragments) += P [16 x 64] (bf16, row stride LDP) .
// B [64 x D] (bf16 tile, row stride LDQ).
template <int D>
__device__ __forceinline__ void acc_p_dot_tile(FragC* acc, const __nv_bfloat16* p,
                                               const __nv_bfloat16* b) {
  using SM = Smem<D>;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, p + kk * 16, SM::LDP);
      wmma::load_matrix_sync(fb, b + (kk * 16) * SM::LDQ + n * 16, SM::LDQ);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Writes a warp's 16 x D accumulator rows to global bf16 through its f32
// scratch: lane pair (2r, 2r+1) writes row r, half of the columns each.
template <int D>
__device__ __forceinline__ void store_rows(FragC* acc, float* sW, __nv_bfloat16* dst,
                                           long long row_stride, int row0, int nrows) {
  using SM = Smem<D>;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(sW + n * 16, acc[n], SM::LDS, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;
  const int d0 = (lane & 1) * (D / 2);
  const int row = row0 + r;
  if (row < nrows) {
    __nv_bfloat16* out = dst + row * row_stride + d0;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      __align__(16) __nv_bfloat16 pack[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) pack[e] = __float2bfloat16(sW[r * SM::LDS + d0 + c + e]);
      *reinterpret_cast<uint4*>(out + c) = *reinterpret_cast<const uint4*>(pack);
    }
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                      int Hkv, int S, int T, Strides st, float scale, int causal) {
  using SM = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sG = sQ + SM::TILE;
  __nv_bfloat16* sK = sG + SM::TILE;
  __nv_bfloat16* sV = sK + SM::TILE;
  __nv_bfloat16* sP = sV + SM::TILE;
  float* sS = reinterpret_cast<float*>(sP + SM::P_ELEMS);
  float* sL = sS + WARPS * 16 * SM::LDS;
  float* sDl = sL + BQ;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kt = blockIdx.x;
  const int k0 = kt * BK;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int rep = H / Hkv;

  load_tile<D>(sK, k + b * st.kb + hk * st.kh, st.ks, k0, T);
  load_tile<D>(sV, v + b * st.vb + hk * st.vh, st.vs, k0, T);

  // Lane pair (2r, 2r+1) owns k row r of the warp's 16; each lane holds half
  // of that row's 64 q columns.
  const int r = lane >> 1;
  const int c0 = (lane & 1) * HC;
  const int krow = k0 + warp * 16 + r;
  __nv_bfloat16* pW = sP + warp * 16 * SM::LDP;
  float* sW = sS + warp * 16 * SM::LDS;
  const __nv_bfloat16* kW = sK + warp * 16 * SM::LDQ;
  const __nv_bfloat16* vW = sV + warp * 16 * SM::LDQ;

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int nq = (S + BQ - 1) / BQ;
  // BQ == BK: with top-left causal masking, q tiles before this k tile's own
  // index hold only rows that see none of its columns and are skipped.
  const int i0 = causal ? kt : 0;
  for (int hr = 0; hr < rep; ++hr) {
    const int h = hk * rep + hr;
    const __nv_bfloat16* qbh = q + b * st.qb + h * st.qh;
    const __nv_bfloat16* gbh = g + b * st.gb + h * st.gh;
    const float* lse_h = lse + ((long long)b * H + h) * S;
    const float* delta_h = delta + ((long long)b * H + h) * S;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // every warp is done with the previous Q/G tile
      load_tile<D>(sQ, qbh, st.qs, q0, S);
      load_tile<D>(sG, gbh, st.gs, q0, S);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        sL[threadIdx.x] = row < S ? lse_h[row] : 0.f;
        sDl[threadIdx.x] = row < S ? delta_h[row] : 0.f;
      }
      __syncthreads();

      // S^T_w [16 k x 64 q] = K_w . Q^T
      rows_dot_rowsT<D>(sW, kW, sQ);
      __syncwarp();
      float pv[HC];
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int qc = c0 + c;
        const int qrow = q0 + qc;
        const bool keep = qrow < S && krow < T && !(causal && krow > qrow);
        const float p = keep ? expf(sW[r * SM::LDS + qc] * scale - sL[qc]) : 0.f;
        pv[c] = p;
        pW[r * SM::LDP + qc] = __float2bfloat16(p);
      }
      __syncwarp();
      // dV_w += P^T_w . G
      acc_p_dot_tile<D>(dv_acc, pW, sG);
      // dP^T_w [16 k x 64 q] = V_w . G^T
      rows_dot_rowsT<D>(sW, vW, sG);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int qc = c0 + c;
        const float ds = pv[c] * (sW[r * SM::LDS + qc] - sDl[qc]) * scale;
        pW[r * SM::LDP + qc] = __float2bfloat16(ds);
      }
      __syncwarp();
      // dK_w += dS^T_w . Q
      acc_p_dot_tile<D>(dk_acc, pW, sQ);
      __syncwarp();
    }
  }
  store_rows<D>(dk_acc, sW, dk + b * st.dkb + hk * st.dkh, st.dks, k0 + warp * 16, T);
  store_rows<D>(dv_acc, sW, dv + b * st.dvb + hk * st.dvh, st.dvs, k0 + warp * 16, T);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Hkv, int S, int T, Strides st,
                    float scale, int causal) {
  using SM = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sG = sQ + SM::TILE;
  __nv_bfloat16* sK = sG + SM::TILE;
  __nv_bfloat16* sV = sK + SM::TILE;
  __nv_bfloat16* sP = sV + SM::TILE;
  float* sS = reinterpret_cast<float*>(sP + SM::P_ELEMS);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qt = blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);

  load_tile<D>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_tile<D>(sG, g + b * st.gb + h * st.gh, st.gs, q0, S);
  const __nv_bfloat16* kb = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + hk * st.vh;

  // Lane pair (2r, 2r+1) owns q row r of the warp's 16.
  const int r = lane >> 1;
  const int c0 = (lane & 1) * HC;
  const int row = q0 + warp * 16 + r;
  const float lse_r = row < S ? lse[(long long)bh * S + row] : 0.f;
  const float delta_r = row < S ? delta[(long long)bh * S + row] : 0.f;
  __nv_bfloat16* pW = sP + warp * 16 * SM::LDP;
  float* sW = sS + warp * 16 * SM::LDS;
  const __nv_bfloat16* qW = sQ + warp * 16 * SM::LDQ;
  const __nv_bfloat16* gW = sG + warp * 16 * SM::LDQ;

  FragC dq_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  const int n_kt = (T + BK - 1) / BK;
  const int n_visible = causal ? min(n_kt, qt + 1) : n_kt;
  for (int j = 0; j < n_visible; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, st.ks, k0, T);
    load_tile<D>(sV, vb, st.vs, k0, T);
    __syncthreads();

    // S_w [16 q x 64 k] = Q_w . K^T
    rows_dot_rowsT<D>(sW, qW, sK);
    __syncwarp();
    float pv[HC];
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const int col = k0 + c0 + c;
      const bool keep = row < S && col < T && !(causal && col > row);
      pv[c] = keep ? expf(sW[r * SM::LDS + c0 + c] * scale - lse_r) : 0.f;
    }
    __syncwarp();
    // dP_w [16 q x 64 k] = G_w . V^T
    rows_dot_rowsT<D>(sW, gW, sV);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const float ds = pv[c] * (sW[r * SM::LDS + c0 + c] - delta_r) * scale;
      pW[r * SM::LDP + c0 + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    // dQ_w += dS_w . K
    acc_p_dot_tile<D>(dq_acc, pW, sK);
    __syncwarp();
  }
  store_rows<D>(dq_acc, sW, dq + b * st.dqb + h * st.dqh, st.dqs, q0 + warp * 16, S);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
                   int H, int Hkv, int S, int T, const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = Smem<D>::BYTES;
  // Above 48 KB of dynamic shared memory needs the opt-in, once per device
  // and kernel; setting it twice from racing threads is harmless.
  static int configured_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (configured_device != device) {
    err = allow_smem(flash_bwd_dkdv_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    err = allow_smem(flash_bwd_dq_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    configured_device = device;
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  dim3 grid_kv((T + BK - 1) / BK, B * Hkv);
  flash_bwd_dkdv_kernel<D><<<grid_kv, THREADS, smem, stream>>>(
      qp, kp, vp, gp, lp, dp, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      H, Hkv, S, T, st, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_q((S + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<D><<<grid_q, THREADS, smem, stream>>>(
      qp, kp, vp, gp, lp, dp, static_cast<__nv_bfloat16*>(dq), H, Hkv, S, T, st, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ray_tpu_torch_flash_bwd(
    const void* q, const void* k, const void* v, const void* g, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, int B, int H, int Hkv, int S, int T, int D,
    long long qb, long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long gb, long long gh, long long gs,
    long long dqb, long long dqh, long long dqs, long long dkb, long long dkh, long long dks,
    long long dvb, long long dvh, long long dvs, float scale, int causal, void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, gb, gh, gs,
                   dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    err = launch<64>(q, k, v, g, lse, delta, dq, dk, dv, B, H, Hkv, S, T, st, scale, causal, s);
  } else if (D == 128) {
    err = launch<128>(q, k, v, g, lse, delta, dq, dk, dv, B, H, Hkv, S, T, st, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* ray_tpu_torch_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
