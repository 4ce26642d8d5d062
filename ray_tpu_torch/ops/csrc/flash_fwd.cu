// Flash-attention forward for Hopper (sm_90a): causal or full online-softmax
// attention with GQA and optional segment ids, BSHD in, O (BSHD) + LSE out.
//
// Replaces the TPU kernel B1a: `_fwd` + `_fwd_kernel` in
// ray_tpu/ops/flash_attention.py:46-195 (pallas_call at :173).
//
// Bound on an H100 SXM: at the prefill shapes of llama3-8b (H 32, Hkv 8,
// D 128, S <= 1024) the function does 4*B*H*D*S(S+1)/2 flops for causal
// attention against ~2*B*S*(H+Hkv)*D*2 bytes in bf16, i.e. ~1000 flops per
// byte at S=1024: bound by operations (989 TFLOP/s on tensor cores), not by
// the 3.35 TB/s memory; below S ~ 300 the bytes bound. The design keeps the S
// tile out of device memory (the point of the TPU kernel) and, for bf16 (the
// serving path), runs both products on tensor cores with mma.sync (P stays in
// registers between them). f32 runs on CUDA cores, so it is bound by their
// 67 TFLOP/s. wgmma, TMA, a pipelined K/V ring and warp specialisation are
// later work.
//
// Layout: one thread block per (q tile of BQ rows, q head, batch). A loop over
// kv tiles held in shared memory replaces the TPU's sequential kj grid axis.
// Running max, sum and accumulator are f32. The kv head is h / (H / Hkv) and
// is never materialised. Causal tiles wholly above the diagonal are skipped
// (the mask is col <= row, query row i at absolute position i, as on the
// TPU). Ragged edges (S not a multiple of the tile) are masked here. Rows
// with no valid key give O = 0 and LSE = -1e30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // key/value rows per smem tile
constexpr int NT = 128;   // threads per block (f32: 16 row groups x 8 lanes; bf16: 4 warps)

template <int D>
constexpr size_t f32_smem_bytes() {
  // Qs[BQ][D+1] + Ks[BKV][D+1] + Vs[BKV][D] + Ps[BQ][BKV+1] floats, then two
  // int segment rows. The +1 pads keep column reads off a single bank.
  return sizeof(float) * (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1)) +
         sizeof(int) * (BQ + BKV);
}

// ---------------------------------------------------------------------------
// f32 on CUDA cores: both products as f32 FMAs from shared-memory tiles, with a
// 4x8 (Q K^T) and 4x(D/8) (P V) register micro-tile per thread so that each
// shared load feeds several FMAs.
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     float* __restrict__ o, float* __restrict__ lse, int Sq, int Skv,
                     int H, int Hkv, int causal, float scale) {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int DJ = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (D + 1);
  float* Vs = Ks + BKV * (D + 1);
  float* Ps = Vs + BKV * D;
  int* segq = reinterpret_cast<int*>(Ps + BQ * (BKV + 1));
  int* segk = segq + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 7;   // column lane (8 lanes share a row group)
  const int ty = tid >> 3;  // row group: rows ty + 16*i

  const long q_row = (long)H * D;
  const long kv_row = (long)Hkv * D;
  const float* qb = q + (long)b * Sq * q_row + (long)h * D;
  const float* kb = k + (long)b * Skv * kv_row + (long)hk * D;
  const float* vb = v + (long)b * Skv * kv_row + (long)hk * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    Qs[r * (D + 1) + c] = qi < Sq ? qb[qi * q_row + c] : 0.f;
  }
  if (seg != nullptr) {
    // segment ids are [B, Skv]; query row i uses seg[Skv - Sq + i]
    for (int r = tid; r < BQ; r += NT) {
      const int qi = q0 + r;
      segq[r] = qi < Sq ? seg[(long)b * Skv + (Skv - Sq) + qi] : -1;
    }
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (Skv + BKV - 1) / BKV;
  if (causal) {
    const int last_row = min(Sq, q0 + BQ) - 1;
    n_tiles = min(n_tiles, last_row / BKV + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int kj = k0 + r;
      const bool in = kj < Skv;
      Ks[r * (D + 1) + c] = in ? kb[kj * kv_row + c] : 0.f;
      Vs[r * D + c] = in ? vb[kj * kv_row + c] : 0.f;
    }
    if (seg != nullptr) {
      for (int r = tid; r < BKV; r += NT) {
        const int kj = k0 + r;
        segk[r] = kj < Skv ? seg[(long)b * Skv + kj] : -2;
      }
    }
    __syncthreads();

    // S = Q K^T for rows ty+16i, columns tx+8j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax; the 8 lanes of a row group are adjacent lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      const int row = q0 + rl;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = tx + 8 * j;
        const int col = k0 + cl;
        bool ok = col < Skv;
        if (causal) ok = ok && col <= row;
        if (seg != nullptr) ok = ok && segq[rl] == segk[cl];
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float m_new = fmaxf(m[i], tmax);
      // nothing valid yet in this row: keep it empty (p = 0, no rescale)
      const bool empty = m_new == -INFINITY;
      const float alpha = empty ? 1.f : expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (empty || s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        Ps[rl * (BKV + 1) + tx + 8 * j] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P V for rows ty+16i, columns tx+8j
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BKV + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = o + ((long)b * Sq + row) * q_row + (long)h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 8 * j] = acc[i][j] * inv;
    if (tx == 0) {
      lse[((long)b * H + h) * Sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : LSE_EMPTY;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores: mma.sync.m16n8k16 (bf16 in, f32 accumulate). Each of
// the 4 warps owns 16 query rows; its Q fragments stay in registers for the
// whole kv loop. S = Q K^T lands in the accumulator layout, which is exactly
// the A-fragment layout of P for O += P V (FlashAttention-2), so P never
// leaves registers: it is rounded to bf16 for the product while the row sums
// l are taken from the f32 values. K and V tiles are staged in shared memory
// with rows padded by PAD elements so that the fragment reads hit 32 banks.

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (BQ + 2 * BKV) * (D + PAD) + sizeof(int) * BKV;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                          __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
                          int Skv, int H, int Hkv, int causal, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = D + PAD;       // shared-memory row stride (elements)
  constexpr int KSTEPS = D / 16;    // k-steps of Q K^T
  constexpr int NTD = D / 8;        // n-tiles of O
  constexpr int NTS = BKV / 8;      // n-tiles of S
  constexpr int VEC = 8;            // bf16 per 16-byte load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BKV * LD;
  int* segk = reinterpret_cast<int*>(Vs + BKV * LD);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group row, thread in group

  const long q_row = (long)H * D;
  const long kv_row = (long)Hkv * D;
  const __nv_bfloat16* qb = q + (long)b * Sq * q_row + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * Skv * kv_row + (long)hk * D;
  const __nv_bfloat16* vb = v + (long)b * Skv * kv_row + (long)hk * D;

  for (int idx = tid; idx < BQ * D / VEC; idx += NT) {
    const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
    const int qi = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qi < Sq) val = *reinterpret_cast<const uint4*>(qb + qi * q_row + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  __syncthreads();

  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* base = Qs + (warp * 16 + g) * LD + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }
  int seg_a = -1, seg_b = -1;
  if (seg != nullptr) {
    if (row_a < Sq) seg_a = seg[(long)b * Skv + (Skv - Sq) + row_a];
    if (row_b < Sq) seg_b = seg[(long)b * Skv + (Skv - Sq) + row_b];
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int n_tiles = (Skv + BKV - 1) / BKV;
  if (causal) {
    const int last_row = min(Sq, q0 + BQ) - 1;
    n_tiles = min(n_tiles, last_row / BKV + 1);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BKV;
    __syncthreads();  // the previous tile's Ks/Vs reads are done
    for (int idx = tid; idx < BKV * D / VEC; idx += NT) {
      const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
      const int kj = k0 + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (kj < Skv) {
        kv4 = *reinterpret_cast<const uint4*>(kb + kj * kv_row + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + kj * kv_row + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * LD + c) = vv4;
    }
    if (seg != nullptr) {
      for (int r = tid; r < BKV; r += NT) {
        const int kj = k0 + r;
        segk[r] = kj < Skv ? seg[(long)b * Skv + kj] : -2;
      }
    }
    __syncthreads();

    float s[NTS][4];
#pragma unroll
    for (int n = 0; n < NTS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int n = 0; n < NTS; ++n) {
        // B[k][n] = K[kv = n*8 + g][d = kk*16 + k]: two adjacent d per register
        const __nv_bfloat16* kbase = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kbase),
                 *reinterpret_cast<const uint32_t*>(kbase + 8));
      }
    }

    // mask + online softmax; accumulator e: row (e < 2 ? a : b), col 2t + (e & 1)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + 2 * t + (e & 1);
        const int col = k0 + cl;
        const int row = e < 2 ? row_a : row_b;
        bool ok = col < Skv;
        if (causal) ok = ok && col <= row;
        if (seg != nullptr) ok = ok && segk[cl] == (e < 2 ? seg_a : seg_b);
        s[n][e] = ok ? s[n][e] * scale : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[n][e]);
      }
    }
    float alpha[2], m_new[2];
    bool empty[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      m_new[r] = fmaxf(m[r], tmax[r]);
      empty[r] = m_new[r] == -INFINITY;  // nothing valid yet in this row
      alpha[r] = empty[r] ? 1.f : expf(m[r] - m_new[r]);
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = (empty[r] || s[n][e] == -INFINITY) ? 0.f : expf(s[n][e] - m_new[r]);
        s[n][e] = p;
        psum[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * alpha[r] + psum[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's A fragment for kv k-step j is S n-tiles 2j and 2j+1
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      const uint32_t a[4] = {pack_f32(s[2 * j][0], s[2 * j][1]),
                             pack_f32(s[2 * j][2], s[2 * j][3]),
                             pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_f32(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NTD; ++n) {
        // B[k][n] = V[kv = j*16 + k][d = n*8 + g]: two adjacent kv per register
        const __nv_bfloat16* vbase = Vs + (j * 16 + 2 * t) * LD + n * 8 + g;
        mma_bf16(acc[n], a, pack_bf16(vbase[0], vbase[LD]),
                 pack_bf16(vbase[8 * LD], vbase[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* orow = o + ((long)b * Sq + row) * q_row + (long)h * D;
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
    if (t == 0) {
      lse[((long)b * H + h) * Sq + row] = l[r] > 0.f ? m[r] + logf(l[r]) : LSE_EMPTY;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* seg, void* o,
               void* lse, int B, int Sq, int Skv, int H, int Hkv, int causal,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seg), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Skv, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* seg, void* o,
                void* lse, int B, int Sq, int Skv, int H, int Hkv, int causal,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_bf16_mma_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq, Skv, H, Hkv, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA-core FMAs), 1 = bfloat16 (tensor cores; q, k, v
// and o 16-byte aligned). seg may be null. Returns a cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                         void* o, void* lse, int B, int Sq, int Skv, int H, int Hkv,
                         int D, int dtype, int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, seg, o, lse, B, Sq, Skv, H, Hkv, causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, seg, o, lse, B, Sq, Skv, H, Hkv, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, seg, o, lse, B, Sq, Skv, H, Hkv, causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, seg, o, lse, B, Sq, Skv, H, Hkv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
