// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of causal or
// full attention with GQA and optional segment ids, BSHD in and out, P
// recomputed from the forward's LSE (B1a saves O and LSE, never P).
//
// Replaces two TPU kernels of ray_tpu/ops/flash_attention.py:
//   B1b `_bwd_dq_kernel` (:201, pallas_call at :349): dQ = sum_kv dS K;
//   B1c `_bwd_dkv_kernel` (:253, pallas_call at :387) and the GQA sum at
//       :409-413: dV = sum_q P^T dO and dK = sum_q dS^T Q per kv head,
// where P = exp(S*scale - LSE) (masked slots exactly 0), delta =
// rowsum(dO o O), dS = P o (dO V^T - delta) * scale. The TPU computes delta
// in XLA before its kernels (:320); here the dQ kernel computes it from the O
// and dO rows it loads anyway and writes it out for the dK/dV kernel, which
// the stream runs after it.
//
// Bound on an H100 SXM: at the training shape of llama8b-geom2 (B 6, S 2048,
// H 32, Hkv 8, D 128, bf16, causal) the dQ kernel does 3 products (S, dP,
// dQ) and the dK/dV kernel 4 (S, dP, dV, dK) over the S(S+1)/2 pairs the
// mask keeps: 2*B*H*D*S(S+1)/2 flops each, ~0.1 TFLOP per product against
// ~0.2 GB of operands, so both are bound by the operation rate (989 TFLOP/s
// on tensor cores), not by the 3.35 TB/s memory. The design keeps S, P, dP
// and dS out of device memory (the point of the TPU kernels) and, for bf16,
// runs every product on tensor cores with mma.sync (P and dS go from the
// accumulator straight into the next product's A fragment, rounded to bf16);
// f32 runs on CUDA cores (67 TFLOP/s). wgmma, TMA and pipelined tile loads
// are later work.
//
// No sequential grid. The TPU carries dq_scr / dk_scr / dv_scr across its
// inner grid axis; here one block owns an output tile and loops itself:
//   dQ: one block per (q tile, q head, batch), looping over kv tiles up to
//       the diagonal;
//   dK/dV: one block per (kv tile, KV head, batch), looping over the n_rep q
//       heads of its group and over q tiles from the diagonal down. dK and dV
//       accumulate per kv head directly in f32 registers: no atomics, the
//       order of the sum is fixed (deterministic), and there is no per-q-head
//       f32 buffer (JAX's is 2 x 200 MB at the training shape). Each is cast
//       to the input dtype once, at the store.
// Masks are col <= row for causal (query row i at absolute position i, as
// on the TPU), equal segment ids, and the ragged edge (rows >= Sq, columns
// >= Skv), all applied here; a masked slot gives P = 0 exactly (the TPU
// relies on exp(-1e30 - LSE) underflowing, which gives exp(0) = 1 on a row
// with no valid key, where B1a writes LSE = -1e30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int NT = 128;  // threads per block (bf16: 4 warps; f32: 16 row groups x 8 lanes)
constexpr int VEC = 8;   // bf16 per 16-byte load

// bf16 tiles. The dQ kernel keeps Q and dO fragments (64 registers at D=128)
// and the dQ accumulator (64) in registers, so its kv tile is 32 rows (S and
// dP accumulators 16 each). The dK/dV kernel keeps two accumulators (128
// registers), so K and V stay in shared memory and its q tile is 32 rows.
constexpr int DQ_BQ = 64;    // q rows per dQ block (4 warps x 16)
constexpr int DQ_BKV = 32;   // kv rows per dQ tile
constexpr int DKV_BKV = 64;  // kv rows per dK/dV block (4 warps x 16)
constexpr int DKV_BQ = 32;   // q rows per dK/dV tile
// f32 tiles (CUDA cores): 64 x 64 everywhere.
constexpr int F_BQ = 64;
constexpr int F_BKV = 64;

__device__ __forceinline__ bool keep(int row, int col, int Sq, int Skv, int causal,
                                     int seg_row, int seg_col, bool has_seg) {
  bool ok = row < Sq && col < Skv;
  if (causal) ok = ok && col <= row;
  if (has_seg) ok = ok && seg_row == seg_col;
  return ok;
}

// ---------------------------------------------------------------------------
// B1b in bf16 on tensor cores. Warp w owns q rows q0 + 16w + {g, g+8}.
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const int* __restrict__ seg,
                         __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                         int Sq, int Skv, int H, int Hkv, int causal, float scale) {
  constexpr int LD = D + PAD;
  constexpr int KSTEPS = D / 16;
  constexpr int NTD = D / 8;
  constexpr int NTS = DQ_BKV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + DQ_BQ * LD;
  __nv_bfloat16* Ks = dOs + DQ_BQ * LD;
  __nv_bfloat16* Vs = Ks + DQ_BKV * LD;
  int* segk = reinterpret_cast<int*>(Vs + DQ_BKV * LD);

  const int q0 = blockIdx.x * DQ_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool has_seg = seg != nullptr;

  const long q_row = (long)H * D;
  const long kv_row = (long)Hkv * D;
  const long q_off = (long)b * Sq * q_row + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * Skv * kv_row + (long)hk * D;
  const __nv_bfloat16* vb = v + (long)b * Skv * kv_row + (long)hk * D;
  const long row_off = ((long)b * H + h) * Sq;

  for (int idx = tid; idx < DQ_BQ * D / VEC; idx += NT) {
    const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
    const int qi = q0 + r;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u), dv4 = make_uint4(0u, 0u, 0u, 0u);
    if (qi < Sq) {
      qv = *reinterpret_cast<const uint4*>(q + q_off + qi * q_row + c);
      dv4 = *reinterpret_cast<const uint4*>(dout + q_off + qi * q_row + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = qv;
    *reinterpret_cast<uint4*>(dOs + r * LD + c) = dv4;
  }
  __syncthreads();

  // delta = rowsum(dO o O) in f32 for the warp's 16 rows; every lane ends
  // with the full sum, and keeps those of its rows g and g+8.
  float delta_a = 0.f, delta_b = 0.f;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int qi = q0 + r;
    float sum = 0.f;
    if (qi < Sq) {
      for (int c = lane; c < D; c += 32)
        sum += __bfloat162float(dOs[r * LD + c]) * __bfloat162float(o[q_off + qi * q_row + c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0 && qi < Sq) delta[row_off + qi] = sum;
    if (rr == g) delta_a = sum;
    if (rr == g + 8) delta_b = sum;
  }

  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    load_a(qf[kk], Qs, LD, warp * 16, kk * 16, g, t);
    load_a(dof[kk], dOs, LD, warp * 16, kk * 16, g, t);
  }
  const float lse_a = row_a < Sq ? lse[row_off + row_a] : 0.f;
  const float lse_b = row_b < Sq ? lse[row_off + row_b] : 0.f;
  int seg_a = -1, seg_b = -1;
  if (has_seg) {
    if (row_a < Sq) seg_a = seg[(long)b * Skv + (Skv - Sq) + row_a];
    if (row_b < Sq) seg_b = seg[(long)b * Skv + (Skv - Sq) + row_b];
  }

  float acc[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int n_tiles = (Skv + DQ_BKV - 1) / DQ_BKV;
  if (causal) n_tiles = min(n_tiles, (min(Sq, q0 + DQ_BQ) - 1) / DQ_BKV + 1);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * DQ_BKV;
    __syncthreads();  // the previous tile's Ks/Vs reads are done
    for (int idx = tid; idx < DQ_BKV * D / VEC; idx += NT) {
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
    if (has_seg) {
      for (int r = tid; r < DQ_BKV; r += NT) {
        const int kj = k0 + r;
        segk[r] = kj < Skv ? seg[(long)b * Skv + kj] : -2;
      }
    }
    __syncthreads();

    float s[NTS][4], dp[NTS][4];
#pragma unroll
    for (int n = 0; n < NTS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int n = 0; n < NTS; ++n) {
        mma_cols(s[n], qf[kk], Ks, LD, n * 8, kk * 16, g, t);   // S = Q K^T
        mma_cols(dp[n], dof[kk], Vs, LD, n * 8, kk * 16, g, t);  // dP = dO V^T
      }
    }
    // dS = P o (dP - delta) * scale, kept in s; element e: row (e < 2 ? a : b),
    // column 2t + (e & 1) of n-tile n
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + 2 * t + (e & 1);
        const bool hi = e >= 2;
        const bool ok = keep(hi ? row_b : row_a, k0 + cl, Sq, Skv, causal,
                             hi ? seg_b : seg_a, has_seg ? segk[cl] : 0, has_seg);
        const float p = ok ? expf(s[n][e] * scale - (hi ? lse_b : lse_a)) : 0.f;
        s[n][e] = p * (dp[n][e] - (hi ? delta_b : delta_a)) * scale;
      }
    }
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < DQ_BKV / 16; ++j) {
      uint32_t a[4];
      acc_to_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < NTD; ++n) mma_rows(acc[n], a, Ks, LD, j * 16, n * 8, g, t);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= Sq) continue;
    __nv_bfloat16* drow = dq + q_off + row * q_row;
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// B1c in bf16 on tensor cores. Warp w owns kv rows k0 + 16w + {g, g+8}; the
// products are transposed (S^T = K Q^T, dP^T = V dO^T) so that P^T and dS^T
// land in the accumulator layout that feeds dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                          int causal, float scale) {
  constexpr int LD = D + PAD;
  constexpr int KSTEPS = D / 16;
  constexpr int NTD = D / 8;
  constexpr int NTQ = DKV_BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + DKV_BKV * LD;
  __nv_bfloat16* Qs = Vs + DKV_BKV * LD;
  __nv_bfloat16* dOs = Qs + DKV_BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + DKV_BQ * LD);
  float* delta_s = lse_s + DKV_BQ;
  int* segq = reinterpret_cast<int*>(delta_s + DKV_BQ);

  const int k0 = blockIdx.x * DKV_BKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool has_seg = seg != nullptr;

  const long q_row = (long)H * D;
  const long kv_row = (long)Hkv * D;
  const long kv_off = (long)b * Skv * kv_row + (long)hk * D;

  for (int idx = tid; idx < DKV_BKV * D / VEC; idx += NT) {
    const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
    const int kj = k0 + r;
    uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
    if (kj < Skv) {
      kv4 = *reinterpret_cast<const uint4*>(k + kv_off + kj * kv_row + c);
      vv4 = *reinterpret_cast<const uint4*>(v + kv_off + kj * kv_row + c);
    }
    *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv4;
    *reinterpret_cast<uint4*>(Vs + r * LD + c) = vv4;
  }
  const int kv_a = k0 + warp * 16 + g;
  const int kv_b = kv_a + 8;
  int seg_a = -2, seg_b = -2;
  if (has_seg) {
    if (kv_a < Skv) seg_a = seg[(long)b * Skv + kv_a];
    if (kv_b < Skv) seg_b = seg[(long)b * Skv + kv_b];
  }

  float dk_acc[NTD][4], dv_acc[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // query rows below k0 see none of this block's columns under the causal mask
  const int qt0 = causal ? k0 / DKV_BQ : 0;
  const int n_qt = (Sq + DKV_BQ - 1) / DKV_BQ;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    const long q_off = (long)b * Sq * q_row + (long)h * D;
    const long row_off = ((long)b * H + h) * Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int qs0 = qt * DKV_BQ;
      __syncthreads();  // K/V are staged; the previous tile's Qs/dOs reads are done
      for (int idx = tid; idx < DKV_BQ * D / VEC; idx += NT) {
        const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
        const int qi = qs0 + r;
        uint4 qv = make_uint4(0u, 0u, 0u, 0u), dv4 = make_uint4(0u, 0u, 0u, 0u);
        if (qi < Sq) {
          qv = *reinterpret_cast<const uint4*>(q + q_off + qi * q_row + c);
          dv4 = *reinterpret_cast<const uint4*>(dout + q_off + qi * q_row + c);
        }
        *reinterpret_cast<uint4*>(Qs + r * LD + c) = qv;
        *reinterpret_cast<uint4*>(dOs + r * LD + c) = dv4;
      }
      for (int r = tid; r < DKV_BQ; r += NT) {
        const int qi = qs0 + r;
        const bool in = qi < Sq;
        lse_s[r] = in ? lse[row_off + qi] : 0.f;
        delta_s[r] = in ? delta[row_off + qi] : 0.f;
        segq[r] = (in && has_seg) ? seg[(long)b * Skv + (Skv - Sq) + qi] : -1;
      }
      __syncthreads();

      float st[NTQ][4], dpt[NTQ][4];
#pragma unroll
      for (int n = 0; n < NTQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, Ks, LD, warp * 16, kk * 16, g, t);
        load_a(av, Vs, LD, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < NTQ; ++n) {
          mma_cols(st[n], ak, Qs, LD, n * 8, kk * 16, g, t);    // S^T = K Q^T
          mma_cols(dpt[n], av, dOs, LD, n * 8, kk * 16, g, t);  // dP^T = V dO^T
        }
      }
      // P^T into st, dS^T into dpt; element e: kv row (e < 2 ? a : b), q column
      // 2t + (e & 1) of n-tile n
#pragma unroll
      for (int n = 0; n < NTQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = n * 8 + 2 * t + (e & 1);
          const bool hi = e >= 2;
          const bool ok = keep(qs0 + cl, hi ? kv_b : kv_a, Sq, Skv, causal, segq[cl],
                               hi ? seg_b : seg_a, has_seg);
          const float p = ok ? expf(st[n][e] * scale - lse_s[cl]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - delta_s[cl]) * scale;
        }
      }
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int j = 0; j < DKV_BQ / 16; ++j) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, st[2 * j], st[2 * j + 1]);
        acc_to_a(ads, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
          mma_rows(dv_acc[n], ap, dOs, LD, j * 16, n * 8, g, t);
          mma_rows(dk_acc[n], ads, Qs, LD, j * 16, n * 8, g, t);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kv = r == 0 ? kv_a : kv_b;
    if (kv >= Skv) continue;
    __nv_bfloat16* krow = dk + kv_off + kv * kv_row;
    __nv_bfloat16* vrow = dv + kv_off + kv * kv_row;
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(krow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 on CUDA cores. Thread (ty, tx) of a block owns rows ty + 16i (i < 4) of
// the block's output tile and columns tx + 8j; the 8 lanes of a row group are
// adjacent lanes. Tiles in shared memory have rows padded by one float.

template <int D>
constexpr size_t f32_dq_smem_bytes() {
  // Qs, dOs [F_BQ][D+1]; Ks, Vs [F_BKV][D+1]; dS [F_BQ][F_BKV+1]; segk [F_BKV]
  return sizeof(float) * (2 * F_BQ * (D + 1) + 2 * F_BKV * (D + 1) + F_BQ * (F_BKV + 1)) +
         sizeof(int) * F_BKV;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const int* __restrict__ seg, float* __restrict__ dq,
                        float* __restrict__ delta, int Sq, int Skv, int H, int Hkv,
                        int causal, float scale) {
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + F_BQ * (D + 1);
  float* Ks = dOs + F_BQ * (D + 1);
  float* Vs = Ks + F_BKV * (D + 1);
  float* dS = Vs + F_BKV * (D + 1);
  int* segk = reinterpret_cast<int*>(dS + F_BQ * (F_BKV + 1));

  const int q0 = blockIdx.x * F_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const bool has_seg = seg != nullptr;

  const long q_row = (long)H * D;
  const long kv_row = (long)Hkv * D;
  const long q_off = (long)b * Sq * q_row + (long)h * D;
  const float* kb = k + (long)b * Skv * kv_row + (long)hk * D;
  const float* vb = v + (long)b * Skv * kv_row + (long)hk * D;
  const long row_off = ((long)b * H + h) * Sq;

  for (int idx = tid; idx < F_BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    const bool in = qi < Sq;
    Qs[r * (D + 1) + c] = in ? q[q_off + qi * q_row + c] : 0.f;
    dOs[r * (D + 1) + c] = in ? dout[q_off + qi * q_row + c] : 0.f;
  }
  __syncthreads();

  float dlt[4], lse_r[4], acc[4][DJ];
  int row[4], seg_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty + 16 * i;
    row[i] = q0 + rl;
    const bool in = row[i] < Sq;
    float sum = 0.f;
    if (in) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        sum += dOs[rl * (D + 1) + tx + 8 * j] * o[q_off + row[i] * q_row + tx + 8 * j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    dlt[i] = sum;
    if (in && tx == 0) delta[row_off + row[i]] = sum;
    lse_r[i] = in ? lse[row_off + row[i]] : 0.f;
    seg_r[i] = (in && has_seg) ? seg[(long)b * Skv + (Skv - Sq) + row[i]] : -1;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (Skv + F_BKV - 1) / F_BKV;
  if (causal) n_tiles = min(n_tiles, (min(Sq, q0 + F_BQ) - 1) / F_BKV + 1);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * F_BKV;
    __syncthreads();  // the previous tile's Ks/dS reads are done
    for (int idx = tid; idx < F_BKV * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int kj = k0 + r;
      const bool in = kj < Skv;
      Ks[r * (D + 1) + c] = in ? kb[kj * kv_row + c] : 0.f;
      Vs[r * (D + 1) + c] = in ? vb[kj * kv_row + c] : 0.f;
    }
    if (has_seg) {
      for (int r = tid; r < F_BKV; r += NT) {
        const int kj = k0 + r;
        segk[r] = kj < Skv ? seg[(long)b * Skv + kj] : -2;
      }
    }
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
        dov[i] = dOs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = Ks[(tx + 8 * j) * (D + 1) + d];
        vv[j] = Vs[(tx + 8 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = tx + 8 * j;
        const bool ok = keep(row[i], k0 + cl, Sq, Skv, causal, seg_r[i],
                             has_seg ? segk[cl] : 0, has_seg);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dS[(ty + 16 * i) * (F_BKV + 1) + cl] = p * (dp[i][j] - dlt[i]) * scale;
      }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < F_BKV; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dS[(ty + 16 * i) * (F_BKV + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Ks[c * (D + 1) + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= Sq) continue;
    float* drow = dq + q_off + row[i] * q_row;
#pragma unroll
    for (int j = 0; j < DJ; ++j) drow[tx + 8 * j] = acc[i][j];
  }
}

template <int D>
constexpr size_t f32_dkv_smem_bytes() {
  // Ks, Vs [F_BKV][D+1]; Qs, dOs [F_BQ][D+1]; P^T, dS^T [F_BKV][F_BQ+1];
  // lse, delta [F_BQ]; segq [F_BQ]
  return sizeof(float) * (2 * F_BKV * (D + 1) + 2 * F_BQ * (D + 1) +
                          2 * F_BKV * (F_BQ + 1) + 2 * F_BQ) +
         sizeof(int) * F_BQ;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ seg, float* __restrict__ dk,
                         float* __restrict__ dv, int Sq, int Skv, int H, int Hkv, int causal,
                         float scale) {
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + F_BKV * (D + 1);
  float* Qs = Vs + F_BKV * (D + 1);
  float* dOs = Qs + F_BQ * (D + 1);
  float* Pt = dOs + F_BQ * (D + 1);
  float* dSt = Pt + F_BKV * (F_BQ + 1);
  float* lse_s = dSt + F_BKV * (F_BQ + 1);
  float* delta_s = lse_s + F_BQ;
  int* segq = reinterpret_cast<int*>(delta_s + F_BQ);

  const int k0 = blockIdx.x * F_BKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = H / Hkv;
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const bool has_seg = seg != nullptr;

  const long q_row = (long)H * D;
  const long kv_row = (long)Hkv * D;
  const long kv_off = (long)b * Skv * kv_row + (long)hk * D;

  for (int idx = tid; idx < F_BKV * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int kj = k0 + r;
    const bool in = kj < Skv;
    Ks[r * (D + 1) + c] = in ? k[kv_off + kj * kv_row + c] : 0.f;
    Vs[r * (D + 1) + c] = in ? v[kv_off + kj * kv_row + c] : 0.f;
  }
  int kvr[4], seg_r[4];
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kvr[i] = k0 + ty + 16 * i;
    seg_r[i] = (kvr[i] < Skv && has_seg) ? seg[(long)b * Skv + kvr[i]] : -2;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  const int qt0 = causal ? k0 / F_BQ : 0;
  const int n_qt = (Sq + F_BQ - 1) / F_BQ;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    const long q_off = (long)b * Sq * q_row + (long)h * D;
    const long row_off = ((long)b * H + h) * Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int qs0 = qt * F_BQ;
      __syncthreads();  // K/V are staged; the previous tile's reads are done
      for (int idx = tid; idx < F_BQ * D; idx += NT) {
        const int r = idx / D, c = idx % D;
        const int qi = qs0 + r;
        const bool in = qi < Sq;
        Qs[r * (D + 1) + c] = in ? q[q_off + qi * q_row + c] : 0.f;
        dOs[r * (D + 1) + c] = in ? dout[q_off + qi * q_row + c] : 0.f;
      }
      for (int r = tid; r < F_BQ; r += NT) {
        const int qi = qs0 + r;
        const bool in = qi < Sq;
        lse_s[r] = in ? lse[row_off + qi] : 0.f;
        delta_s[r] = in ? delta[row_off + qi] : 0.f;
        segq[r] = (in && has_seg) ? seg[(long)b * Skv + (Skv - Sq) + qi] : -1;
      }
      __syncthreads();

      // P^T = exp(K Q^T * scale - LSE) for rows kvr[i], q columns tx + 8j
      float acc2[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc2[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], qv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) kv[i] = Ks[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < 8; ++j) qv[j] = Qs[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc2[i][j] = fmaf(kv[i], qv[j], acc2[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cl = tx + 8 * j;
          const bool ok = keep(qs0 + cl, kvr[i], Sq, Skv, causal, segq[cl], seg_r[i], has_seg);
          Pt[(ty + 16 * i) * (F_BQ + 1) + cl] =
              ok ? expf(acc2[i][j] * scale - lse_s[cl]) : 0.f;
          acc2[i][j] = 0.f;
        }
      // dS^T = P^T o (V dO^T - delta) * scale (each thread reads back its own P^T)
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float vv[4], dov[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) vv[i] = Vs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < 8; ++j) dov[j] = dOs[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc2[i][j] = fmaf(vv[i], dov[j], acc2[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cl = tx + 8 * j;
          const int at = (ty + 16 * i) * (F_BQ + 1) + cl;
          dSt[at] = Pt[at] * (acc2[i][j] - delta_s[cl]) * scale;
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
      for (int c = 0; c < F_BQ; ++c) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pt[(ty + 16 * i) * (F_BQ + 1) + c];
          dsv[i] = dSt[(ty + 16 * i) * (F_BQ + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float dov = dOs[c * (D + 1) + tx + 8 * j];
          const float qv = Qs[c * (D + 1) + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(pv[i], dov, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kvr[i] >= Skv) continue;
    float* krow = dk + kv_off + kvr[i] * kv_row;
    float* vrow = dv + kv_off + kvr[i] * kv_row;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      krow[tx + 8 * j] = dk_acc[i][j];
      vrow[tx + 8 * j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------

template <int D>
constexpr size_t bf16_dq_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * DQ_BQ + 2 * DQ_BKV) * (D + PAD) + sizeof(int) * DQ_BKV;
}

template <int D>
constexpr size_t bf16_dkv_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * DKV_BKV + 2 * DKV_BQ) * (D + PAD) +
         sizeof(float) * 2 * DKV_BQ + sizeof(int) * DKV_BQ;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int D>
int launch_dq(int dtype, const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, const void* seg, void* dq, void* delta,
              int B, int Sq, int Skv, int H, int Hkv, int causal, float scale,
              cudaStream_t stream) {
  int err;
  if (dtype == 0) {
    constexpr size_t smem = f32_dq_smem_bytes<D>();
    if ((err = prepare(flash_bwd_dq_f32_kernel<D>, smem)) != 0) return err;
    dim3 grid((Sq + F_BQ - 1) / F_BQ, H, B);
    flash_bwd_dq_f32_kernel<D><<<grid, NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const int*>(seg), static_cast<float*>(dq), static_cast<float*>(delta),
        Sq, Skv, H, Hkv, causal, scale);
  } else {
    constexpr size_t smem = bf16_dq_smem_bytes<D>();
    if ((err = prepare(flash_bwd_dq_bf16_kernel<D>, smem)) != 0) return err;
    dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, H, B);
    flash_bwd_dq_bf16_kernel<D><<<grid, NT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
        static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(dq),
        static_cast<float*>(delta), Sq, Skv, H, Hkv, causal, scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* seg, void* dk, void* dv,
               int B, int Sq, int Skv, int H, int Hkv, int causal, float scale,
               cudaStream_t stream) {
  int err;
  if (dtype == 0) {
    constexpr size_t smem = f32_dkv_smem_bytes<D>();
    if ((err = prepare(flash_bwd_dkv_f32_kernel<D>, smem)) != 0) return err;
    dim3 grid((Skv + F_BKV - 1) / F_BKV, Hkv, B);
    flash_bwd_dkv_f32_kernel<D><<<grid, NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(seg), static_cast<float*>(dk), static_cast<float*>(dv), Sq,
        Skv, H, Hkv, causal, scale);
  } else {
    constexpr size_t smem = bf16_dkv_smem_bytes<D>();
    if ((err = prepare(flash_bwd_dkv_bf16_kernel<D>, smem)) != 0) return err;
    dim3 grid((Skv + DKV_BKV - 1) / DKV_BKV, Hkv, B);
    flash_bwd_dkv_bf16_kernel<D><<<grid, NT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, Hkv, causal, scale);
  }
  return (int)cudaGetLastError();
}

bool valid(int B, int Sq, int Skv, int H, int Hkv, int dtype) {
  return B > 0 && Sq > 0 && Skv > 0 && Hkv > 0 && H % Hkv == 0 && (dtype == 0 || dtype == 1);
}

}  // namespace

// B1b. dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; q, k, v,
// o and dout 16-byte aligned). q, o, dout, dq [B, Sq, H, D]; k, v [B, Skv,
// Hkv, D]; lse and delta (written) [B, H, Sq] f32; seg [B, Skv] int32 or
// null. Returns a cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, const void* seg, void* dq,
                            void* delta, int B, int Sq, int Skv, int H, int Hkv, int D,
                            int dtype, int causal, float scale, void* stream) {
  if (!valid(B, Sq, Skv, H, Hkv, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(dtype, q, k, v, o, dout, lse, seg, dq, delta, B, Sq, Skv, H, Hkv,
                         causal, scale, s);
  if (D == 128)
    return launch_dq<128>(dtype, q, k, v, o, dout, lse, seg, dq, delta, B, Sq, Skv, H, Hkv,
                          causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// B1c, launched after flash_bwd_dq on the same stream (it reads delta). dk,
// dv [B, Skv, Hkv, D] in the input dtype, summed over each kv head's group.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* seg, void* dk,
                             void* dv, int B, int Sq, int Skv, int H, int Hkv, int D,
                             int dtype, int causal, float scale, void* stream) {
  if (!valid(B, Sq, Skv, H, Hkv, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(dtype, q, k, v, dout, lse, delta, seg, dk, dv, B, Sq, Skv, H, Hkv,
                          causal, scale, s);
  if (D == 128)
    return launch_dkv<128>(dtype, q, k, v, dout, lse, delta, seg, dk, dv, B, Sq, Skv, H,
                           Hkv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
