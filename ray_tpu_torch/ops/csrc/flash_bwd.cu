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
// and dO rows of its block and writes it out for the dK/dV kernel, which the
// stream runs after it.
//
// Bound on an H100 SXM: at the training shape of llama8b-geom2 (B 6, S 2048,
// H 32, Hkv 8, D 128, bf16, causal) the dQ kernel does 3 products (S, dP,
// dQ) and the dK/dV kernel 4 (S, dP, dV, dK) over the S(S+1)/2 pairs the
// mask keeps: 2*B*H*D*S(S+1)/2 flops each, ~0.1 TFLOP per product against
// ~0.2 GB of operands, so both are bound by the operation rate (989 TFLOP/s
// on tensor cores), not by the 3.35 TB/s memory. The design keeps S, P, dP
// and dS out of device memory (the point of the TPU kernels); bf16 runs every
// product on wgmma, fed by TMA rings, in warp-specialised warpgroups (below);
// f32 runs on CUDA cores (67 TFLOP/s) and serves the f32 checks.
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
#include "hopper.cuh"

namespace {

constexpr int NT = 128;  // threads per f32 block (16 row groups x 8 lanes)
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
// bf16 on Hopper: both kernels in the warp-specialised shape of the forward
// (flash_fwd.cu), 384 threads a block.
//   Warpgroup 0, the producer, gives up registers (setmaxnreg 24). It loads
//   the block's own 128-row tiles once by TMA, then keeps a ring of W_STAGES
//   slots of 64-row tiles in flight, each slot with a "full" mbarrier (bytes
//   landed) and an "empty" one (one arrival per consumer warp).
//   Warpgroups 1 and 2, the consumers (setmaxnreg 240), own 64 rows of the
//   block's tile each and run every product on wgmma. They take turns to
//   issue (named barriers 3 and 4), so one's elementwise work overlaps the
//   other's products.
// B1b (dQ): own tiles Q and dO of 128 q rows; ring tiles K and V of 64 kv
//   rows. delta = rowsum(dO o O) comes first, from the dO tile in shared
//   memory and the O rows in device memory, and is written out for B1c. Per
//   kv tile: S = Q K^T and dP = dO V^T on wgmma m64n64k16 (both operands
//   K-major from swizzled shared memory); dS = P o (dP - delta) in registers,
//   P = exp2(S*scale*log2(e) - LSE*log2(e)); then dQ += dS K on wgmma m64nDk16
//   with dS from registers and K read MN-major, so K is never transposed.
//   S_t and dP_t are issued together with dQ += dS_{t-1} K_{t-1}, and dS_t
//   is computed while that product runs. dQ leaves through the consumer's
//   own Q rows in shared memory and a TMA store, which writes no row past Sq.
//   The q tile is the slowest grid axis, last tile first, so the longest
//   causal rows start first.
// B1c (dK, dV): own tiles K and V of 128 kv rows; ring tiles Q and dO of 64
//   q rows, with the tile's LSE*log2(e), delta and segment ids beside them
//   in the slot (plain loads by a second producer warp: a [B, H, Sq] f32
//   row has no stride a tensor map accepts when Sq is odd). Per q tile: S^T
//   = K Q^T and dP^T = V dO^T on wgmma m64n64k16; P^T and dS^T in registers,
//   packed to bf16 at once so that their f32 registers are dead before the
//   next products; then dV += P^T dO and dK += dS^T Q on wgmma m64nDk16 with
//   A from registers and dO / Q read MN-major from the same slot that served
//   as the K-major operand. Kv tile 0, which has the most q tiles under the
//   causal mask, starts first.
// The softmax scale is left out of dS and applied once to dQ and dK at the
// store. Tiles past S come back zero-filled; the mask (the ragged edge, the
// causal diagonal, segment ids), evaluated only on tiles that may hold a
// masked slot for the warpgroup's rows, sets P = 0 exactly.

constexpr int W_ROWS = 128;  // rows a block owns (two consumer warpgroups of 64)
constexpr int W_TILE = 64;   // rows of a ring tile
constexpr int W_STAGES = 4;  // ring slots (D = 128: 4 x 32 KB beside 64 KB of own tiles)
constexpr int NT_W = 384;    // producer + two consumers
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct BwdSmem {
  static constexpr int CHUNK_OWN = W_ROWS * 128;   // bytes of one 64-column chunk of an own tile
  static constexpr int CHUNK_RING = W_TILE * 128;  // ... of a ring tile
  static constexpr int OWN_BYTES = W_ROWS * D * 2;
  static constexpr int RING_BYTES = W_TILE * D * 2;
  static constexpr int OWN2_OFF = OWN_BYTES;  // the second own tile (dO; V)
  // slot s holds its first tile (K; Q) at RING_OFF + 2 s RING_BYTES, its second (V; dO) after it
  static constexpr int RING_OFF = 2 * OWN_BYTES;
  // B1c: slot s's LSE*log2(e), delta and segment ids, W_TILE of each
  static constexpr int ROWS_OFF = RING_OFF + 2 * W_STAGES * RING_BYTES;
  static constexpr int ROWS_BYTES = 3 * W_TILE * 4;
  static constexpr int BAR_OFF = ROWS_OFF + W_STAGES * ROWS_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * W_STAGES) + 1024;  // + alignment slack
};

// acc (64 x 64 f32) = A B^T over D, with A's and B's 64 rows K-major in
// swizzled chunks chunk_a / chunk_b bytes apart (issued, not committed).
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a, uint32_t b, int chunk_a,
                                         int chunk_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss(acc, hopper::desc_sw128(a + (kk / 4) * chunk_a + off, 16, 1024),
                               hopper::desc_sw128(b + (kk / 4) * chunk_b + off, 16, 1024),
                               kk > 0);
  }
}

// acc (64 x D f32) += A B: A (64 x 64 bf16) from registers, one fragment per
// k step; B a ring tile [64][D] read MN-major: a k step is 16 rows down every
// chunk, the chunks CHUNK_RING bytes apart along D (issued, not committed).
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[W_TILE / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < W_TILE / 16; ++kk) {
    const uint64_t desc = hopper::desc_sw128(b + kk * 16 * 128, BwdSmem<D>::CHUNK_RING, 1024);
    if constexpr (D == 128) {
      hopper::wgmma_m64n128k16_rs_mn(acc, a[kk], desc);
    } else {
      hopper::wgmma_m64n64k16_rs_mn(acc, a[kk], desc);
    }
  }
}

// A 64 x 64 f32 accumulator rounded to bf16 A fragments, one per k step.
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[W_TILE / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < W_TILE / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_f32(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// sum of the products of two vectors of 8 bf16, in f32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    s = fmaf(fx.x, fy.x, s);
    s = fmaf(fx.y, fy.y, s);
  }
  return s;
}

// What a B1b consumer thread needs to mask its two rows of an S tile.
struct DqRows {
  int Skv, causal, t4;
  int row[2], seg[2];
  const int* segb;  // this batch row's segment ids, or null
};

// dS / scale = P o (dP - delta) of one tile whose first column is k0, in
// place in dp, with P = exp2(S * scale_log2 - lse2); element i of the
// accumulator sits at row (i >> 1) & 1 of the thread's two and column
// 8 (i >> 2) + 2 t4 + (i & 1).
template <bool MASKED>
__device__ __forceinline__ void dq_ds_tile(const float (&s)[32], float (&dp)[32],
                                           const float (&lse2)[2], const float (&dlt)[2],
                                           const DqRows& mk, int k0, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2(fmaf(s[i], scale_log2, -lse2[r]));
    if (MASKED) {
      const int col = k0 + (i >> 2) * 8 + 2 * mk.t4 + (i & 1);
      bool ok = col < mk.Skv;
      if (mk.causal) ok = ok && col <= mk.row[r];
      if (mk.segb != nullptr) ok = ok && mk.segb[col] == mk.seg[r];
      p = ok ? p : 0.f;
    }
    dp[i] = p * (dp[i] - dlt[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(NT_W, 1)
flash_bwd_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const __grid_constant__ CUtensorMap map_dq,
                               const __nv_bfloat16* __restrict__ o,
                               const float* __restrict__ lse, const int* __restrict__ seg,
                               float* __restrict__ delta, int Sq, int Skv, int H, int Hkv,
                               int causal, float scale_log2, float scale) {
  using L = BwdSmem<D>;
  constexpr int CHUNKS = D / 64;
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle wants 1024-byte chunks
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bar_own = base + L::BAR_OFF;
  const uint32_t bar_full = bar_own + 8;
  const uint32_t bar_empty = bar_full + 8 * W_STAGES;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * W_ROWS;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  int n_tiles = (Skv + W_TILE - 1) / W_TILE;
  if (causal) n_tiles = min(n_tiles, (min(Sq, q0 + W_ROWS) - 1) / W_TILE + 1);
  const int wg = threadIdx.x / 128;
  auto k_slot = [&](int s) { return base + L::RING_OFF + 2 * s * L::RING_BYTES; };

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_own, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 1);
      hopper::mbar_init(bar_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(bar_own, 2 * L::OWN_BYTES);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < CHUNKS; ++c) {
          const uint32_t dst = base + c * L::CHUNK_OWN + half * W_TILE * 128;
          hopper::tma_load_4d(dst, &map_q, bar_own, c * 64, h, q0 + half * W_TILE, b);
          hopper::tma_load_4d(dst + L::OWN2_OFF, &map_do, bar_own, c * 64, h,
                              q0 + half * W_TILE, b);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % W_STAGES;
        hopper::mbar_wait(bar_empty + 8 * s, ((t / W_STAGES) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        hopper::mbar_arrive_expect_tx(full, 2 * L::RING_BYTES);
        for (int c = 0; c < CHUNKS; ++c) {
          const uint32_t dst = k_slot(s) + c * L::CHUNK_RING;
          hopper::tma_load_4d(dst, &map_k, full, c * 64, hk, t * W_TILE, b);
          hopper::tma_load_4d(dst + L::RING_BYTES, &map_v, full, c * 64, hk, t * W_TILE, b);
        }
      }
    }
  } else {
    // ---- consumers ----
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int rw = q0 + cw * 64;    // this warpgroup's first query row
    const int rl0 = warp * 16 + g;  // this thread's rows, local: rl0 and rl0 + 8
    const uint32_t q_own = base + cw * 64 * 128;  // its 64 rows in every Q chunk
    const uint32_t do_own = q_own + L::OWN2_OFF;
    const long row_off = ((long)b * H + h) * Sq;
    DqRows mk{Skv, causal, t4, {rw + rl0, rw + rl0 + 8}, {-1, -1},
              seg != nullptr ? seg + (long)b * Skv : nullptr};
    float lse2[2], dlt[2];
    hopper::mbar_wait(bar_own, 0);
    // delta = rowsum(dO o O): the quad's 4 threads take 16-byte groups t4
    // and t4 + 4 of every chunk of each of its two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = cw * 64 + rl0 + 8 * r;  // the row within the block's tile
      const int row = mk.row[r];
      float sum = 0.f;
      lse2[r] = 0.f;
      if (row < Sq) {
        const __nv_bfloat16* orow = o + ((long)b * Sq + row) * H * D + (long)h * D;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = t4 + 4 * jj;
            const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 64 + j * 8);
            const uint4 dv = *reinterpret_cast<const uint4*>(
                sbase + L::OWN2_OFF + c * L::CHUNK_OWN + hopper::sw128_offset(rl, j * 8));
            sum += dot8(ov, dv);
          }
        lse2[r] = lse[row_off + row] * LOG2E;
        if (mk.segb != nullptr) mk.seg[r] = mk.segb[Skv - Sq + row];  // query row i: kv slot Skv - Sq + i
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      dlt[r] = sum;
      if (t4 == 0 && row < Sq) delta[row_off + row] = sum;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float s[32], dp[32];
    uint32_t a[W_TILE / 16][4];
    // mask only tiles where a slot of these rows may be out: the ragged end,
    // the causal diagonal, any tile under segment ids
    auto ds_tile = [&](int k0) {
      if (k0 + W_TILE > Skv || mk.segb != nullptr || (causal && k0 + W_TILE - 1 > rw)) {
        dq_ds_tile<true>(s, dp, lse2, dlt, mk, k0, scale_log2);
      } else {
        dq_ds_tile<false>(s, dp, lse2, dlt, mk, k0, scale_log2);
      }
    };
    auto my_turn = [&] { hopper::named_barrier_sync(3 + cw, 256); };
    auto your_turn = [&] { hopper::named_barrier_arrive(3 + (1 - cw), 256); };
    if (cw == 1) your_turn();  // consumer 0 goes first
    // tile 0: S, dP and dS (dQ is still 0)
    hopper::mbar_wait(bar_full, 0);
    my_turn();
    hopper::wgmma_fence();
    issue_ss<D>(s, q_own, k_slot(0), L::CHUNK_OWN, L::CHUNK_RING);
    issue_ss<D>(dp, do_own, k_slot(0) + L::RING_BYTES, L::CHUNK_OWN, L::CHUNK_RING);
    hopper::wgmma_commit();
    your_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    ds_tile(0);
    pack_a(dp, a);
    // tile t: S_t, dP_t and dQ += dS_{t-1} K_{t-1} go to the tensor cores
    // together, and dS_t is computed while the last one runs
    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % W_STAGES, sp = (t - 1) % W_STAGES;
      hopper::mbar_wait(bar_full + 8 * st, (t / W_STAGES) & 1);
      hopper::fence_regs(dq);
      my_turn();
      hopper::wgmma_fence();
      issue_ss<D>(s, q_own, k_slot(st), L::CHUNK_OWN, L::CHUNK_RING);
      issue_ss<D>(dp, do_own, k_slot(st) + L::RING_BYTES, L::CHUNK_OWN, L::CHUNK_RING);
      hopper::wgmma_commit();
      issue_rs<D>(dq, a, k_slot(sp));
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<1>();  // S_t and dP_t are done; dQ's product may still run
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      ds_tile(t * W_TILE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * sp);  // slot sp is free again
      pack_a(dp, a);
    }
    {
      const int sp = (n_tiles - 1) % W_STAGES;
      hopper::fence_regs(dq);
      my_turn();
      hopper::wgmma_fence();
      issue_rs<D>(dq, a, k_slot(sp));
      hopper::wgmma_commit();
      if (cw == 0) your_turn();  // consumer 1 goes last: no turn is left to give
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * sp);
    }

    // epilogue: scale * dQ as bf16 into this warpgroup's own Q rows, then one
    // TMA store per chunk
    const float mul[2] = {scale, scale};
    store_acc_sw128<D>(sbase + (q_own - base), L::CHUNK_OWN, dq, mul, rl0, t4);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + cw, 128);
    if (tid == 0) {
      for (int c = 0; c < CHUNKS; ++c)
        hopper::tma_store_4d(&map_dq, q_own + c * L::CHUNK_OWN, c * 64, h, rw, b);
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
    }
  }
}

// P^T and dS^T / scale = P^T o (dP^T - delta) of one tile whose first q
// column is qs0, in place in st and dpt, from the slot's rows: lse2
// (LSE*log2(e)) at rows[0, W_TILE), delta after it, the q rows' segment ids
// after that. Element i sits at kv row (i >> 1) & 1 of the thread's two and
// q column 8 (i >> 2) + 2 t4 + (i & 1) of the tile.
template <bool MASKED>
__device__ __forceinline__ void dkv_ds_tile(float (&st)[32], float (&dpt)[32],
                                            const float* rows, const int (&kv)[2],
                                            const int (&segkv)[2], bool has_seg, int Sq,
                                            int causal, int qs0, int t4, float scale_log2) {
  const int* segq = reinterpret_cast<const int*>(rows + 2 * W_TILE);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int lc = (i >> 2) * 8 + 2 * t4 + (i & 1);
    float p = ex2(fmaf(st[i], scale_log2, -rows[lc]));
    if (MASKED) {
      const int qi = qs0 + lc;
      bool ok = qi < Sq;
      if (causal) ok = ok && kv[r] <= qi;
      if (has_seg) ok = ok && segq[lc] == segkv[r];
      p = ok ? p : 0.f;
    }
    st[i] = p;
    dpt[i] = p * (dpt[i] - rows[W_TILE + lc]);
  }
}

template <int D>
__global__ void __launch_bounds__(NT_W, 1)
flash_bwd_dkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_do,
                                const __grid_constant__ CUtensorMap map_dk,
                                const __grid_constant__ CUtensorMap map_dv,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                const int* __restrict__ seg, int Sq, int Skv, int H, int Hkv,
                                int causal, float scale_log2, float scale) {
  using L = BwdSmem<D>;
  constexpr int CHUNKS = D / 64;
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bar_own = base + L::BAR_OFF;
  const uint32_t bar_full = bar_own + 8;
  const uint32_t bar_empty = bar_full + 8 * W_STAGES;

  const int k0 = blockIdx.z * W_ROWS;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int n_rep = H / Hkv;
  // query rows below k0 see none of this block's kv rows under the causal mask
  const int qt0 = causal ? k0 / W_TILE : 0;
  const int n_qt = (Sq + W_TILE - 1) / W_TILE;
  const int nq = max(n_qt - qt0, 0);
  const int n_it = n_rep * nq;  // (q head, q tile) pairs, q head outermost
  const int wg = threadIdx.x / 128;
  auto q_slot = [&](int s) { return base + L::RING_OFF + 2 * s * L::RING_BYTES; };

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_own, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 33);  // the TMA thread and the rows' warp
      hopper::mbar_init(bar_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0 issues the TMA loads, warp 1 fills the slots' rows ----
    hopper::setmaxnreg_dec<24>();
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(bar_own, 2 * L::OWN_BYTES);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < CHUNKS; ++c) {
          const uint32_t dst = base + c * L::CHUNK_OWN + half * W_TILE * 128;
          hopper::tma_load_4d(dst, &map_k, bar_own, c * 64, hk, k0 + half * W_TILE, b);
          hopper::tma_load_4d(dst + L::OWN2_OFF, &map_v, bar_own, c * 64, hk,
                              k0 + half * W_TILE, b);
        }
      int h = hk * n_rep, qt = qt0;
      for (int i = 0; i < n_it; ++i) {
        const int s = i % W_STAGES;
        hopper::mbar_wait(bar_empty + 8 * s, ((i / W_STAGES) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        hopper::mbar_arrive_expect_tx(full, 2 * L::RING_BYTES);
        for (int c = 0; c < CHUNKS; ++c) {
          const uint32_t dst = q_slot(s) + c * L::CHUNK_RING;
          hopper::tma_load_4d(dst, &map_q, full, c * 64, h, qt * W_TILE, b);
          hopper::tma_load_4d(dst + L::RING_BYTES, &map_do, full, c * 64, h, qt * W_TILE, b);
        }
        if (++qt == n_qt) qt = qt0, ++h;
      }
    } else if (warp == 1) {
      const int lane = threadIdx.x % 32;
      int h = hk * n_rep, qt = qt0;
      for (int i = 0; i < n_it; ++i) {
        const int s = i % W_STAGES;
        hopper::mbar_wait(bar_empty + 8 * s, ((i / W_STAGES) & 1) ^ 1);
        float* rows = reinterpret_cast<float*>(sbase + L::ROWS_OFF + s * L::ROWS_BYTES);
        const long row = ((long)b * H + h) * Sq + qt * W_TILE;
        for (int r = lane; r < W_TILE; r += 32) {
          const bool in = qt * W_TILE + r < Sq;
          rows[r] = in ? lse[row + r] * LOG2E : 0.f;
          rows[W_TILE + r] = in ? delta[row + r] : 0.f;
          // query row i takes the id of kv slot Skv - Sq + i
          reinterpret_cast<int*>(rows)[2 * W_TILE + r] =
              (in && seg != nullptr) ? seg[(long)b * Skv + (Skv - Sq) + qt * W_TILE + r] : -1;
        }
        hopper::mbar_arrive(bar_full + 8 * s);
        if (++qt == n_qt) qt = qt0, ++h;
      }
    }
  } else {
    // ---- consumers ----
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int kw = k0 + cw * 64;    // this warpgroup's first kv row
    const int rl0 = warp * 16 + g;  // this thread's rows, local: rl0 and rl0 + 8
    const int kv[2] = {kw + rl0, kw + rl0 + 8};
    const uint32_t k_own = base + cw * 64 * 128;  // its 64 rows in every K chunk
    const uint32_t v_own = k_own + L::OWN2_OFF;
    const bool has_seg = seg != nullptr;
    int segkv[2] = {-1, -1};
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (has_seg && kv[r] < Skv) segkv[r] = seg[(long)b * Skv + kv[r]];

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[32], dpt[32];
    uint32_t ap[W_TILE / 16][4], ads[W_TILE / 16][4];
    auto my_turn = [&] { hopper::named_barrier_sync(3 + cw, 256); };
    auto your_turn = [&] { hopper::named_barrier_arrive(3 + (1 - cw), 256); };
    hopper::mbar_wait(bar_own, 0);
    if (cw == 1 && n_it > 0) your_turn();  // consumer 0 goes first
    for (int i = 0; i < n_it; ++i) {
      const int s = i % W_STAGES;
      const int qs0 = (qt0 + i % nq) * W_TILE;
      const uint32_t qs = q_slot(s), dos = qs + L::RING_BYTES;
      hopper::mbar_wait(bar_full + 8 * s, (i / W_STAGES) & 1);
      my_turn();
      hopper::wgmma_fence();
      issue_ss<D>(st, k_own, qs, L::CHUNK_OWN, L::CHUNK_RING);
      issue_ss<D>(dpt, v_own, dos, L::CHUNK_OWN, L::CHUNK_RING);
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      const float* rows = reinterpret_cast<const float*>(sbase + L::ROWS_OFF + s * L::ROWS_BYTES);
      // mask only tiles where a slot of these kv rows may be out: the ragged
      // q end, the causal diagonal, any tile under segment ids
      if (qs0 + W_TILE > Sq || has_seg || (causal && qs0 < kw + W_TILE - 1)) {
        dkv_ds_tile<true>(st, dpt, rows, kv, segkv, has_seg, Sq, causal, qs0, t4, scale_log2);
      } else {
        dkv_ds_tile<false>(st, dpt, rows, kv, segkv, has_seg, Sq, causal, qs0, t4, scale_log2);
      }
      pack_a(st, ap);
      pack_a(dpt, ads);
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      my_turn();
      hopper::wgmma_fence();
      issue_rs<D>(dv, ap, dos);
      issue_rs<D>(dk, ads, qs);
      hopper::wgmma_commit();
      if (cw == 0 || i + 1 < n_it) your_turn();  // consumer 1 goes last
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * s);  // slot s is free again
    }

    // epilogue: scale * dK and dV as bf16 into this warpgroup's own K and V
    // rows, then one TMA store per chunk of each
    const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
    store_acc_sw128<D>(sbase + (k_own - base), L::CHUNK_OWN, dk, mul_k, rl0, t4);
    store_acc_sw128<D>(sbase + (v_own - base), L::CHUNK_OWN, dv, mul_v, rl0, t4);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + cw, 128);
    if (tid == 0) {
      for (int c = 0; c < CHUNKS; ++c) {
        hopper::tma_store_4d(&map_dk, k_own + c * L::CHUNK_OWN, c * 64, hk, kw, b);
        hopper::tma_store_4d(&map_dv, v_own + c * L::CHUNK_OWN, c * 64, hk, kw, b);
      }
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
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
    return (int)cudaGetLastError();
  }
  CUtensorMap map_q, map_k, map_v, map_do, map_dq;
  err = hopper::encode_bshd_bf16(&map_q, q, D, H, Sq, B, W_TILE);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_k, k, D, Hkv, Skv, B, W_TILE);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_v, v, D, Hkv, Skv, B, W_TILE);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_do, dout, D, H, Sq, B, W_TILE);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_dq, dq, D, H, Sq, B, W_TILE);
  if (err != 0) return err;
  constexpr int smem = BwdSmem<D>::BYTES;
  if ((err = prepare(flash_bwd_dq_bf16_wgmma_kernel<D>, smem)) != 0) return err;
  dim3 grid(H, B, (Sq + W_ROWS - 1) / W_ROWS);
  flash_bwd_dq_bf16_wgmma_kernel<D><<<grid, NT_W, smem, stream>>>(
      map_q, map_k, map_v, map_do, map_dq, static_cast<const __nv_bfloat16*>(o),
      static_cast<const float*>(lse), static_cast<const int*>(seg), static_cast<float*>(delta),
      Sq, Skv, H, Hkv, causal, scale * LOG2E, scale);
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
    return (int)cudaGetLastError();
  }
  CUtensorMap map_q, map_k, map_v, map_do, map_dk, map_dv;
  err = hopper::encode_bshd_bf16(&map_q, q, D, H, Sq, B, W_TILE);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_k, k, D, Hkv, Skv, B, W_TILE);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_v, v, D, Hkv, Skv, B, W_TILE);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_do, dout, D, H, Sq, B, W_TILE);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_dk, dk, D, Hkv, Skv, B, W_TILE);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_dv, dv, D, Hkv, Skv, B, W_TILE);
  if (err != 0) return err;
  constexpr int smem = BwdSmem<D>::BYTES;
  if ((err = prepare(flash_bwd_dkv_bf16_wgmma_kernel<D>, smem)) != 0) return err;
  dim3 grid(Hkv, B, (Skv + W_ROWS - 1) / W_ROWS);
  flash_bwd_dkv_bf16_wgmma_kernel<D><<<grid, NT_W, smem, stream>>>(
      map_q, map_k, map_v, map_do, map_dk, map_dv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), Sq, Skv, H, Hkv, causal,
      scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

bool valid(int B, int Sq, int Skv, int H, int Hkv, int dtype) {
  return B > 0 && Sq > 0 && Skv > 0 && Hkv > 0 && H % Hkv == 0 && (dtype == 0 || dtype == 1);
}

}  // namespace

// B1b. dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (TMA + wgmma; q, k, v,
// o, dout and dq 16-byte aligned). q, o, dout, dq [B, Sq, H, D]; k, v [B,
// Skv, Hkv, D]; lse and delta (written) [B, H, Sq] f32; seg [B, Skv] int32 or
// null. Returns a cudaError_t, or hopper::ENCODE_ERROR_BASE + a CUresult when
// a tensor map cannot be encoded.
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
// Returns as flash_bwd_dq does.
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
