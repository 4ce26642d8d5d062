// Flash-attention forward for Hopper (sm_90a): causal or full online-softmax
// attention with GQA and optional segment ids, BSHD in, O (BSHD) + LSE out.
//
// Replaces the TPU kernel B1a: `_fwd` + `_fwd_kernel` in
// ray_tpu/ops/flash_attention.py:46-195 (pallas_call at :173).
//
// Bound on an H100 SXM: at the prefill shapes of llama3-8b (H 32, Hkv 8,
// D 128, S <= 1024) and the training shape (B 6, S 2048) the function does
// 4*B*H*D*S(S+1)/2 flops for causal attention against ~2*B*S*(H+Hkv)*D*2
// bytes in bf16, i.e. ~1000 flops per byte at S=1024: bound by operations
// (989 TFLOP/s on tensor cores), not by the 3.35 TB/s memory; below S ~ 300
// the bytes bound. The design keeps the S tile out of device memory (the
// point of the TPU kernel). bf16 (serving and training) runs both products on
// wgmma, fed by a TMA ring of K/V tiles that overlaps the loads with the
// math, in warp-specialised warpgroups (below). f32 runs on CUDA cores, so it
// is bound by their 67 TFLOP/s; it serves the f32 checks.
//
// Layout: one thread block per (q tile, q head, batch). A loop over kv tiles
// held in shared memory replaces the TPU's sequential kj grid axis. Running
// max, sum and accumulator are f32. The kv head is h / (H / Hkv) and is never
// materialised. Causal tiles wholly above the diagonal are skipped (the mask
// is col <= row, query row i at absolute position i, as on the TPU). Ragged
// edges (S not a multiple of the tile) are masked here. Rows with no valid key
// give O = 0 and LSE = -1e30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // key/value rows per smem tile
constexpr int NT = 128;   // threads per block (f32: 16 row groups x 8 lanes)

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
// bf16 on Hopper: a TMA-fed K/V ring and both products on wgmma, in three
// warpgroups per block of BQ_W = 128 query rows.
//   Warpgroup 0, the producer, gives up registers (setmaxnreg 24) and one of
//   its threads issues every load: the block's Q tile once, then the K and V
//   tiles of BKV_W = 128 rows into a ring of STAGES slots, each slot with a
//   "full" mbarrier (TMA bytes landed) and an "empty" one (both consumers done).
//   Warpgroups 1 and 2, the consumers (setmaxnreg 240), own 64 query rows
//   each. Per kv tile: S = Q K^T on wgmma m64n128k16 with Q and K read from
//   shared memory (K-major), the online softmax on S in registers, then
//   O += P V on wgmma m64nDk16 with P from registers (rounded to bf16; the row
//   sums l come from the f32 values) and V from shared memory, MN-major (so
//   V needs no transpose). S and O stay in registers, f32. A consumer issues
//   S_t together with O += P_{t-1} V_{t-1} and runs the softmax of S_t while
//   the second product is in flight; the two consumers take turns issuing
//   (named barriers), so one's softmax overlaps the other's products.
// Tiles are 128-byte swizzled (hopper.cuh), as TMA writes them and wgmma
// reads them. The maps are 4-D over (D, heads, S, B), so a tile past S comes
// back zero-filled and never holds the next batch's rows; the mask, not the
// zeros, keeps those columns out (P = 0 exactly). Only tiles that hold a
// masked slot for the warpgroup's rows (the causal diagonal, the ragged end,
// any tile under segment ids) evaluate the mask. The output goes through the
// consumer's own Q rows in shared memory and a TMA store, which writes no row
// past Sq. Blocks run the longest causal rows first.

constexpr int BQ_W = 128;   // query rows per block (two consumer warpgroups of 64)
constexpr int BKV_W = 128;  // key/value rows per ring slot
constexpr int STAGES = 3;   // ring slots (D = 128: 3 x 64 KB of K and V + 32 KB of Q)
constexpr int NT_W = 384;   // producer + two consumers
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct WgmmaSmem {
  static constexpr int CHUNK_Q = BQ_W * 128;    // bytes of one 64-column chunk of Q
  static constexpr int CHUNK_KV = BKV_W * 128;  // ... of K or V
  static constexpr int Q_BYTES = BQ_W * D * 2;
  static constexpr int KV_BYTES = BKV_W * D * 2;  // one K or one V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// What a consumer thread needs to mask its two rows of an S tile.
struct RowMask {
  int Skv, causal, row0, row1, seg0, seg1, t4;
  const int* segb;  // this batch row's segment ids, or null
};

// S = Q K^T for one ring slot into sc (issued, not committed): D/16 k steps,
// each 32 bytes further along a chunk's swizzled rows, the next chunk after 4.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_base, uint32_t k_base,
                                         int chunk_q, int chunk_kv) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    hopper::wgmma_m64n128k16_ss(sc, hopper::desc_sw128(q_base + (kk / 4) * chunk_q + off, 16, 1024),
                                hopper::desc_sw128(k_base + (kk / 4) * chunk_kv + off, 16, 1024),
                                kk > 0);
  }
}

// O += P V for one ring slot (issued, not committed): P's A fragment for kv
// step kk is S n-tiles 2kk and 2kk+1; V's k step of 16 rows is 16 * 128 bytes
// down every chunk, the chunks chunk_kv bytes apart along D.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BKV_W / 16][4],
                                         uint32_t v_base, int chunk_kv) {
#pragma unroll
  for (int kk = 0; kk < BKV_W / 16; ++kk) {
    const uint64_t dv = hopper::desc_sw128(v_base + kk * 16 * 128, chunk_kv, 1024);
    if constexpr (D == 128) {
      hopper::wgmma_m64n128k16_rs_mn(o, pa[kk], dv);
    } else {
      hopper::wgmma_m64n64k16_rs_mn(o, pa[kk], dv);
    }
  }
}

// The online softmax of one S tile whose first column is k0, in place: S is
// scaled into log2 units (and masked when `masked`), then P = exp2(S - m_new)
// with the row sums added to l; alpha = exp2(m_old - m_new) is left for O.
// Rows row0 (e < 2) and row1 (e >= 2) are each spread over a quad's 4 threads.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const RowMask& mk, int k0,
                                             bool masked, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * mk.t4 + (e & 1);
        const int row = e < 2 ? mk.row0 : mk.row1;
        bool ok = col < mk.Skv;
        if (mk.causal) ok = ok && col <= row;
        if (mk.segb != nullptr) ok = ok && mk.segb[col] == (e < 2 ? mk.seg0 : mk.seg1);
        sc[4 * j + e] = ok ? sc[4 * j + e] * scale_log2 : -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
  }
  float mx[2] = {-INFINITY, -INFINITY}, mu[2];
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // a row with nothing valid yet keeps p = 0 and O = 0: exp2(-inf - 0)
    mu[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m[r] - mu[r]);
    m[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = ex2(sc[i] - mu[r]);
    psum[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
    l[r] = l[r] * alpha[r] + psum[r];
  }
}

// P (f32 in the accumulator layout) rounded to bf16 A fragments, one per kv step.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[BKV_W / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BKV_W / 16; ++kk) {
    pa[kk][0] = pack_f32(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(NT_W, 1)
flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_o,
                            const int* __restrict__ seg, float* __restrict__ lse, int Sq,
                            int Skv, int H, int Hkv, int causal, float scale_log2) {
  using L = WgmmaSmem<D>;
  constexpr int CHUNKS = D / 64;
  constexpr int NO = D / 2;  // O accumulator registers a thread
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle wants 1024-byte chunks
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  // blocks start in the order x, y, z: the q tile is z, last tile first, so
  // the longest causal rows start first and the short ones fill the tail
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ_W;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  int n_tiles = (Skv + BKV_W - 1) / BKV_W;
  if (causal) n_tiles = min(n_tiles, (min(Sq, q0 + BQ_W) - 1) / BKV_W + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
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
      hopper::mbar_arrive_expect_tx(bar_q, L::Q_BYTES);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < CHUNKS; ++c)
          hopper::tma_load_4d(base + c * L::CHUNK_Q + half * 64 * 128, &map_q, bar_q, c * 64, h,
                              q0 + half * 64, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        hopper::mbar_wait(bar_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        hopper::mbar_arrive_expect_tx(full, 2 * L::KV_BYTES);
        for (int c = 0; c < CHUNKS; ++c) {
          hopper::tma_load_4d(base + L::K_OFF + s * L::KV_BYTES + c * L::CHUNK_KV, &map_k, full,
                              c * 64, hk, t * BKV_W, b);
          hopper::tma_load_4d(base + L::V_OFF + s * L::KV_BYTES + c * L::CHUNK_KV, &map_v, full,
                              c * 64, hk, t * BKV_W, b);
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
    const int rw = q0 + cw * 64;      // this warpgroup's first query row
    const int rl0 = warp * 16 + g;    // this thread's rows, local: rl0 and rl0 + 8
    const int row0 = rw + rl0, row1 = row0 + 8;
    const uint32_t q_base = base + cw * 64 * 128;  // its 64 rows in every Q chunk
    int seg0 = -1, seg1 = -1;
    const int* segb = seg != nullptr ? seg + (long)b * Skv : nullptr;
    if (segb != nullptr) {  // query row i takes the id of kv slot Skv - Sq + i
      if (row0 < Sq) seg0 = segb[Skv - Sq + row0];
      if (row1 < Sq) seg1 = segb[Skv - Sq + row1];
    }

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in log2 units
    float alpha[2];
    const RowMask mk{Skv, causal, row0, row1, seg0, seg1, t4, segb};
    // mask only tiles where a slot of these rows may be out: the ragged end,
    // the causal diagonal, any tile under segment ids
    auto masked = [&](int k0) {
      return k0 + BKV_W > Skv || segb != nullptr || (causal && k0 + BKV_W - 1 > rw);
    };
    auto k_slot = [&](int s) { return base + L::K_OFF + s * L::KV_BYTES; };
    auto v_slot = [&](int s) { return base + L::V_OFF + s * L::KV_BYTES; };
    float sc[64];
    uint32_t pa[BKV_W / 16][4];
    hopper::mbar_wait(bar_q, 0);
    // The two consumers take turns issuing products (named barriers 3 and
    // 4), so that one's softmax runs while the other's products hold the
    // tensor cores; consumer 0 goes first.
    auto my_turn = [&] { hopper::named_barrier_sync(3 + cw, 256); };
    auto your_turn = [&] { hopper::named_barrier_arrive(3 + (1 - cw), 256); };
    if (cw == 1) your_turn();
    // tile 0: S and its softmax (O is still 0)
    hopper::mbar_wait(bar_full, 0);
    my_turn();
    hopper::wgmma_fence();
    issue_qk<D>(sc, q_base, k_slot(0), L::CHUNK_Q, L::CHUNK_KV);
    hopper::wgmma_commit();
    your_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    softmax_tile(sc, m, l, alpha, mk, 0, masked(0), scale_log2);
    pack_p(sc, pa);
    // tile t: S_t and O += P_{t-1} V_{t-1} go to the tensor cores together,
    // and the softmax of S_t runs while the second product is in flight
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % STAGES, sp = (t - 1) % STAGES;
      hopper::mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
      hopper::fence_regs(o);
      my_turn();
      hopper::wgmma_fence();
      issue_qk<D>(sc, q_base, k_slot(s), L::CHUNK_Q, L::CHUNK_KV);
      hopper::wgmma_commit();
      issue_pv<D>(o, pa, v_slot(sp), L::CHUNK_KV);
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
      hopper::fence_regs(sc);
      softmax_tile(sc, m, l, alpha, mk, t * BKV_W, masked(t * BKV_W), scale_log2);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * sp);  // slot sp is free again
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(sc, pa);
    }
    {
      const int sp = (n_tiles - 1) % STAGES;
      hopper::fence_regs(o);
      my_turn();
      hopper::wgmma_fence();
      issue_pv<D>(o, pa, v_slot(sp), L::CHUNK_KV);
      hopper::wgmma_commit();
      if (cw == 0) your_turn();  // consumer 1 goes last: no turn is left to give
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * sp);
    }

    // epilogue: O / l as bf16 into this warpgroup's own Q rows (swizzled as
    // the O map expects), then one TMA store per chunk; LSE from the quad's
    // first thread
    const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
    store_acc_sw128<D>(sbase + (q_base - base), L::CHUNK_Q, o, inv, rl0, t4);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + cw, 128);
    if (tid == 0) {
      for (int c = 0; c < CHUNKS; ++c)
        hopper::tma_store_4d(&map_o, q_base + c * L::CHUNK_Q, c * 64, h, rw, b);
      hopper::tma_store_commit();
    }
    if (t4 == 0) {
      float* lrow = lse + ((long)b * H + h) * Sq;
      if (row0 < Sq) lrow[row0] = l[0] > 0.f ? (m[0] + log2f(l[0])) * LN2 : LSE_EMPTY;
      if (row1 < Sq) lrow[row1] = l[1] > 0.f ? (m[1] + log2f(l[1])) * LN2 : LSE_EMPTY;
    }
    if (tid == 0) hopper::tma_store_wait_read();
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
  CUtensorMap map_q, map_k, map_v, map_o;
  int err = hopper::encode_bshd_bf16(&map_q, q, D, H, Sq, B, 64);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_k, k, D, Hkv, Skv, B, BKV_W);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_v, v, D, Hkv, Skv, B, BKV_W);
  if (err == 0) err = hopper::encode_bshd_bf16(&map_o, o, D, H, Sq, B, 64);
  if (err != 0) return err;
  constexpr int smem = WgmmaSmem<D>::BYTES;
  cudaError_t cerr = cudaFuncSetAttribute(flash_fwd_bf16_wgmma_kernel<D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid(H, B, (Sq + BQ_W - 1) / BQ_W);
  flash_fwd_bf16_wgmma_kernel<D><<<grid, NT_W, smem, stream>>>(
      map_q, map_k, map_v, map_o, static_cast<const int*>(seg), static_cast<float*>(lse), Sq,
      Skv, H, Hkv, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA-core FMAs), 1 = bfloat16 (TMA + wgmma; q, k, v
// and o 16-byte aligned). seg may be null. Returns a cudaError_t, or
// hopper::ENCODE_ERROR_BASE + a CUresult when a tensor map cannot be encoded.
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
