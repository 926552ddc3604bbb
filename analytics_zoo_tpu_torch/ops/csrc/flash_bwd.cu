// Flash-attention backward for Hopper (sm_90a), CUDA C++: two kernels.
//
// Replace the TPU kernels ``analytics_zoo_tpu/ops/attention.py::
// _flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` (reached through
// ``_flash_backward_blhd`` and ``_flash_backward``). With the forward's
// saved lse and delta = rowsum(dO * O) (computed outside, in torch, as the
// JAX wrapper does), each rebuilds the score tile from q, k and the key
// bias under the same bottom-right causal mask and computes
//
//   p  = exp(s - lse)            s = q . k^T * sm_scale + key_bias[b, key]
//   dp = dO . v^T
//   ds = p * (dp - delta)
//   flash_bwd_dq : dq = sum_k round(ds) . k * sm_scale
//   flash_bwd_dkv: dv = sum_q round(p)^T . dO
//                  dk = sum_q round(ds)^T . q * sm_scale
//                  db = sum_q ds            (per head; summed over heads
//                                            outside, in torch)
//
// where round() is the cast to the operand dtype the TPU kernels make
// before those products (identity in float32).
//
// What bounds them on this card: dq does three L x L products
// (6*B*H*Lq*Lk*d operations), dkv four (8*B*H*Lq*Lk*d), against q, k, v,
// dO reads and one or two L x d writes: operations, by far. On the tensor
// cores bf16 runs at 989 TFLOP/s. float32 has to stay float32-accurate, so
// each product runs as three TF32 products ("3xTF32": x = hi + lo with hi
// and lo both TF32, a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi; the dropped
// lo.lo term and lo's own rounding are ~2^-22 relative), an effective
// 495/3 = 165 TFLOP/s, 2.5x the CUDA cores' float32 peak.
//
// What the design does about it.
// - Every product is a warpgroup ``wgmma`` (csrc/wgmma.cuh) with f32
//   accumulators in registers: bf16 m64nNk16, tf32 m64nNk8. A block is one
//   warpgroup that owns 64 rows: flash_bwd_dq a q tile (dq summed over the
//   key tiles it walks), flash_bwd_dkv a key tile (dk, dv and db summed
//   over the q tiles it walks). Each output is owned by one block and
//   summed in one fixed order: no atomics, deterministic, as on the TPU.
// - wgmma reads B from shared memory with its reduction axis contiguous
//   (TF32 takes no other layout). The first products (s, dp; dkv: s^T,
//   dp^T) reduce over d, contiguous in every operand: A is a resident tile
//   read from shared memory ("SS"; in float32 the second one's fragments
//   sit in registers at d=64), B the streamed tile. The second products
//   reduce over the streamed axis, so they are taken transposed: dq^T +=
//   k^T . ds^T (dkv: dv^T += dO^T . p, dk^T += q^T . ds), with A = k^T
//   (dO^T, q^T) read column-wise into registers out of the tile already in
//   shared memory, and B = round(ds) (round(p)) written from the score
//   accumulators into a shared tile whose contiguous axis is the streamed
//   one. No operand is stored twice.
// - float32: every operand is split once into TF32 hi and lo halves: the
//   resident tiles when they land, the streamed tile in place with its lo
//   half beside it, round(ds) / round(p) as they are written.
// - Streamed tiles (K, V and the key bias for dq; Q, dO, lse and delta for
//   dkv) arrive by cp.async, 16 bytes a copy straight from the strided
//   (B, L, H, d) views, zero-filled past a ragged edge, in a two-stage
//   ring: tile t+1 loads while tile t is multiplied. 64 rows a tile in
//   bf16; 32 in float32, so that two blocks share an SM at d=64.
// - Shared memory: float32 d=64 96 KB (dq) / 113 KB (dkv), d=128 208 /
//   225 KB; bf16 d=64 57 / 65 KB, d=128 105 / 113 KB.
// - p = exp2(s * scale * log2 e + (bias - lse) * log2 e) on the SFU. Only
//   tiles on a ragged edge or across the causal diagonal (skipped when
//   wholly above it) test each entry.
//
// Built by ``analytics_zoo_tpu_torch/ops/_kernels.py`` and called through
// ctypes (plain C interface below).

#include <type_traits>

#include "flash_tiles.cuh"

namespace {

using namespace zoo::flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* kbias;   // (B, Lk) f32, key stride 1
  const float* lse;     // (B*H, Lq) f32, contiguous
  const float* delta;   // (B, Lq, H) f32, contiguous
  void* dq;
  void* dk;
  void* dv;
  float* dbias;         // (B*H, Lk) f32, contiguous
  int B, H, Lq, Lk;
  int causal;
  float sm_scale;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long do_sb, do_sl, do_sh;
  long long dq_sb, dq_sl, dq_sh;
  long long dk_sb, dk_sl, dk_sh;
  long long dv_sb, dv_sl, dv_sh;
  long long kb_sb;
};

template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int E = sizeof(T);
  // streamed rows: 32 in float32, so that two blocks fit an SM at d=64
  static constexpr int BN = F32 ? 32 : 64;
  static constexpr int KSTEP = F32 ? 8 : 16;  // reduction depth of a wgmma
  static constexpr int ROW = D * E;           // bytes in a row of d values
  static constexpr int PROW = BN * E;         // bytes in a row of a P tile
  static constexpr int TILE_R = BM * ROW;     // an owned (resident) tile
  static constexpr int TILE_S = BN * ROW;     // a streamed tile
  static constexpr int TILE_P = BM * PROW;    // round(p) or round(ds)
  static constexpr int HALVES = F32 ? 2 : 1;  // hi/lo copies of B tiles
  static constexpr int LO_S = F32 ? 2 * TILE_S : 0;
  static constexpr int MC = D / 64;           // m64 chunks of d
  // float32: A2's fragments held in registers (see ResidentA2)
  static constexpr bool A2_REGS = F32 && D == 64;
  // float32 at d=128: room for A1's lo half
  static constexpr int A1_LO = (F32 && !A2_REGS) ? TILE_R : 0;
  // blocks an SM: registers (<= 168 a thread) let three bf16 d=64 blocks
  // share one; float32 is held to two by shared memory
  static constexpr int MIN_BLOCKS = (!F32 && D == 64) ? 3 : 1;
  // a ring stage: K, V and the key bias (dq); Q, dO, lse and delta (dkv)
  static constexpr int DQ_STAGE = 2 * TILE_S + BN * 4;
  static constexpr int DKV_STAGE = 2 * TILE_S + 2 * BN * 4;
  // Q, dO | 2 stages | lo halves of K, V | dS | Q's lo half (d=128)
  static constexpr size_t DQ_SMEM =
      2 * TILE_R + 2 * DQ_STAGE + LO_S + HALVES * TILE_P + A1_LO;
  // K, V | 2 stages | lo halves of Q, dO | P, dS | K's lo half (d=128)
  static constexpr size_t DKV_SMEM =
      2 * TILE_R + 2 * DKV_STAGE + LO_S + 2 * HALVES * TILE_P + A1_LO;
};

// The first products' A operands are the block's two resident tiles (q
// and dO for dq, k and v for dkv). wgmma reads A1 from shared memory; in
// float32 it is split once, a TF32 hi half in place and its lo half
// beside it. A2 is read from shared memory too in bf16; in float32 its
// fragments are split once into registers at d=64, and at each tile at
// d=128, where they would take too many registers.
template <typename T, int D>
struct ResidentA2 {
  static constexpr int N = Cfg<T, D>::A2_REGS ? D / Cfg<T, D>::KSTEP : 1;
  uint32_t hi[N][4], lo[N][4];
};

// s += A1 . B1^T and dp += A2 . B2^T over d, the first products: B1, B2
// the streamed tiles (shared addresses; ``lo``: their lo halves)
template <typename T, int D, int BN>
__device__ __forceinline__ void first_products(
    float (&s)[BN / 2], float (&dp)[BN / 2], const unsigned char* a1,
    const unsigned char* a1lo, const unsigned char* a2,
    const ResidentA2<T, D>& a2r, uint32_t b1, uint32_t b1lo, uint32_t b2,
    uint32_t b2lo, int r0, int t) {
  using C = Cfg<T, D>;
  const uint32_t a1s = zoo::smem_u32(a1);
  if constexpr (C::F32) {
    static_assert(BN == 32, "float32 streams 32-row tiles");
    const uint32_t a1l = zoo::smem_u32(a1lo);
    // s: lo.hi, hi.lo, hi.hi into one accumulator
    auto s_step = [&](int ks) {
      const uint64_t bh = zoo::tile_desc(b1, ks, C::ROW);
      const uint64_t ah = zoo::tile_desc(a1s, ks, C::ROW);
      zoo::wgmma_tf32_n32_ss(s, zoo::tile_desc(a1l, ks, C::ROW), bh);
      zoo::wgmma_tf32_n32_ss(s, ah, zoo::tile_desc(b1lo, ks, C::ROW));
      zoo::wgmma_tf32_n32_ss(s, ah, bh);
    };
    if constexpr (C::A2_REGS) {
      zoo::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / C::KSTEP; ++ks) {
        s_step(ks);
        mma<T, BN>(dp, a2r.hi[ks], a2r.lo[ks], zoo::tile_desc(b2, ks, C::ROW),
                   zoo::tile_desc(b2lo, ks, C::ROW));
      }
      zoo::wgmma_commit();
    } else {
      // at most two reduction steps in flight, so that the fragments of
      // older ones free their registers
#pragma unroll
      for (int ks = 0; ks < D / C::KSTEP; ++ks) {
        uint32_t h2[4], l2[4];
        frag_rows<D>(a2, ks, r0, t, h2, l2);
        zoo::wgmma_fence();
        s_step(ks);
        mma<T, BN>(dp, h2, l2, zoo::tile_desc(b2, ks, C::ROW),
                   zoo::tile_desc(b2lo, ks, C::ROW));
        zoo::wgmma_commit();
        zoo::wgmma_wait<1>();
      }
    }
  } else {
    const uint32_t a2s = zoo::smem_u32(a2);
    zoo::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / C::KSTEP; ++ks) {
      zoo::wgmma_bf16_n64_ss(s, zoo::tile_desc(a1s, ks, C::ROW),
                             zoo::tile_desc(b1, ks, C::ROW));
      zoo::wgmma_bf16_n64_ss(dp, zoo::tile_desc(a2s, ks, C::ROW),
                             zoo::tile_desc(b2, ks, C::ROW));
    }
    zoo::wgmma_commit();
  }
  zoo::wgmma_wait<0>();
  zoo::fence_regs(s);
  zoo::fence_regs(dp);
}

// Once the resident tiles have landed (float32 only): A2's fragments into
// registers (d=64), then A1 split into hi in place and lo at ``a1lo``,
// which at d=64 is A2's shared tile, no longer read.
template <typename T, int D>
__device__ __forceinline__ void prepare_resident(unsigned char* a1,
                                                 unsigned char* a1lo,
                                                 const unsigned char* a2,
                                                 ResidentA2<T, D>& a2r,
                                                 int r0, int t, int tid) {
  using C = Cfg<T, D>;
  if constexpr (C::F32) {
    zoo::cp_async_wait<1>();   // the resident group; tile 0 may still load
    __syncthreads();
    if constexpr (C::A2_REGS) {
#pragma unroll
      for (int ks = 0; ks < D / C::KSTEP; ++ks)
        frag_rows<D>(a2, ks, r0, t, a2r.hi[ks], a2r.lo[ks]);
      __syncthreads();
    }
    split_tile<C::TILE_R>(a1, a1lo, tid);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, Cfg<T, D>::MIN_BLOCKS)
flash_bwd_dq_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* dOs = Qs + C::TILE_R;
  unsigned char* ring = dOs + C::TILE_R;      // stage s: K, V, key bias
  unsigned char* Klo = ring + 2 * C::DQ_STAGE;  // float32 only
  unsigned char* Vlo = Klo + C::TILE_S;
  unsigned char* dSh = Klo + C::LO_S;
  unsigned char* dSl = dSh + C::TILE_P;       // float32 only
  unsigned char* Qlo = C::A2_REGS ? dOs : dSl + C::TILE_P;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g;          // this thread's rows r0, r0 + 8
  const int q_offset = p.Lk - p.Lq;   // bottom-right causal alignment

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kb = p.kbias + b * p.kb_sb;

  int n_tiles = (p.Lk + BN - 1) / BN;
  if (p.causal) {
    // the last key any row of this tile may see; later tiles are all masked
    const int last_key = q_offset + q0 + BM - 1;
    n_tiles = min(n_tiles, last_key / BN + 1);
  }

  // a key tile's K, V and key bias into ring stage ``st``
  auto load_stage = [&](int st, int k0) {
    unsigned char* S = ring + st * C::DQ_STAGE;
    load_tile<T, D, BN>(S, kg, p.k_sl, k0, p.Lk, tid);
    load_tile<T, D, BN>(S + C::TILE_S, vg, p.v_sl, k0, p.Lk, tid);
    float* bs = reinterpret_cast<float*>(S + 2 * C::TILE_S);
    for (int c = tid; c < BN; c += THREADS) {
      const bool ok = k0 + c < p.Lk;
      zoo::cp_async4(bs + c, kb + (ok ? k0 + c : 0), ok);
    }
  };

  load_tile<T, D, BM>(Qs, qg, p.q_sl, q0, p.Lq, tid);
  load_tile<T, D, BM>(dOs, dog, p.do_sl, q0, p.Lq, tid);
  zoo::cp_async_commit();
  load_stage(0, 0);
  zoo::cp_async_commit();
  ResidentA2<T, D> doa;
  prepare_resident<T, D>(Qs, Qlo, dOs, doa, r0, t, tid);

  // p = exp2(s * scale * log2(e) + (bias - lse) * log2(e)), 0 where masked
  const float c_s = p.sm_scale * LOG2E;
  float nlse_r[2], delta_r[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    row_ok[i] = row < p.Lq;
    nlse_r[i] = row_ok[i] ? -LOG2E * p.lse[(long long)bh * p.Lq + row] : 0.f;
    delta_r[i] = row_ok[i] ? p.delta[((long long)b * p.Lq + row) * p.H + h]
                           : 0.f;
  }
  float acc[C::MC][32];   // dq^T: rows = d, cols = the block's q rows
#pragma unroll
  for (int m = 0; m < C::MC; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BN;
    unsigned char* Kt = ring + (it & 1) * C::DQ_STAGE;
    unsigned char* Vt = Kt + C::TILE_S;
    const float* bias_s = reinterpret_cast<const float*>(Kt + 2 * C::TILE_S);
    zoo::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it-1 is no longer read
    if constexpr (C::F32) {
      split_tile<C::TILE_S>(Kt, Klo, tid);
      split_tile<C::TILE_S>(Vt, Vlo, tid);
    }
    zoo::fence_proxy_async();
    __syncthreads();
    // the next tile loads while this one is multiplied (issued after the
    // proxy fence, which would otherwise wait for it)
    if (it + 1 < n_tiles) load_stage((it + 1) & 1, k0 + BN);
    zoo::cp_async_commit();

    // s = q . k^T, dp = dO . v^T (64 x BN), reducing over d
    const uint32_t kt_s = zoo::smem_u32(Kt), vt_s = zoo::smem_u32(Vt);
    const uint32_t klo_s = zoo::smem_u32(Klo), vlo_s = zoo::smem_u32(Vlo);
    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
    first_products<T, D, BN>(s, dp, Qs, Qlo, dOs, doa, kt_s, klo_s, vt_s,
                             vlo_s, r0, t);

    // ds = p * (dp - delta), rounded into the dS tile (q rows x keys); only
    // a tile on a ragged edge or across the causal diagonal tests entries
    auto scores = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 bias =
            *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q0 + r0 + 8 * i;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t + e;
            const int idx = 4 * j + 2 * i + e;
            float pv = exp2_approx(fmaf(
                s[idx], c_s, fmaf(e ? bias.y : bias.x, LOG2E, nlse_r[i])));
            if constexpr (decltype(masked)::value) {
              if (!row_ok[i] || key >= p.Lk ||
                  (p.causal && key > row + q_offset))
                pv = 0.f;
            }
            ds[e] = pv * (dp[idx] - delta_r[i]);
          }
          store_pair<T, C::PROW>(dSh, dSl, r0 + 8 * i, 8 * j + 2 * t,
                                 ds[0], ds[1]);
        }
      }
    };
    if (k0 + BN > p.Lk || q0 + BM > p.Lq ||
        (p.causal && k0 + BN - 1 > q0 + q_offset))
      scores(std::true_type{});
    else
      scores(std::false_type{});
    zoo::fence_proxy_async();
    __syncthreads();

    // dq^T += k^T . round(ds)^T, reducing over the tile's keys
    const uint32_t dsh_s = zoo::smem_u32(dSh), dsl_s = zoo::smem_u32(dSl);
#pragma unroll
    for (int ks = 0; ks < BN / C::KSTEP; ++ks) {
      uint32_t ah[C::MC][4], al[C::MC][4];
#pragma unroll
      for (int m = 0; m < C::MC; ++m)
        frag_cols<T, D>(Kt, Klo, ks, 64 * m + r0, t, ah[m], al[m]);
      zoo::wgmma_fence();
#pragma unroll
      for (int m = 0; m < C::MC; ++m)
        mma<T, 64>(acc[m], ah[m], al[m], zoo::tile_desc(dsh_s, ks, C::PROW),
                   zoo::tile_desc(dsl_s, ks, C::PROW));
      zoo::wgmma_commit();
      zoo::wgmma_wait<1>();
    }
    zoo::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < C::MC; ++m) zoo::fence_regs(acc[m]);
  }

  // acc[m][4j + 2i + e] = dq^T(d column 64m + r0 + 8i, q row 8j + 2t + e)
  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int m = 0; m < C::MC; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = q0 + 8 * j + 2 * t + e;
        if (row < p.Lq) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            zoo::store_f<T>(dqg + (long long)row * p.dq_sl + 64 * m + r0 +
                                8 * i,
                            acc[m][4 * j + 2 * i + e] * p.sm_scale);
        }
      }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, Cfg<T, D>::MIN_BLOCKS)
flash_bwd_dkv_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int BN = C::BN;
  constexpr int STAGE = C::DKV_STAGE;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + C::TILE_R;
  unsigned char* ring = Vs + C::TILE_R;
  unsigned char* Qlo = ring + 2 * STAGE;      // float32 only
  unsigned char* dOlo = Qlo + C::TILE_S;
  unsigned char* Ph = Qlo + C::LO_S;
  unsigned char* dSh = Ph + C::TILE_P;
  unsigned char* Pl = dSh + C::TILE_P;        // float32 only
  unsigned char* dSl = Pl + C::TILE_P;
  unsigned char* Klo = C::A2_REGS ? Vs : dSl + C::TILE_P;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g;          // this thread's keys r0, r0 + 8
  const int q_offset = p.Lk - p.Lq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse_g = p.lse + (long long)bh * p.Lq;
  const float* delta_g = p.delta + (long long)b * p.Lq * p.H + h;

  const int n_tiles = (p.Lq + BN - 1) / BN;
  int t0 = 0;
  if (p.causal) {
    // query tiles whose last row sees no key of this tile are all masked
    const int first_row = k0 - q_offset;
    t0 = first_row > 0 ? first_row / BN : 0;
  }

  // a q tile, its lse and its delta into ring stage ``st``
  auto load_stage = [&](int st, int q0) {
    unsigned char* S = ring + st * STAGE;
    load_tile<T, D, BN>(S, qg, p.q_sl, q0, p.Lq, tid);
    load_tile<T, D, BN>(S + C::TILE_S, dog, p.do_sl, q0, p.Lq, tid);
    float* ls = reinterpret_cast<float*>(S + 2 * C::TILE_S);
    for (int c = tid; c < BN; c += THREADS) {
      const bool ok = q0 + c < p.Lq;
      const int row = ok ? q0 + c : 0;
      zoo::cp_async4(ls + c, lse_g + row, ok);
      zoo::cp_async4(ls + BN + c, delta_g + (long long)row * p.H, ok);
    }
  };

  load_tile<T, D, BM>(Ks, kg, p.k_sl, k0, p.Lk, tid);
  load_tile<T, D, BM>(Vs, vg, p.v_sl, k0, p.Lk, tid);
  zoo::cp_async_commit();
  load_stage(0, t0 * BN);
  zoo::cp_async_commit();
  ResidentA2<T, D> va;
  prepare_resident<T, D>(Ks, Klo, Vs, va, r0, t, tid);

  // p = exp2(s * scale * log2(e) + (bias - lse) * log2(e)), 0 where masked
  const float c_s = p.sm_scale * LOG2E;
  float bias_r[2], db[2] = {0.f, 0.f};
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + 8 * i;
    key_ok[i] = key < p.Lk;
    bias_r[i] = key_ok[i] ? LOG2E * p.kbias[b * p.kb_sb + key] : 0.f;
  }
  float dk[C::MC][32], dv[C::MC][32];   // dk^T, dv^T: rows = d, cols = keys
#pragma unroll
  for (int m = 0; m < C::MC; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[m][i] = dv[m][i] = 0.f;

  for (int it = t0; it < n_tiles; ++it) {
    const int q0 = it * BN;
    unsigned char* Qt = ring + ((it - t0) & 1) * STAGE;
    unsigned char* dOt = Qt + C::TILE_S;
    const float* lse_s = reinterpret_cast<const float*>(Qt + 2 * C::TILE_S);
    const float* delta_s = lse_s + BN;
    zoo::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it-1 is no longer read
    if constexpr (C::F32) {
      split_tile<C::TILE_S>(Qt, Qlo, tid);
      split_tile<C::TILE_S>(dOt, dOlo, tid);
    }
    zoo::fence_proxy_async();
    __syncthreads();
    // the next tile loads while this one is multiplied (issued after the
    // proxy fence, which would otherwise wait for it)
    if (it + 1 < n_tiles) load_stage((it + 1 - t0) & 1, q0 + BN);
    zoo::cp_async_commit();

    // s^T = k . q^T, dp^T = v . dO^T (64 keys x BN queries), over d
    const uint32_t qt_s = zoo::smem_u32(Qt), dot_s = zoo::smem_u32(dOt);
    const uint32_t qlo_s = zoo::smem_u32(Qlo), dolo_s = zoo::smem_u32(dOlo);
    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
    first_products<T, D, BN>(s, dp, Ks, Klo, Vs, va, qt_s, qlo_s, dot_s,
                             dolo_s, r0, t);

    // p, ds; round(p) and round(ds) into the P and dS tiles (keys x q);
    // only a tile on a ragged edge or across the diagonal tests entries
    auto scores = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 lse_c =
            *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
        const float2 delta_c =
            *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = k0 + r0 + 8 * i;
          float pv[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = q0 + 8 * j + 2 * t + e;
            const int idx = 4 * j + 2 * i + e;
            pv[e] = exp2_approx(fmaf(
                s[idx], c_s, fmaf(e ? lse_c.y : lse_c.x, -LOG2E, bias_r[i])));
            if constexpr (decltype(masked)::value) {
              if (!key_ok[i] || row >= p.Lq ||
                  (p.causal && key > row + q_offset))
                pv[e] = 0.f;
            }
            ds[e] = pv[e] * (dp[idx] - (e ? delta_c.y : delta_c.x));
            db[i] += ds[e];
          }
          store_pair<T, C::PROW>(Ph, Pl, r0 + 8 * i, 8 * j + 2 * t, pv[0],
                                 pv[1]);
          store_pair<T, C::PROW>(dSh, dSl, r0 + 8 * i, 8 * j + 2 * t,
                                 ds[0], ds[1]);
        }
      }
    };
    if (k0 + BM > p.Lk || q0 + BN > p.Lq ||
        (p.causal && k0 + BM - 1 > q0 + q_offset))
      scores(std::true_type{});
    else
      scores(std::false_type{});
    zoo::fence_proxy_async();
    __syncthreads();

    // dv^T += dO^T . round(p), dk^T += q^T . round(ds), over the q tile
    const uint32_t ph_s = zoo::smem_u32(Ph), pl_s = zoo::smem_u32(Pl);
    const uint32_t dsh_s = zoo::smem_u32(dSh), dsl_s = zoo::smem_u32(dSl);
#pragma unroll
    for (int ks = 0; ks < BN / C::KSTEP; ++ks) {
      uint32_t oh[C::MC][4], ol[C::MC][4], qh[C::MC][4], ql[C::MC][4];
#pragma unroll
      for (int m = 0; m < C::MC; ++m) {
        frag_cols<T, D>(dOt, dOlo, ks, 64 * m + r0, t, oh[m], ol[m]);
        frag_cols<T, D>(Qt, Qlo, ks, 64 * m + r0, t, qh[m], ql[m]);
      }
      zoo::wgmma_fence();
#pragma unroll
      for (int m = 0; m < C::MC; ++m) {
        mma<T, 64>(dv[m], oh[m], ol[m], zoo::tile_desc(ph_s, ks, C::PROW),
                   zoo::tile_desc(pl_s, ks, C::PROW));
        mma<T, 64>(dk[m], qh[m], ql[m], zoo::tile_desc(dsh_s, ks, C::PROW),
                   zoo::tile_desc(dsl_s, ks, C::PROW));
      }
      zoo::wgmma_commit();
      zoo::wgmma_wait<1>();
    }
    zoo::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < C::MC; ++m) {
      zoo::fence_regs(dv[m]);
      zoo::fence_regs(dk[m]);
    }
  }

  // dk[m][4j + 2i + e] = dk^T(d column 64m + r0 + 8i, key 8j + 2t + e)
  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int m = 0; m < C::MC; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        if (key < p.Lk) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int col = 64 * m + r0 + 8 * i;
            const int idx = 4 * j + 2 * i + e;
            zoo::store_f<T>(dkg + (long long)key * p.dk_sl + col,
                            dk[m][idx] * p.sm_scale);
            zoo::store_f<T>(dvg + (long long)key * p.dv_sl + col, dv[m][idx]);
          }
        }
      }
  // db: each key row's sum over its q columns, spread over the 4 lanes t
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x = db[i];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (t == 0 && key_ok[i])
      p.dbias[(long long)bh * p.Lk + k0 + r0 + 8 * i] = x;
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Cfg<T, D>::DQ_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + BM - 1) / BM, p.B * p.H);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Cfg<T, D>::DKV_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + BM - 1) / BM, p.B * p.H);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(
    const void* q, const void* k, const void* v, const void* dout,
    const float* kbias, const float* lse, const float* delta, void* dq,
    void* dk, void* dv, float* dbias, int B, int H, int Lq, int Lk,
    int causal, float sm_scale, const long long* st) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.kbias = kbias; p.lse = lse;
  p.delta = delta; p.dq = dq; p.dk = dk; p.dv = dv; p.dbias = dbias;
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.causal = causal; p.sm_scale = sm_scale;
  p.q_sb = st[0]; p.q_sl = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_sl = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_sl = st[7]; p.v_sh = st[8];
  p.do_sb = st[9]; p.do_sl = st[10]; p.do_sh = st[11];
  p.dq_sb = st[12]; p.dq_sl = st[13]; p.dq_sh = st[14];
  p.dk_sb = st[15]; p.dk_sl = st[16]; p.dk_sh = st[17];
  p.dv_sb = st[18]; p.dv_sl = st[19]; p.dv_sh = st[20];
  p.kb_sb = st[21];
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ``strides`` holds 22 element strides:
// (batch, length, head) of q, k, v, dO, dq, dk, dv in that order, then the
// key bias's batch stride; every head-dim stride must be 1, and q, k, v
// and dO must start, and step from row to row, on 16-byte boundaries (the
// tiles arrive by 16-byte cp.async). Each returns the cudaError_t of its
// launch (0 on success). zoo_flash_bwd_dq writes dq only;
// zoo_flash_bwd_dkv writes dk, dv and dbias.
extern "C" int zoo_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* kbias, const float* lse, const float* delta, void* dq,
    int B, int H, int Lq, int Lk, int D, int dtype, int causal,
    float sm_scale, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, kbias, lse, delta, dq, nullptr,
                               nullptr, nullptr, B, H, Lq, Lk, causal,
                               sm_scale, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch_dq<float, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_dq<float, 128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch_dq<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && D == 128) return (int)launch_dq<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int zoo_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* kbias, const float* lse, const float* delta, void* dk,
    void* dv, float* dbias, int B, int H, int Lq, int Lk, int D, int dtype,
    int causal, float sm_scale, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, kbias, lse, delta, nullptr, dk,
                               dv, dbias, B, H, Lq, Lk, causal, sm_scale,
                               strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch_dkv<float, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_dkv<float, 128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch_dkv<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && D == 128) return (int)launch_dkv<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}
