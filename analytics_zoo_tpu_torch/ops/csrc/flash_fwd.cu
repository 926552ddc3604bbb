// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel ``analytics_zoo_tpu/ops/attention.py::
// _flash_fwd_kernel`` (reached through ``_flash_forward_blhd`` and
// ``_flash_forward``). It computes the same function:
//
//   s   = q . k^T * sm_scale + key_bias[b, key]
//   s   = MASK_VALUE where causal and key > row + (Lk - Lq)   (bottom-right)
//   o   = softmax(s) . v   (online softmax over key tiles, f32 statistics)
//   lse = m + log(max(l, 1e-30))
//
// with p rounded to v's dtype before p . v, as the TPU kernel does.
//
// What bounds it on this card: the two products, 4*B*H*Lq*Lk*d operations,
// against q, k, v and o bytes of 4*B*L*H*d*sizeof(T): operations in both
// dtypes on the tensor cores (bf16 at 989 TFLOP/s; float32 as three TF32
// products, "3xTF32", x = hi + lo with both halves TF32 and the lo.lo term
// dropped, an effective 495/3 TFLOP/s).
//
// What the design does about it (the backward's pieces, flash_tiles.cuh
// and wgmma.cuh):
// - One warpgroup a block owns a 64-row q tile; a loop inside the block
//   walks the key tiles (it replaces the TPU kernel's sequential grid
//   axis). K, V and the key bias stream through a two-stage cp.async ring,
//   16 bytes a copy straight from the strided (B, L, H, d) views, each
//   thread copying the same slots of every tile (conflict-free stores),
//   zero-filled past a ragged edge: 32 keys a tile in float32, 64 in bf16.
//   Tiles wholly above the causal diagonal are skipped; only tiles on a
//   ragged key edge or across the diagonal test entries.
// - In 3xTF32 shared memory, not the tensor cores, is the scarce rate:
//   every operand read from it feeds one m64n32k8 product in three. So at
//   d=64 q's A fragments are loaded once into registers, split hi/lo (at
//   d=128 wgmma reads q and its lo half from shared memory), each thread
//   splits the K slots it copied itself (no barrier before the split),
//   and V is split as its fragments are read.
// - s = q . k^T is a wgmma with B = the K tile (bf16 m64n64k16; float32
//   m64n32k8 three times: lo.hi, hi.lo, hi.hi).
// - The online softmax runs on the accumulator fragments: row max and row
//   sum over the four lanes of a quad, p = 2^(s*scale*log2 e + bias*log2 e
//   - m) on the SFU, m and l in float32 registers (l summed per lane, the
//   quad's lanes added once at the end).
// - o += round(p) . v reduces over the streamed key axis, which is not
//   V's contiguous axis, and TF32 takes only K-major B operands. It is
//   taken transposed, as the backward's dq is: o^T += v^T . round(p)^T,
//   A = v^T read column-wise into registers from the V tile already in
//   shared memory, B = round(p) written from the score accumulators into a
//   key-contiguous P tile (split hi/lo in float32). One code path serves
//   both dtypes and no operand is stored twice. The accumulator's columns
//   are then q rows, so each tile's rescale factors exp(m_old - m_new) and
//   the final l reach the column owners through shared memory, with the P
//   tile's barrier: two barriers a tile.
// - The epilogue stages o through shared memory (the free ring) so that
//   its rows leave in 16-byte stores.
// - Shared memory: float32 d=64 72.75 KB, d=128 161 KB; bf16 d=64 49 KB,
//   d=128 89 KB.
//
// Built by ``analytics_zoo_tpu_torch/ops/_kernels.py`` and called through
// ctypes (plain C interface below).

#include <climits>

#include "flash_tiles.cuh"

namespace {

using namespace zoo::flash;

constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* kbias;   // (B, Lk) f32, key stride 1
  void* o;
  float* lse;           // (B*H, Lq) f32, contiguous
  int B, H, Lq, Lk;
  int causal;
  float sm_scale;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  long long kb_sb;
};

template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int E = sizeof(T);
  // keys a streamed tile: 32 in float32, so that two blocks fit an SM at
  // d=64
  static constexpr int BN = F32 ? 32 : 64;
  static constexpr int KSTEP = F32 ? 8 : 16;  // reduction depth of a wgmma
  static constexpr int ROW = D * E;           // bytes in a row of d values
  static constexpr int PROW = BN * E;         // bytes in a row of the P tile
  static constexpr int TILE_Q = BM * ROW;
  static constexpr int TILE_S = BN * ROW;
  static constexpr int TILE_P = BM * PROW;
  static constexpr int HALVES = F32 ? 2 : 1;  // hi/lo copies
  static constexpr int MC = D / 64;           // m64 chunks of d
  static constexpr int STAGE = 2 * TILE_S + BN * 4;   // K, V, key bias
  // float32 at d=64: q's A fragments held in registers, split hi/lo (64
  // registers a thread). Elsewhere wgmma reads q from shared memory (in
  // float32 at d=128 its lo half beside it)
  static constexpr bool Q_REGS = F32 && D == 64;
  static constexpr int Q_LO = (F32 && !Q_REGS) ? TILE_Q : 0;
  // Q | Q's lo half | 2 stages | K's lo half | P (hi, lo) | per q row:
  // the tile's rescale factor and the final l
  static constexpr size_t SMEM = TILE_Q + Q_LO + 2 * STAGE +
                                 (HALVES - 1) * TILE_S + HALVES * TILE_P +
                                 2 * BM * 4;
  // a row of the o staging tile: 16 bytes of padding keep the fragment
  // stores free of bank conflicts and the rows 16-byte aligned
  static constexpr int OROW = ROW + 16;
  static_assert(BM * OROW <= 2 * STAGE, "o staging fits the ring");
  // three blocks an SM at d=64 (<= 168 registers a thread; float32 takes
  // 184 unbounded, and at two blocks an SM it waits on its own barriers
  // and products far more often)
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 1;
};

// q's A fragments over d: one set a reduction step (hi and, in float32,
// lo), loaded once
template <typename T, int D>
struct QFrags {
  static constexpr int N = Cfg<T, D>::Q_REGS ? D / Cfg<T, D>::KSTEP : 1;
  uint32_t hi[N][4], lo[N][4];
};

// s += q . k^T over d (64 x BN): q's fragments from registers, or q's tile
// (and in float32 its lo half) from shared memory; k (and in float32 its
// lo half) by shared address
template <typename T, int D>
__device__ __forceinline__ void score_product(float (&s)[Cfg<T, D>::BN / 2],
                                              const QFrags<T, D>& qa,
                                              const unsigned char* q,
                                              const unsigned char* qlo,
                                              uint32_t k, uint32_t klo) {
  using C = Cfg<T, D>;
  zoo::wgmma_fence();
  const uint32_t qs = zoo::smem_u32(q);
  if constexpr (C::Q_REGS) {
#pragma unroll
    for (int ks = 0; ks < D / C::KSTEP; ++ks)
      mma<T, C::BN>(s, qa.hi[ks], qa.lo[ks], zoo::tile_desc(k, ks, C::ROW),
                    zoo::tile_desc(klo, ks, C::ROW));
  } else if constexpr (C::F32) {
    const uint32_t ql = zoo::smem_u32(qlo);
#pragma unroll
    for (int ks = 0; ks < D / C::KSTEP; ++ks) {
      const uint64_t kh = zoo::tile_desc(k, ks, C::ROW);
      const uint64_t qh = zoo::tile_desc(qs, ks, C::ROW);
      zoo::wgmma_tf32_n32_ss(s, zoo::tile_desc(ql, ks, C::ROW), kh);
      zoo::wgmma_tf32_n32_ss(s, qh, zoo::tile_desc(klo, ks, C::ROW));
      zoo::wgmma_tf32_n32_ss(s, qh, kh);
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < D / C::KSTEP; ++ks)
      zoo::wgmma_bf16_n64_ss(s, zoo::tile_desc(qs, ks, C::ROW),
                             zoo::tile_desc(k, ks, C::ROW));
  }
  zoo::wgmma_commit();
  zoo::wgmma_wait<0>();
  zoo::fence_regs(s);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, Cfg<T, D>::MIN_BLOCKS)
flash_fwd_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* Qlo = Qs + C::TILE_Q;                // float32 at d=128
  unsigned char* ring = Qlo + C::Q_LO;                // stage s: K, V, bias
  unsigned char* Klo = ring + 2 * C::STAGE;           // float32 only
  unsigned char* Ph = Klo + (C::HALVES - 1) * C::TILE_S;
  unsigned char* Pl = Ph + C::TILE_P;                 // float32 only
  float* corr_s = reinterpret_cast<float*>(Ph + C::HALVES * C::TILE_P);
  float* l_s = corr_s + BM;

  const int n_qt = (p.Lq + BM - 1) / BM;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = (blockIdx.x % n_qt) * BM;
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g;          // this thread's rows r0, r0 + 8
  const int q_offset = p.Lk - p.Lq;   // bottom-right causal alignment

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* kb = p.kbias + b * p.kb_sb;

  int n_tiles = (p.Lk + BN - 1) / BN;
  if (p.causal) {
    // the last key any row of this tile may see; later tiles are all masked
    const int last_key = q_offset + q0 + BM - 1;
    n_tiles = min(n_tiles, last_key / BN + 1);
  }

  // a key tile's K, V and key bias into ring stage ``st``
  auto load_stage = [&](int st, int k0) {
    unsigned char* S = ring + st * C::STAGE;
    load_tile_by_slot<T, D, BN>(S, kg, p.k_sl, k0, p.Lk, tid);
    load_tile_by_slot<T, D, BN>(S + C::TILE_S, vg, p.v_sl, k0, p.Lk, tid);
    float* bs = reinterpret_cast<float*>(S + 2 * C::TILE_S);
    for (int c = tid; c < BN; c += THREADS) {
      const bool ok = k0 + c < p.Lk;
      zoo::cp_async4(bs + c, kb + (ok ? k0 + c : 0), ok);
    }
  };

  load_tile_by_slot<T, D, BM>(Qs, qg, p.q_sl, q0, p.Lq, tid);
  zoo::cp_async_commit();
  load_stage(0, 0);
  zoo::cp_async_commit();
  zoo::cp_async_wait<1>();   // Q; tile 0 may still load
  QFrags<T, D> qa;
  if constexpr (C::Q_REGS) {
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < QFrags<T, D>::N; ++ks)
      frag_rows<D>(Qs, ks, r0, t, qa.hi[ks], qa.lo[ks]);
  } else if constexpr (C::F32) {
    split_tile<C::TILE_Q>(Qs, Qlo, tid);   // the slots this thread copied
  }

  // logits in log2 units: x = s * scale * log2(e) + bias * log2(e)
  const float c_s = p.sm_scale * LOG2E;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};   // this lane's share of the row sums
  float acc[C::MC][32];        // o^T: rows = d, cols = the block's q rows
#pragma unroll
  for (int m = 0; m < C::MC; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BN;
    unsigned char* Kt = ring + (it & 1) * C::STAGE;
    unsigned char* Vt = Kt + C::TILE_S;
    const float* bias_s = reinterpret_cast<const float*>(Kt + 2 * C::TILE_S);
    // this thread's copies of tile it have landed; in float32 it splits
    // the K slots it copied (V is split as its fragments are read)
    zoo::cp_async_wait<0>();
    if constexpr (C::F32) split_tile<C::TILE_S>(Kt, Klo, tid);
    zoo::fence_proxy_async();
    // tile it is in place; tile it-1, the P tile and the factors are no
    // longer read
    __syncthreads();
    // the next tile loads while this one is multiplied (issued after the
    // proxy fence, which would otherwise wait for it)
    if (it + 1 < n_tiles) load_stage((it + 1) & 1, k0 + BN);
    zoo::cp_async_commit();

    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    score_product<T, D>(s, qa, Qs, Qlo, zoo::smem_u32(Kt),
                        zoo::smem_u32(Klo));

    // s[4j + 2i + e] = s(row r0 + 8i, key k0 + 8j + 2t + e) -> x; masked
    // entries drop out (-inf), which equals the TPU kernel's MASK_VALUE
    // since key 0 is visible to every row
    auto logits = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 bias =
            *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * i + e;
            float x = fmaf(s[idx], c_s, (e ? bias.y : bias.x) * LOG2E);
            if constexpr (decltype(masked)::value) {
              const int key = k0 + 8 * j + 2 * t + e;
              if (key >= p.Lk ||
                  (p.causal && key > q0 + r0 + 8 * i + q_offset))
                x = -INFINITY;
            }
            s[idx] = x;
          }
      }
    };
    if (k0 + BN > p.Lk || (p.causal && k0 + BN - 1 > q0 + q_offset))
      logits(std::true_type{});
    else
      logits(std::false_type{});

    // online softmax: m, the factors, p; round(p) into the P tile
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2_approx(m_r[i] - m_use);
      m_r[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = exp2_approx(s[4 * j + 2 * i] - m_use);
        const float p1 = exp2_approx(s[4 * j + 2 * i + 1] - m_use);
        rs += p0 + p1;
        store_pair<T, C::PROW>(Ph, Pl, r0 + 8 * i, 8 * j + 2 * t, p0, p1);
      }
      l_r[i] = l_r[i] * corr + rs;
      if (t == 0) corr_s[r0 + 8 * i] = corr;
    }
    zoo::fence_proxy_async();
    __syncthreads();

    // acc[m][4j + 2i + e] = o^T(d column 64m + r0 + 8i, q row 8j + 2t + e):
    // each column takes its row's factor
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 c =
          *reinterpret_cast<const float2*>(corr_s + 8 * j + 2 * t);
#pragma unroll
      for (int m = 0; m < C::MC; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[m][4 * j + 2 * i] *= c.x;
          acc[m][4 * j + 2 * i + 1] *= c.y;
        }
    }

    // o^T += v^T . round(p)^T, reducing over the tile's keys
    const uint32_t ph_s = zoo::smem_u32(Ph), pl_s = zoo::smem_u32(Pl);
#pragma unroll
    for (int ks = 0; ks < BN / C::KSTEP; ++ks) {
      uint32_t ah[C::MC][4], al[C::MC][4];
#pragma unroll
      for (int m = 0; m < C::MC; ++m) {
        if constexpr (C::F32)
          frag_cols_split<D>(Vt, ks, 64 * m + r0, t, ah[m], al[m]);
        else
          frag_cols<T, D>(Vt, nullptr, ks, 64 * m + r0, t, ah[m], al[m]);
      }
      zoo::wgmma_fence();
#pragma unroll
      for (int m = 0; m < C::MC; ++m)
        mma<T, 64>(acc[m], ah[m], al[m], zoo::tile_desc(ph_s, ks, C::PROW),
                   zoo::tile_desc(pl_s, ks, C::PROW));
      zoo::wgmma_commit();
      zoo::wgmma_wait<1>();
    }
    zoo::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < C::MC; ++m) zoo::fence_regs(acc[m]);
  }

  // l over the row's four lanes; lse = m + log(l) in natural units
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    const int row = q0 + r0 + 8 * i;
    if (t == 0) {
      l_s[r0 + 8 * i] = l_safe;
      if (row < p.Lq)
        p.lse[(long long)bh * p.Lq + row] = m_r[i] * LN2 + logf(l_safe);
    }
  }
  zoo::cp_async_wait<0>();
  __syncthreads();   // every product is done: the ring is free; l is shared

  // o = acc / l into the staging tile (q rows x d, in T), then out in
  // 16-byte stores
  unsigned char* Os = ring;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rr = 8 * j + 2 * t + e;
      const float l_safe = l_s[rr];
#pragma unroll
      for (int m = 0; m < C::MC; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          zoo::store_f<T>(reinterpret_cast<T*>(Os + rr * C::OROW) + 64 * m +
                              r0 + 8 * i,
                          acc[m][4 * j + 2 * i + e] / l_safe);
    }
  __syncthreads();
  constexpr int CPR = C::ROW / 16;   // 16-byte chunks a row
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int c = tid; c < BM * CPR; c += THREADS) {
    const int rr = c / CPR, cc = c % CPR;
    if (q0 + rr < p.Lq)
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(
          og + (long long)(q0 + rr) * p.o_sl) + 16 * cc) =
          *reinterpret_cast<const uint4*>(Os + rr * C::OROW + 16 * cc);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Cfg<T, D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.Lq + BM - 1) / BM) * p.B * p.H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, D><<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head-dim
// stride must be 1. q, k and v must start, and step from row to row, on
// 16-byte boundaries (the tiles arrive by 16-byte cp.async), and so must
// o (its rows leave in 16-byte stores). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int zoo_flash_fwd(
    const void* q, const void* k, const void* v, const float* kbias, void* o,
    float* lse, int B, int H, int Lq, int Lk, int D, int dtype, int causal,
    float sm_scale, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, long long kb_sb, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.kbias = kbias; p.o = o; p.lse = lse;
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.causal = causal; p.sm_scale = sm_scale;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.kb_sb = kb_sb;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && D == 128) return (int)launch<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}
