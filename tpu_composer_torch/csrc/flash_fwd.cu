// K1: FlashAttention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels tpu_composer/ops/attention.py::_fwd_kernel
// (with the lse write) and ::_fwd_kernel_nolse (without it). Same
// function: S = (Q·Kᵀ) in fp32 from input-dtype operands, times 1/√D on
// the logits (q is never pre-scaled); causal keeps row >= col in absolute
// positions, fills -1e30 and skips K tiles wholly above the diagonal; an
// online softmax with fp32 m, l and acc, where l sums the unrounded fp32
// P; P is cast to the V dtype before P·V; out = acc / max(l, 1e-30);
// lse = m + log(max(l, 1e-30)) is written only when its pointer is
// non-null, as a plain (B·H, Sq) fp32 array.
//
// What bounds it on this card. At the training shape (B 8, S 512, H 8
// over KV 2, D 64, bf16, causal) the two products are ≈2.2 GFLOP over the
// live (q, k) pairs, ≈2.2 µs at 989 TFLOP/s, and the inputs and outputs
// are ≈10.6 MB, ≈3.2 µs at 3.35 TB/s: bytes, by a little. At the serving
// prefill shape (one prompt of 256, 8 heads) both bounds are under 0.2 µs
// and a launch is bound by its latency and by how many SMs it fills.
//
// bf16 (the speed path): tensor cores and asynchronous copies.
// - One CTA of 4 warps per (b·H + h, ROWS query rows). ROWS is chosen by
//   the caller (ops/attention.py::_fwd_rows): 64 when B·H·ceil(Sq/64)
//   fills the 132 SMs, each warp owning 16 rows and walking every K tile;
//   else 16, so a short prefill still spreads over the card: the 4 warps
//   share the 16 rows and split the K tiles (warp w takes t ≡ w mod 4),
//   and their partial (m, l, acc) merge in shared memory at the end in
//   the fixed order w = 0 … 3 (as the sequential online softmax, each
//   warp rounds P at its own running max). Heads vary fastest in the grid
//   and q tiles run from the last, so the causal CTAs with the most K
//   tiles, of every head, start first and none is left for the tail.
// - The Q tile is copied once into shared memory with cp.async and each
//   warp keeps its Q fragments in registers. K/V tiles of 64 keys are
//   staged in bf16 shared memory by cp.async.cg 16-byte copies, double
//   buffered in 64-row CTAs: tile t+1 is in flight while tile t computes
//   (16-row CTAs load their 4 warps' tiles at once, one stage). Rows are
//   padded by 16 bytes, so the 8 rows an ldmatrix reads fall in distinct
//   banks; rows past Sk are zero-filled by the copy itself.
// - S = Q·Kᵀ runs as mma.sync m16n8k16 (bf16 in, fp32 accumulate), K
//   fragments by ldmatrix. The online softmax works on the fp32
//   accumulator fragments: each thread holds two rows, and a row's max
//   and sum combine over the 4 threads of an mma quad with two
//   __shfl_xor_sync. P's fp32 fragments become bf16 A fragments in
//   registers (the rounding is the reference's cast before P·V) and
//   O += P·V runs on the tensor cores with V fragments by ldmatrix.trans.
//   P never goes through shared memory.
// fp32 (the checking path of serve_exact and train_exact, held to exact
// greedy tokens and 1e-4 losses) stays on CUDA cores: no tensor-core
// product keeps fp32's precision (TF32 keeps ten mantissa bits). One CTA
// per 32 query rows, 8 threads per row, fp32 FMAs from shared memory.
//
// Both read the (B, S, heads, D) layout the model produces and compute
// the GQA fan-in here (kv head = h / (H / KV)), so K/V are never repeated
// in memory. Ragged tile edges (Sq or Sk not a multiple of the tile) are
// masked here.

#include <math.h>

#include "tensor_core.cuh"

namespace {

using tc::bf16;
constexpr float NEG_INF = -1e30f;

// ---- fp32: CUDA cores --------------------------------------------------

namespace fp32 {

constexpr int BQ = 32;              // query rows per CTA
constexpr int BK = 64;              // keys per K/V tile
constexpr int TPR = 8;              // threads per query row
constexpr int NTHREADS = BQ * TPR;  // 256
constexpr int KPT = BK / TPR;       // keys per thread in Q·Kᵀ
constexpr int QCHUNK = 16;          // q values held in registers at once

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// Each query row belongs to TPR neighbouring threads of one warp: for
// Q·Kᵀ each takes every TPR-th key of the tile, the row max and sum are
// combined with warp shuffles, and for P·V each owns every TPR-th output
// column in registers. Shared rows are padded by one float so the
// row-strided reads fall in distinct banks.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int causal) {
  static_assert(D % TPR == 0 && D % QCHUNK == 0, "head_dim tiling");
  constexpr int DPT = D / TPR;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // BQ x (D + 1)
  float* k_s = q_s + BQ * (D + 1);    // BK x (D + 1)
  float* v_s = k_s + BK * (D + 1);    // BK x D
  float* p_s = v_s + BK * D;          // BQ x (BK + 1)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int qi = q0 + row;
  const float scale = 1.0f / sqrtf((float)D);

  const long q_stride = (long)H * D;    // between sequence positions
  const long kv_stride = (long)KV * D;
  const float* qb = q + ((long)b * Sq * H + h) * D;
  const float* kb = k + ((long)b * Sk * KV + kvh) * D;
  const float* vb = v + ((long)b * Sk * KV + kvh) * D;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int s = q0 + r;
    q_s[r * (D + 1) + c] = s < Sq ? qb[s * q_stride + c] : 0.f;
  }

  float m = NEG_INF;
  float l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    // Tiles whose first key lies past this CTA's last query row hold
    // only masked keys: skip them (exp(-1e30 - m) would add exactly 0).
    const int last_q = min(q0 + BQ, Sq) - 1;
    n_tiles = min(n_tiles, last_q / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile fully consumed (and q_s loaded)
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      const int s = k0 + r;
      const bool in = s < Sk;
      k_s[r * (D + 1) + c] = in ? kb[s * kv_stride + c] : 0.f;
      v_s[r * D + c] = in ? vb[s * kv_stride + c] : 0.f;
    }
    __syncthreads();

    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
    const float* qr = q_s + row * (D + 1);
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += QCHUNK) {
      float qv[QCHUNK];
#pragma unroll
      for (int u = 0; u < QCHUNK; ++u) qv[u] = qr[c0 + u];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float* kr = k_s + (lane + TPR * j) * (D + 1) + c0;
#pragma unroll
        for (int u = 0; u < QCHUNK; ++u) sc[j] = fmaf(qv[u], kr[u], sc[j]);
      }
    }

    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kj = k0 + lane + TPR * j;
      float s = sc[j] * scale;
      if (causal && kj > qi) s = NEG_INF;
      sc[j] = s;
      if (kj < Sk) mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kj = k0 + lane + TPR * j;
      const float p = kj < Sk ? expf(sc[j] - m_new) : 0.f;
      psum += p;
      p_s[row * (BK + 1) + lane + TPR * j] = p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's P was written by lanes of this warp

    const int kmax = min(BK, Sk - k0);
    const float* pr = p_s + row * (BK + 1);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int j = 0; j < kmax; ++j) {
      const float pj = pr[j];
      const float* vr = v_s + j * D + lane;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(pj, vr[TPR * i], acc[i]);
    }
  }

  if (qi < Sq) {
    const float lc = fmaxf(l, 1e-30f);
    float* orow = o + (((long)b * Sq + qi) * H + h) * D + lane;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[TPR * i] = acc[i] / lc;
    if (lse != nullptr && lane == 0) lse[(long)bh * Sq + qi] = m + logf(lc);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int H, int KV, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static std::atomic<unsigned> attr_set{0};
  cudaError_t err = smem_limit_once(attr_set, flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Sk, H, KV, causal);
  return (int)cudaGetLastError();
}

}  // namespace fp32

// ---- bf16: tensor cores -------------------------------------------------

namespace tc {

constexpr int BK = 64;   // keys per K/V tile
// Warps of a CTA: QW along the query rows (16 rows each) times KW along
// the keys. QW = 4, KW = 1 (64 rows): each warp walks every K tile of its
// rows, double buffered. QW = 1, KW = 4 (16 rows): the four warps share
// the 16 rows and split the K tiles (warp w takes tiles t ≡ w mod 4,
// loaded together, one stage); their partial softmaxes (m, l, acc) merge
// in shared memory at the end, in the fixed order w = 0 … 3. Either way
// the CTA's 128 threads share the copies.
template <int D, int QW, int KW>
constexpr size_t smem_bytes() {
  // Q tile, then one stage (KW > 1) or two (KW = 1) of KW (K, V) tiles.
  return sizeof(bf16) * (size_t)(16 * QW + (KW == 1 ? 2 : 1) * KW * 2 * BK) *
         (D + PAD);
}

// P's fragments reach P·V in registers (tensor_core.cuh).
template <int D, int QW, int KW>
__global__ void __launch_bounds__(32 * QW * KW)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                    int causal) {
  static_assert(D % 16 == 0, "head_dim tiling");
  static_assert(QW == 1 || KW == 1, "split the rows or the keys");
  constexpr int ROWS = 16 * QW;         // query rows per CTA
  constexpr int NT = 32 * QW * KW;      // threads
  constexpr int STAGES = KW == 1 ? 2 : 1;
  constexpr int LD = D + PAD;           // shared row stride, elements
  constexpr int STAGE = KW * 2 * BK * LD;  // K tiles, then V tiles
  constexpr int CH = D / 8;             // 16-byte chunks per row
  constexpr int KC = D / 16;            // k-chunks of Q·Kᵀ
  constexpr int NS = BK / 8;            // 8-key column tiles of S
  constexpr int NO = D / 8;             // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // ROWS x LD
  bf16* kv_s = q_s + ROWS * LD;                    // STAGES x STAGE

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // This warp's 16 query rows and its share of the K tiles. Constant where
  // QW or KW is 1: as runtime values they cost the 64-row kernel more
  // registers and much of its speed.
  const int qw = QW == 1 ? 0 : warp % QW;
  const int kw = KW == 1 ? 0 : warp / QW;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  // Heads vary fastest and q tiles run from the last, so the causal CTAs
  // with the most K tiles, of every head, are dispatched first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const float scale = 1.0f / sqrtf((float)D);

  const long q_stride = (long)H * D;  // between sequence positions
  const long kv_stride = (long)KV * D;
  const bf16* qb = q + ((long)b * Sq * H + h) * D;
  const bf16* kb = k + ((long)b * Sk * KV + kvh) * D;
  const bf16* vb = v + ((long)b * Sk * KV + kvh) * D;

  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, s = q0 + r;
    cp_async16(q_s + r * LD + c, qb + min(s, Sq - 1) * q_stride + c, s < Sq);
  }

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    // Tiles whose first key lies past this CTA's last query row hold
    // only masked keys: skip them (exp(-1e30 - m) would add exactly 0).
    const int last_q = min(q0 + ROWS, Sq) - 1;
    n_tiles = min(n_tiles, last_q / BK + 1);
  }
  const int n_iter = (n_tiles + KW - 1) / KW;
  // Tiles it·KW … it·KW + KW − 1 (keys contiguous from it·KW·BK) into
  // stage it % STAGES; tiles past n_tiles are not loaded.
  auto load_kv = [&](int it) {
    bf16* ks = kv_s + (STAGES == 2 ? it & 1 : 0) * STAGE;
    bf16* vs = ks + KW * BK * LD;
    const int n_rows = KW == 1 ? BK : min(KW, n_tiles - it * KW) * BK;
    for (int i = tid; i < n_rows * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8, s = it * KW * BK + r;
      const long off = min(s, Sk - 1) * kv_stride + c;
      cp_async16(ks + r * LD + c, kb + off, s < Sk);
      cp_async16(vs + r * LD + c, vb + off, s < Sk);
    }
  };
  if (n_iter > 0) load_kv(0);
  cp_async_commit();

  const int wq0 = q0 + qw * 16;  // this warp's first query row
  const int rows[2] = {wq0 + g, wq0 + g + 8};
  uint32_t qf[KC][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_iter; ++it) {
    if constexpr (STAGES == 2) {
      if (it + 1 < n_iter) load_kv(it + 1);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // stage it (and at it = 0 the Q tile)
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(qf[kc], q_s + (qw * 16 + (lane & 15)) * LD + kc * 16 +
                            (lane >> 4) * 8);
    }
    const int t = it * KW + kw;
    if (KW == 1 || t < n_tiles) {
      const bf16* ks = kv_s + (STAGES == 2 ? it & 1 : 0) * STAGE + kw * BK * LD;
      const bf16* vs = ks + KW * BK * LD;
      const int k0 = t * BK;

      float sc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kc * 16 + ((lane >> 3) & 1) * 8);
          mma(sc[2 * np], qf[kc], kf[0], kf[1]);
          mma(sc[2 * np + 1], qf[kc], kf[2], kf[3]);
        }
      }

      // Online softmax on the accumulator fragments: element e of tile j
      // is (rows[e / 2], key k0 + 8j + 2tq + e % 2).
      const bool edge = k0 + BK > Sk;
      const bool diag = causal && k0 + BK - 1 > wq0;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + j * 8 + 2 * tq + (e & 1);
          float s = sc[j][e] * scale;
          if (diag && kj > rows[e >> 1]) s = NEG_INF;
          sc[j][e] = s;
          if (!edge || kj < Sk) mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
      float alpha[2], m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new[r]);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + j * 8 + 2 * tq + (e & 1);
          const float p =
              (!edge || kj < Sk) ? expf(sc[j][e] - m_new[e >> 1]) : 0.f;
          sc[j][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l[r] = l[r] * alpha[r] + psum[r];
        m[r] = m_new[r];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // O += P·V, P rounded to bf16 in registers.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {pack(sc[2 * kk][0], sc[2 * kk][1]),
                                pack(sc[2 * kk][2], sc[2 * kk][3]),
                                pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t vf[4];
          ldsm_x4_t(vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LD + dp * 16 + (lane >> 4) * 8);
          mma(acc[2 * dp], pa, vf[0], vf[1]);
          mma(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the stage is refilled next
    if constexpr (STAGES == 1) {
      if (it + 1 < n_iter) load_kv(it + 1);
    }
  }

  if constexpr (KW == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= Sq) continue;
      const float lc = fmaxf(l[r], 1e-30f);
      bf16* orow = o + (((long)b * Sq + rows[r]) * H + h) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * r] / lc, acc[j][2 * r + 1] / lc);
      if (lse != nullptr && tq == 0)
        lse[(long)bh * Sq + rows[r]] = m[r] + logf(lc);
    }
  } else {
    // Merge the KW partial softmaxes of each row: M = max m_w,
    // L = Σ l_w·e^(m_w − M), out = Σ acc_w·e^(m_w − M) / max(L, 1e-30).
    // A warp that met only masked keys has m_w = −1e30 and weight 0. The
    // stage memory is free (the loop ended on a barrier).
    constexpr int LDA = D + 8;  // fp32 row stride: fewer bank conflicts
    float* acc_s = reinterpret_cast<float*>(kv_s);  // KW x 16 x LDA
    float* ml_s = acc_s + KW * 16 * LDA;            // KW x 16 x (m, l)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kw * 16 + g + 8 * r;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<float2*>(acc_s + row * LDA + j * 8 + 2 * tq) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      if (tq == 0) {
        ml_s[row * 2] = m[r];
        ml_s[row * 2 + 1] = l[r];
      }
    }
    __syncthreads();
    for (int i = tid; i < 16 * D / 2; i += NT) {
      const int row = i / (D / 2), c = (i % (D / 2)) * 2;
      const int qi = q0 + row;
      if (qi >= Sq) continue;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < KW; ++w) M = fmaxf(M, ml_s[(w * 16 + row) * 2]);
      float L = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const float a = expf(ml_s[(w * 16 + row) * 2] - M);
        const float2 x =
            *reinterpret_cast<const float2*>(acc_s + (w * 16 + row) * LDA + c);
        L += ml_s[(w * 16 + row) * 2 + 1] * a;
        o0 += x.x * a;
        o1 += x.y * a;
      }
      const float lc = fmaxf(L, 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(o + (((long)b * Sq + qi) * H + h) * D +
                                         c) = __floats2bfloat162_rn(o0 / lc,
                                                                    o1 / lc);
      if (lse != nullptr && c == 0) lse[(long)bh * Sq + qi] = M + logf(lc);
    }
  }
}

template <int D, int QW, int KW>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int H, int KV, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, QW, KW>();
  static std::atomic<unsigned> attr_set{0};
  cudaError_t err =
      smem_limit_once(attr_set, flash_fwd_tc_kernel<D, QW, KW>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + 16 * QW - 1) / (16 * QW));
  flash_fwd_tc_kernel<D, QW, KW><<<grid, 32 * QW * KW, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, KV, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Layouts: q/o (B, Sq, H, D), k/v (B, Sk, KV, D),
// lse (B, H, Sq) fp32 or null. rows: query rows per CTA of the bf16
// kernel, 16 or 64 (the fp32 kernel's CTAs are always 32 rows, and it
// ignores rows). The bf16 kernel needs 16-byte aligned q, k, v and o.
// Returns a cudaError_t code (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Sq, int Sk, int H, int KV,
                         int D, int causal, int dtype, int rows,
                         void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return fp32::launch<64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, s);
  if (dtype == 0 && D == 128)
    return fp32::launch<128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, s);
  if (dtype == 1 && D == 64 && rows == 16)
    return tc::launch<64, 1, 4>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, s);
  if (dtype == 1 && D == 64 && rows == 64)
    return tc::launch<64, 4, 1>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, s);
  if (dtype == 1 && D == 128 && rows == 16)
    return tc::launch<128, 1, 4>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, s);
  if (dtype == 1 && D == 128 && rows == 64)
    return tc::launch<128, 4, 1>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, s);
  return (int)cudaErrorInvalidValue;
}
