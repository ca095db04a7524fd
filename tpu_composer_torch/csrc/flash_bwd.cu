// B3 (dQ) and B4 (dK/dV): FlashAttention backward for Hopper (sm_90a),
// plain C interface, two entry points.
//
// Replaces the Pallas kernels tpu_composer/ops/attention.py::_dq_kernel
// (B3, flash_bwd_dq) and ::_dkv_kernel (B4, flash_bwd_dkv). Same function:
// P = exp(S·scale − lse) rebuilt in fp32 from the forward's lse, with
// S = Q·Kᵀ from input-dtype operands and the causal fill −1e30 (so masked
// pairs give exactly 0); dP = dO·Vᵀ; dS = P∘(dP − δ), rounded to the input
// dtype before dS·K and dSᵀ·Q; P rounded to dO's dtype before Pᵀ·dO;
// dQ × 1/√D at the end, dK × 1/√D once after the sum over the whole GQA
// group, dV unscaled. δ = rowsum(dO∘O) (minus the lse cotangent when lse
// is differentiated) is computed by the caller in PyTorch, as the JAX
// package computes it in XLA outside Pallas.
//
// lse and δ are read as plain (B·H, Sq) fp32 arrays: the layout K1
// (flash_fwd.cu) writes. The TPU kernels' _pack_lse/_row_view lane packing
// exists only to lay a per-row scalar out for Mosaic and has no
// counterpart here. Likewise the TPU's transposed (k, q) score orientation
// was chosen so Mosaic's lanes hold per-q scalars; here each kernel takes
// the orientation of what its CTA owns: B3 owns query rows and computes
// S (q, k); B4 owns key rows and computes Sᵀ (k, q).
//
// What bounds them on this card, at the training shape (B 8, S 512, H 8
// over KV 2, D 64, bf16, causal; 131,328 live (q, k) pairs per (b, h), 64
// (b, h)): B3 does ≈3.2 GFLOP (3 products per pair) over ≈14.9 MB, ≈4.5 µs
// at 3.35 TB/s, so bytes; B4 ≈4.3 GFLOP (4 products per pair) over
// ≈12.9 MB, ≈4.4 µs at 989 TFLOP/s, so operations.
//
// B3, both dtypes, and B4 in fp32 run on CUDA cores: a CTA owns ROWS rows
// (A and B operands staged once in fp32 shared memory) and streams tiles
// of COLS rows (X and Y) in a loop that replaces the TPU's sequential grid
// axis; each owned row belongs to TPR neighbouring threads of one warp,
// which take every TPR-th streamed row for the two score products and own
// every TPR-th output column for the accumulation. No row reduction is
// needed (lse and δ are given). B3: one CTA per (b·H + h, ROWS query
// rows), looping over the K/V tiles up to the diagonal (causal skip as
// attention.py:295). B4 in fp32 serves the checking path (train_exact,
// held to 1e-4 on losses), where no tensor-core product keeps fp32's
// precision (TF32 keeps ten mantissa bits).
//
// B4 in bf16 (the speed path) runs on tensor cores:
// - One CTA of 4 warps per (b·KV + kvh, z, key tile of 64 rows); each
//   warp owns 16 key rows, and the key tiles with the most q tiles are
//   dispatched first. The GQA group of G = H/KV query heads is split
//   across `split` CTAs (chosen by the caller,
//   ops/attention.py::_dkv_split), so at the training shape the grid is
//   (8 · 2) · 4 splits · 8 key tiles = 512 CTAs and the longest CTA walks
//   8 q tiles, not 32.
// - K and V rows are copied once into shared memory by cp.async; Q, dO,
//   lse and δ tiles (64 q rows at head_dim 64, 32 at 128) are staged in
//   bf16 / fp32 shared memory by cp.async, double buffered, rows padded by
//   16 bytes so ldmatrix is free of bank conflicts; rows past the sequence
//   are zero-filled by the copy.
// - Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ run as mma.sync m16n8k16 (bf16 in, fp32
//   accumulate); Pᵀ and dSᵀ are formed on the fp32 accumulator fragments
//   and packed to bf16 A fragments in registers (the reference's casts),
//   and dV += Pᵀ·dO, dK += dSᵀ·Q run on the tensor cores with dO and Q
//   fragments by ldmatrix.trans. dK and dV accumulate in fp32 registers.
// - With split 1 (MHA, or a grid already full) the CTA sums its heads in
//   registers and writes bf16. Otherwise each CTA writes fp32 partials to
//   a scratch buffer the caller allocates, and dkv_reduce_kernel sums the
//   split partials in the fixed order z = 0 … split−1, scales dK and rounds
//   both: deterministic run to run, no atomics.
//
// GQA fan-in (kv head = h / (H/KV)) is computed here, and inputs are read
// in the model's (B, S, heads, D) layout. Ragged tile edges are masked:
// rows past the sequence load as 0, their P is forced to 0 and their
// outputs are not written.
//
// Shared memory per CTA: B3 (fp32 staging) (4·64·(D+1) + 64·65)·4 bytes,
// 83,200 at D=64 and 148,736 at D=128; B4 fp32 adds a second 64×65 tile
// and two 64-float columns: 100,352 and 165,888 bytes; B4 bf16
// (2·64 + 4·BQ)·(D+8)·2 + 16·BQ bytes: 56,320 at D=64, 70,144 at D=128.

#include <math.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int ROWS = 64;              // rows a CTA owns (q in B3, k in B4)
constexpr int COLS = 64;              // rows per streamed tile
constexpr int TPR = 4;                // threads per owned row
constexpr int NTHREADS = ROWS * TPR;  // 256
constexpr int CPT = COLS / TPR;       // streamed rows per thread
constexpr int CHUNK = 16;             // head_dim values held at once
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the casts the TPU kernels make before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * ROWS * (D + 1) + 2 * COLS * (D + 1) +
                          ROWS * (COLS + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return dq_smem_bytes<D>() + sizeof(float) * (ROWS * (COLS + 1) + 2 * COLS);
}

// Rows [s0, s0 + n) of a (S, stride) slice into dst (n x (D + 1)) as fp32;
// rows at or past S load as 0.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          long stride, int s0, int n, int S) {
  for (int i = threadIdx.x; i < n * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int s = s0 + r;
    dst[r * (D + 1) + c] = s < S ? to_f(src[s * stride + c]) : 0.f;
  }
}

// One CHUNK of head_dim of the two score products below.
template <int D>
__device__ __forceinline__ void chunk_products(const float* ar, const float* br,
                                               const float* x_s,
                                               const float* y_s, int c0,
                                               int lane, float* sc, float* dp) {
  float av[CHUNK], bv[CHUNK];
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    av[u] = ar[c0 + u];
    bv[u] = br[c0 + u];
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const float* xr = x_s + (lane + TPR * j) * (D + 1) + c0;
    const float* yr = y_s + (lane + TPR * j) * (D + 1) + c0;
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      sc[j] = fmaf(av[u], xr[u], sc[j]);
      dp[j] = fmaf(bv[u], yr[u], dp[j]);
    }
  }
}

// sc[j] = A[row]·X[c], dp[j] = B[row]·Y[c] for the streamed rows
// c = lane + TPR·j of the current tile. The chunk loop is unrolled at
// head_dim 64 (the flagship's): not unrolling it there made B4 about
// 1.5× slower. At 128 it stays rolled, because unrolling every
// instantiation took nvcc minutes.
template <int D>
__device__ __forceinline__ void tile_products(const float* a_s, const float* b_s,
                                              const float* x_s, const float* y_s,
                                              int row, int lane, float* sc,
                                              float* dp) {
#pragma unroll
  for (int j = 0; j < CPT; ++j) sc[j] = dp[j] = 0.f;
  const float* ar = a_s + row * (D + 1);
  const float* br = b_s + row * (D + 1);
  if constexpr (D <= 64) {
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += CHUNK)
      chunk_products<D>(ar, br, x_s, y_s, c0, lane, sc, dp);
  } else {
#pragma unroll 1
    for (int c0 = 0; c0 < D; c0 += CHUNK)
      chunk_products<D>(ar, br, x_s, y_s, c0, lane, sc, dp);
  }
}

// acc[i] += Σ_c w[row][c] · X[c][lane + TPR·i] over the tile's n rows.
template <int D>
__device__ __forceinline__ void accumulate(float* acc, const float* w_s,
                                           const float* x_s, int row, int lane,
                                           int n) {
  constexpr int DPT = D / TPR;
  const float* wr = w_s + row * (COLS + 1);
  for (int c = 0; c < n; ++c) {
    const float w = wr[c];
    const float* xr = x_s + c * (D + 1) + lane;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = fmaf(w, xr[TPR * i], acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int KV, int causal) {
  static_assert(D % TPR == 0 && D % CHUNK == 0, "head_dim tiling");
  constexpr int DPT = D / TPR;
  extern __shared__ float smem[];
  float* q_s = smem;                  // ROWS x (D + 1), owned
  float* do_s = q_s + ROWS * (D + 1);  // ROWS x (D + 1), owned
  float* k_s = do_s + ROWS * (D + 1);  // COLS x (D + 1), streamed
  float* v_s = k_s + COLS * (D + 1);   // COLS x (D + 1), streamed
  float* ds_s = v_s + COLS * (D + 1);  // ROWS x (COLS + 1), dS in T

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * ROWS;
  const int row = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const int qi = q0 + row;
  const bool live = qi < Sq;
  const float scale = 1.0f / sqrtf((float)D);

  const long q_stride = (long)H * D;
  const long kv_stride = (long)KV * D;
  const long q_off = ((long)b * Sq * H + h) * D;
  const long kv_off = ((long)b * Sk * KV + kvh) * D;
  load_rows<T, D>(q_s, q + q_off, q_stride, q0, ROWS, Sq);
  load_rows<T, D>(do_s, dout + q_off, q_stride, q0, ROWS, Sq);
  const float lse_r = live ? lse[(long)bh * Sq + qi] : 0.f;
  const float dl_r = live ? delta[(long)bh * Sq + qi] : 0.f;

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  int n_tiles = (Sk + COLS - 1) / COLS;
  if (causal) {
    // K tiles wholly above the diagonal of this CTA's last row add 0.
    const int last_q = min(q0 + ROWS, Sq) - 1;
    n_tiles = min(n_tiles, last_q / COLS + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * COLS;
    __syncthreads();  // previous tile consumed (and the owned rows loaded)
    load_rows<T, D>(k_s, k + kv_off, kv_stride, k0, COLS, Sk);
    load_rows<T, D>(v_s, v + kv_off, kv_stride, k0, COLS, Sk);
    __syncthreads();

    float sc[CPT], dp[CPT];
    tile_products<D>(q_s, do_s, k_s, v_s, row, lane, sc, dp);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = lane + TPR * j;
      const int kj = k0 + c;
      float s = sc[j] * scale;
      if (causal && kj > qi) s = NEG_INF;
      const float p = (live && kj < Sk) ? expf(s - lse_r) : 0.f;
      ds_s[row * (COLS + 1) + c] = round_to<T>(p * (dp[j] - dl_r));
    }
    __syncwarp();  // the row's dS was written by lanes of this warp
    accumulate<D>(acc, ds_s, k_s, row, lane, min(COLS, Sk - k0));
  }

  if (live) {
    T* out = dq + (((long)b * Sq + qi) * H + h) * D + lane;
#pragma unroll
    for (int i = 0; i < DPT; ++i) out[TPR * i] = from_f<T>(acc[i] * scale);
  }
}

// B4 in fp32 (the checking path of train_exact): CUDA cores. One CTA per
// (b·KV + kvh, ROWS key rows) loops over the G query heads of its group
// and, for each, over the q tiles from the diagonal on (attention.py:346),
// the JAX grid (bkv, nk, group·nq): one owner per output block.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, int H, int KV,
                     int causal) {
  static_assert(D % TPR == 0 && D % CHUNK == 0, "head_dim tiling");
  constexpr int DPT = D / TPR;
  extern __shared__ float smem[];
  float* k_s = smem;                   // ROWS x (D + 1), owned
  float* v_s = k_s + ROWS * (D + 1);   // ROWS x (D + 1), owned
  float* q_s = v_s + ROWS * (D + 1);   // COLS x (D + 1), streamed
  float* do_s = q_s + COLS * (D + 1);  // COLS x (D + 1), streamed
  float* ds_s = do_s + COLS * (D + 1);  // ROWS x (COLS + 1), dSᵀ
  float* p_s = ds_s + ROWS * (COLS + 1);  // ROWS x (COLS + 1), Pᵀ
  float* lse_s = p_s + ROWS * (COLS + 1);  // COLS
  float* dl_s = lse_s + COLS;              // COLS

  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kvh = bkv % KV;
  const int G = H / KV;
  const int k0 = blockIdx.x * ROWS;
  const int row = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const int kj = k0 + row;
  const float scale = 1.0f / sqrtf((float)D);

  const long q_stride = (long)H * D;
  const long kv_stride = (long)KV * D;
  const long kv_off = ((long)b * Sk * KV + kvh) * D;
  load_rows<float, D>(k_s, k + kv_off, kv_stride, k0, ROWS, Sk);
  load_rows<float, D>(v_s, v + kv_off, kv_stride, k0, ROWS, Sk);

  float acc_k[DPT], acc_v[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int nq = (Sq + COLS - 1) / COLS;
  // Causal: q tiles whose last row lies before this CTA's first key hold
  // only masked pairs; start at the tile holding row k0.
  const int t0 = causal ? k0 / COLS : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long bh = (long)b * H + h;
    const long q_off = ((long)b * Sq * H + h) * D;
    for (int t = t0; t < nq; ++t) {
      const int q0 = t * COLS;
      __syncthreads();  // previous tile consumed (and the owned rows loaded)
      load_rows<float, D>(q_s, q + q_off, q_stride, q0, COLS, Sq);
      load_rows<float, D>(do_s, dout + q_off, q_stride, q0, COLS, Sq);
      for (int i = threadIdx.x; i < COLS; i += NTHREADS) {
        const int s = q0 + i;
        lse_s[i] = s < Sq ? lse[bh * Sq + s] : 0.f;
        dl_s[i] = s < Sq ? delta[bh * Sq + s] : 0.f;
      }
      __syncthreads();

      float sc[CPT], dp[CPT];
      tile_products<D>(k_s, v_s, q_s, do_s, row, lane, sc, dp);  // Sᵀ, dPᵀ
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = lane + TPR * j;
        const int qi = q0 + c;
        float s = sc[j] * scale;
        if (causal && kj > qi) s = NEG_INF;
        const float p = qi < Sq ? expf(s - lse_s[c]) : 0.f;
        p_s[row * (COLS + 1) + c] = p;
        ds_s[row * (COLS + 1) + c] = p * (dp[j] - dl_s[c]);
      }
      __syncwarp();  // the row's Pᵀ and dSᵀ were written by this warp
      const int n = min(COLS, Sq - q0);
      accumulate<D>(acc_v, p_s, do_s, row, lane, n);
      accumulate<D>(acc_k, ds_s, q_s, row, lane, n);
    }
  }

  if (kj < Sk) {
    const long o = (((long)b * Sk + kj) * KV + kvh) * D + lane;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dk[o + TPR * i] = acc_k[i] * scale;
      dv[o + TPR * i] = acc_v[i];
    }
  }
}

// ---- B4 in bf16: tensor cores ------------------------------------------

namespace tc {

constexpr int KROWS = 64;  // key rows per CTA: 4 warps x 16
constexpr int NT = 128;    // threads per CTA

// q rows per streamed tile: 64 at head_dim 64; 32 at 128, which keeps
// the fp32 dK and dV accumulators (2·D/8·4 floats a thread) in registers.
template <int D>
constexpr int Q_TILE = D <= 64 ? 64 : 32;

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K and V (owned), two stages of (Q, dO), two stages of (lse, δ).
  return sizeof(bf16) * (size_t)(2 * KROWS + 4 * Q_TILE<D>) * (D + PAD) +
         sizeof(float) * 4 * Q_TILE<D>;
}

// Grid (B·KV·split, ceil(Sk/64)): x = (b·KV + kvh)·split + z, y = the
// key tile, so the key tiles nearest the start (the most causal q tiles)
// are dispatched first. CTA z of a (b, kvh, key tile) takes the G/split
// query heads z·G/split.. of the group and walks their q tiles from the
// diagonal on. With split 1 it writes dK, dV in bf16;
// otherwise fp32 partials into part, (2, B, Sk, KV, split, D), which
// dkv_reduce_kernel sums. Fragment layouts as in tensor_core.cuh: the
// accumulators of Sᵀ and dPᵀ over two neighbouring 8-column q tiles are,
// packed to bf16, the A fragment of one 16-row q chunk of Pᵀ and dSᵀ.
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, float* __restrict__ part,
                        int Sq, int Sk, int H, int KV, int causal,
                        int split) {
  static_assert(D % 16 == 0, "head_dim tiling");
  constexpr int BQ = Q_TILE<D>;
  constexpr int LD = D + PAD;  // shared row stride, elements
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int KC = D / 16;   // k-chunks of K·Qᵀ and V·dOᵀ
  constexpr int NQ = BQ / 8;   // 8-column q tiles of Sᵀ and dPᵀ
  constexpr int ND = D / 8;    // 8-column tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // KROWS x LD
  bf16* v_s = k_s + KROWS * LD;                    // KROWS x LD
  bf16* qd_s = v_s + KROWS * LD;  // stage s: Q at 2s·BQ·LD, dO after it
  float* row_s = reinterpret_cast<float*>(qd_s + 4 * BQ * LD);  // lse, δ

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int bkv = blockIdx.x / split, z = blockIdx.x % split;
  const int b = bkv / KV;
  const int kvh = bkv % KV;
  const int G = H / KV, per = G / split;
  const int k0 = blockIdx.y * KROWS;
  const float scale = 1.0f / sqrtf((float)D);

  const long q_stride = (long)H * D;
  const long kv_stride = (long)KV * D;
  const long kv_off = ((long)b * Sk * KV + kvh) * D;
  for (int i = tid; i < KROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, s = k0 + r;
    const long off = kv_off + min(s, Sk - 1) * kv_stride + c;
    cp_async16(k_s + r * LD + c, k + off, s < Sk);
    cp_async16(v_s + r * LD + c, v + off, s < Sk);
  }

  // Causal: q tiles whose last row lies before this CTA's first key hold
  // only masked pairs; start at the tile holding row k0.
  const int nq = (Sq + BQ - 1) / BQ;
  const int t0 = causal ? k0 / BQ : 0;
  // Steps walk (head, q tile) in order: heads z·per …, q tiles t0 … nq−1.
  auto load_step = [&](int n, int gi, int t) {
    const int hh = kvh * G + z * per + gi;
    const int q0 = t * BQ;
    const long q_off = ((long)b * Sq * H + hh) * D;
    const long r_off = ((long)b * H + hh) * Sq;
    bf16* qs = qd_s + (n & 1) * 2 * BQ * LD;
    bf16* ds = qs + BQ * LD;
    for (int i = tid; i < BQ * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8, s = q0 + r;
      const long off = q_off + min(s, Sq - 1) * q_stride + c;
      cp_async16(qs + r * LD + c, q + off, s < Sq);
      cp_async16(ds + r * LD + c, dout + off, s < Sq);
    }
    float* ls = row_s + (n & 1) * 2 * BQ;
    for (int i = tid; i < BQ; i += NT) {
      const int s = q0 + i;
      cp_async4(ls + i, lse + r_off + min(s, Sq - 1), s < Sq);
      cp_async4(ls + BQ + i, delta + r_off + min(s, Sq - 1), s < Sq);
    }
  };
  const bool any = t0 < nq;
  if (any) load_step(0, 0, t0);
  cp_async_commit();

  const int kr[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const bf16* kw = k_s + warp * 16 * LD;
  const bf16* vw = v_s + warp * 16 * LD;
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  int gi = 0, t = t0;  // the step being computed
  for (int n = 0; any && gi < per; ++n) {
    const int next_t = t + 1 < nq ? t + 1 : t0;
    const int next_gi = t + 1 < nq ? gi : gi + 1;
    if (next_gi < per) load_step(n + 1, next_gi, next_t);
    cp_async_commit();
    cp_async_wait<1>();  // step n (and, at n = 0, K and V) has landed
    __syncthreads();
    const bf16* qs = qd_s + (n & 1) * 2 * BQ * LD;
    const bf16* ds = qs + BQ * LD;
    const float* ls = row_s + (n & 1) * 2 * BQ;
    const float* dl = ls + BQ;
    const int q0 = t * BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warp's 16 key rows.
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      const int a_off = (lane & 15) * LD + kc * 16 + (lane >> 4) * 8;
      ldsm_x4(ka, kw + a_off);
      ldsm_x4(va, vw + a_off);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t qf[4], of[4];
        const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kc * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(qf, qs + b_off);
        ldsm_x4(of, ds + b_off);
        mma(st[2 * np], ka, qf[0], qf[1]);
        mma(st[2 * np + 1], ka, qf[2], qf[3]);
        mma(dpt[2 * np], va, of[0], of[1]);
        mma(dpt[2 * np + 1], va, of[2], of[3]);
      }
    }

    // Pᵀ = exp(Sᵀ·scale − lse) under the −1e30 fill (masked pairs give
    // exactly 0); dSᵀ = Pᵀ∘(dPᵀ − δ). Element e of tile j is (key
    // kr[e / 2], query q0 + 8j + 2tq + e % 2).
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * tq + (e & 1);
        const int qi = q0 + c;
        float s = st[j][e] * scale;
        if (causal && kr[e >> 1] > qi) s = NEG_INF;
        const float p = qi < Sq ? expf(s - ls[c]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl[c]);
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q, Pᵀ and dSᵀ rounded to bf16 in
    // registers; dO and Q fragments by ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack(st[2 * kk][0], st[2 * kk][1]),
                              pack(st[2 * kk][2], st[2 * kk][3]),
                              pack(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t of[4], qf[4];
        const int t_off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          dp * 16 + (lane >> 4) * 8;
        ldsm_x4_t(of, ds + t_off);
        mma(acc_v[2 * dp], pa, of[0], of[1]);
        mma(acc_v[2 * dp + 1], pa, of[2], of[3]);
        ldsm_x4_t(qf, qs + t_off);
        mma(acc_k[2 * dp], sa, qf[0], qf[1]);
        mma(acc_k[2 * dp + 1], sa, qf[2], qf[3]);
      }
    }
    __syncthreads();  // stage n & 1 is refilled at n + 1
    gi = next_gi;
    t = next_t;
  }

  const long n_part = (long)gridDim.x * Sk * D;  // one of dK, dV
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= Sk) continue;
    const long row = ((long)b * Sk + kr[r]) * KV + kvh;
    if (part == nullptr) {
      bf16* dkr = dk + row * D + 2 * tq;
      bf16* dvr = dv + row * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dkr + j * 8) =
            __floats2bfloat162_rn(acc_k[j][2 * r] * scale,
                                  acc_k[j][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvr + j * 8) =
            __floats2bfloat162_rn(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
      }
    } else {
      float* pk = part + (row * split + z) * D + 2 * tq;
      float* pv = pk + n_part;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        *reinterpret_cast<float2*>(pk + j * 8) =
            make_float2(acc_k[j][2 * r], acc_k[j][2 * r + 1]);
        *reinterpret_cast<float2*>(pv + j * 8) =
            make_float2(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
      }
    }
  }
}

// dK = (Σ_z part_k[z]) / √D and dV = Σ_z part_v[z], z = 0 … split−1 in
// that order: the same bits on every run. One thread per 4 columns of a
// (b, key, kv head) row.
template <int D>
__global__ void __launch_bounds__(256)
dkv_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, long n_rows, int split) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * (D / 4)) return;
  const long row = i / (D / 4);
  const int c = (int)(i % (D / 4)) * 4;
  const float* pk = part + row * split * D + c;
  const float* pv = pk + n_rows * split * D;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int z = 0; z < split; ++z) {
    const float4 a = *reinterpret_cast<const float4*>(pk + z * D);
    const float4 w = *reinterpret_cast<const float4*>(pv + z * D);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += w.x; sv.y += w.y; sv.z += w.z; sv.w += w.w;
  }
  const float scale = 1.0f / sqrtf((float)D);
  __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + row * D + c);
  __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + row * D + c);
  ok[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  ok[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
  ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
  ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

}  // namespace tc

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1, *scratch;
  int B, Sq, Sk, H, KV, causal, split;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static std::atomic<unsigned> attr_set{0};
  cudaError_t err = smem_limit_once(attr_set, flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + ROWS - 1) / ROWS, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.Sq, a.Sk, a.H, a.KV, a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_fp32(const Args& a) {
  if (a.split != 1 || a.scratch != nullptr) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = dkv_smem_bytes<D>();
  static std::atomic<unsigned> attr_set{0};
  cudaError_t err = smem_limit_once(attr_set, flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + ROWS - 1) / ROWS, a.B * a.KV);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.Sq, a.Sk,
      a.H, a.KV, a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const Args& a) {
  const int G = a.H / a.KV;
  if (a.split < 1 || G % a.split != 0 ||
      (a.split > 1) != (a.scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = tc::dkv_smem_bytes<D>();
  static std::atomic<unsigned> attr_set{0};
  cudaError_t err =
      smem_limit_once(attr_set, tc::flash_bwd_dkv_tc_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  using tc::bf16;
  dim3 grid(a.B * a.KV * a.split, (a.Sk + tc::KROWS - 1) / tc::KROWS);
  tc::flash_bwd_dkv_tc_kernel<D><<<grid, tc::NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
      static_cast<float*>(a.scratch), a.Sq, a.Sk, a.H, a.KV, a.causal,
      a.split);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return (int)err;
  const long n_rows = (long)a.B * a.Sk * a.KV;
  const long n = n_rows * (D / 4);
  tc::dkv_reduce_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, a.stream>>>(
      static_cast<const float*>(a.scratch), static_cast<bf16*>(a.out0),
      static_cast<bf16*>(a.out1), n_rows, a.split);
  return (int)cudaGetLastError();
}

template <template <typename, int> class L>
int dispatch(const Args& a, int D, int dtype) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.H <= 0 || a.KV <= 0 ||
      a.H % a.KV != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return L<float, 64>::run(a);
  if (dtype == 0 && D == 128) return L<float, 128>::run(a);
  if (dtype == 1 && D == 64) return L<__nv_bfloat16, 64>::run(a);
  if (dtype == 1 && D == 128) return L<__nv_bfloat16, 128>::run(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
struct DQ {
  static int run(const Args& a) { return launch_dq<T, D>(a); }
};

// fp32 on CUDA cores, bf16 on tensor cores: dispatch by dtype.
template <typename T, int D>
struct DKV {
  static int run(const Args& a) {
    if constexpr (std::is_same_v<T, float>) return launch_dkv_fp32<D>(a);
    else return launch_dkv_bf16<D>(a);
  }
};

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Layouts: q/dout/dq (B, Sq, H, D), k/v/dk/dv
// (B, Sk, KV, D), lse/delta (B, H, Sq) fp32. Each returns a cudaError_t
// code (0 = launched).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int Sq,
                            int Sk, int H, int KV, int D, int causal,
                            int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk,
               H, KV, causal, 1, static_cast<cudaStream_t>(stream)};
  return dispatch<DQ>(a, D, dtype);
}

// split: CTAs along the GQA group of the bf16 kernel, dividing H / KV.
// With split > 1, scratch is fp32 (2, B, Sk, KV, split, D) for the
// partial dK and dV; with split 1 it is null. fp32 takes split 1 only.
// The bf16 kernel needs 16-byte aligned q, k, v and dout.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             void* scratch, int B, int Sq, int Sk, int H,
                             int KV, int D, int causal, int dtype, int split,
                             void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, scratch, B, Sq, Sk, H,
               KV, causal, split, static_cast<cudaStream_t>(stream)};
  return dispatch<DKV>(a, D, dtype);
}
