// B3 (dQ) and B4 (dK/dV): FlashAttention backward for Hopper (sm_90a),
// plain C interface, two entry points.
//
// Replaces the Pallas kernels tpu_composer/ops/attention.py::_dq_kernel
// (B3, flash_bwd_dq) and ::_dkv_kernel (B4, flash_bwd_dkv). Same function:
// P = exp(S·scale − lse) rebuilt in fp32 from the forward's lse, with
// S = Q·Kᵀ from input-dtype operands and the causal fill −1e30 (so masked
// pairs give exactly 0); dP = dO·Vᵀ; dS = P∘(dP − δ), rounded to the input
// dtype before dS·K and dSᵀ·Q; P rounded to dO's dtype before Pᵀ·dO;
// dQ and dK × 1/√D at the end, dV unscaled. δ = rowsum(dO∘O) (minus the
// lse cotangent when lse is differentiated) is computed by the caller in
// PyTorch, as the JAX package computes it in XLA outside Pallas.
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
// ≈12.9 MB, ≈4.4 µs at 989 TFLOP/s, so operations. This first version
// runs on CUDA cores (fp32 FMAs from shared memory, no tensor cores, no
// TMA), so it sits far above both bounds: it is right first, fast later.
//
// Design. Both kernels share one tile body: a CTA owns ROWS rows (A and
// B operands staged once) and streams tiles of COLS rows (X and Y) through
// shared memory in a loop that replaces the TPU's sequential grid axis.
// Each owned row belongs to TPR neighbouring threads of one warp; for the
// two score products each thread takes every TPR-th streamed row, and for
// the accumulation each owns every TPR-th output column in fp32 registers.
// No row reduction is needed (lse and δ are given), so no shuffles.
// - B3: one CTA per (b·H + h, tile of ROWS query rows); loops over the
//   K/V tiles up to the diagonal (causal skip as attention.py:295).
// - B4: one CTA per (b·KV + kvh, tile of ROWS key rows): one owner per
//   output block, no atomics, deterministic run to run. It loops over the
//   G = H/KV query heads of its group and, for each, over the q tiles from
//   the diagonal on (attention.py:346), the JAX grid (bkv, nk, group·nq).
//   At the training shape that is 16 × 8 = 128 CTAs for 132 SMs.
// GQA fan-in (kv head = h / (H/KV)) is computed here, and inputs are read
// in the model's (B, S, heads, D) layout. Ragged tile edges are masked:
// rows past the sequence load as 0, their P is forced to 0 and their
// outputs are not written. Shared rows are padded by one float so
// row-strided reads fall in distinct banks.
//
// Shared memory per CTA (fp32 staging): B3 (4·64·(D+1) + 64·65)·4 bytes,
// 83,200 at D=64 and 148,736 at D=128; B4 adds a second 64×65 tile and
// two 64-float columns: 100,352 and 165,888 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                     int causal) {
  static_assert(D % TPR == 0 && D % CHUNK == 0, "head_dim tiling");
  constexpr int DPT = D / TPR;
  extern __shared__ float smem[];
  float* k_s = smem;                   // ROWS x (D + 1), owned
  float* v_s = k_s + ROWS * (D + 1);   // ROWS x (D + 1), owned
  float* q_s = v_s + ROWS * (D + 1);   // COLS x (D + 1), streamed
  float* do_s = q_s + COLS * (D + 1);  // COLS x (D + 1), streamed
  float* ds_s = do_s + COLS * (D + 1);  // ROWS x (COLS + 1), dSᵀ in T
  float* p_s = ds_s + ROWS * (COLS + 1);  // ROWS x (COLS + 1), Pᵀ in T
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
  load_rows<T, D>(k_s, k + kv_off, kv_stride, k0, ROWS, Sk);
  load_rows<T, D>(v_s, v + kv_off, kv_stride, k0, ROWS, Sk);

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
      load_rows<T, D>(q_s, q + q_off, q_stride, q0, COLS, Sq);
      load_rows<T, D>(do_s, dout + q_off, q_stride, q0, COLS, Sq);
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
        p_s[row * (COLS + 1) + c] = round_to<T>(p);
        ds_s[row * (COLS + 1) + c] = round_to<T>(p * (dp[j] - dl_s[c]));
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
      dk[o + TPR * i] = from_f<T>(acc_k[i] * scale);
      dv[o + TPR * i] = from_f<T>(acc_v[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int B, Sq, Sk, H, KV, causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + ROWS - 1) / ROWS, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.Sq, a.Sk, a.H, a.KV, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + ROWS - 1) / ROWS, a.B * a.KV);
  flash_bwd_dkv_kernel<T, D><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.Sq, a.Sk, a.H,
      a.KV, a.causal);
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

template <typename T, int D>
struct DKV {
  static int run(const Args& a) { return launch_dkv<T, D>(a); }
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
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, Sq, Sk, H, KV,
               causal, static_cast<cudaStream_t>(stream)};
  return dispatch<DQ>(a, D, dtype);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int Sq, int Sk, int H, int KV, int D, int causal,
                             int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, KV,
               causal, static_cast<cudaStream_t>(stream)};
  return dispatch<DKV>(a, D, dtype);
}
