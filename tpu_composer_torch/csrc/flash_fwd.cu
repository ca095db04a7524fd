// K1: FlashAttention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels tpu_composer/ops/attention.py::_fwd_kernel
// (with the lse write) and ::_fwd_kernel_nolse (without it). Same
// function: S = (Q·Kᵀ) in fp32 from input-dtype operands, times 1/√D on
// the logits (q is never pre-scaled); causal keeps row >= col in absolute
// positions, fills -1e30 and skips K tiles wholly above the diagonal; an
// online softmax with fp32 m, l and acc; P is cast to the V dtype before
// P·V; out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)) is written
// only when its pointer is non-null, as a plain (B·H, Sq) fp32 array.
//
// What bounds it on this card: at the serving path's shapes (one prompt
// of <= 512 tokens, 8 query heads of 64) the work is a few hundred MFLOP
// over well under a megabyte, so a launch is latency-bound, not bound by
// bytes or tensor-core FLOPs. This first version is therefore simple:
// CUDA-core fp32 FMAs from shared memory, no tensor cores, no TMA.
//
// Design: one CTA per (b·H + h, tile of BQ query rows). The GQA fan-in is
// computed here (kv head = h / (H / KV)), so K/V are never repeated in
// memory. A loop over K/V tiles staged in shared memory replaces the
// TPU's sequential grid axis. Each query row belongs to TPR neighbouring
// threads of one warp: for Q·Kᵀ each takes every TPR-th key of the tile,
// the row max and sum are combined with warp shuffles, and for P·V each
// owns every TPR-th output column in registers. Shared rows are padded
// by one float so the row-strided reads fall in distinct banks. Ragged
// tile edges (Sq or Sk not a multiple of the tile) are masked here.
// Inputs are read in the (B, S, heads, D) layout the model produces, so
// the caller transposes nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;              // query rows per CTA
constexpr int BK = 64;              // keys per K/V tile
constexpr int TPR = 8;              // threads per query row
constexpr int NTHREADS = BQ * TPR;  // 256
constexpr int KPT = BK / TPR;       // keys per thread in Q·Kᵀ
constexpr int QCHUNK = 16;          // q values held in registers at once
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int causal) {
  static_assert(D % TPR == 0 && D % QCHUNK == 0, "head_dim tiling");
  constexpr int DPT = D / TPR;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // BQ x (D + 1)
  float* k_s = q_s + BQ * (D + 1);    // BK x (D + 1)
  float* v_s = k_s + BK * (D + 1);    // BK x D
  float* p_s = v_s + BK * D;          // BQ x (BK + 1), P in V's dtype

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
  const T* qb = q + ((long)b * Sq * H + h) * D;
  const T* kb = k + ((long)b * Sk * KV + kvh) * D;
  const T* vb = v + ((long)b * Sk * KV + kvh) * D;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int s = q0 + r;
    q_s[r * (D + 1) + c] = s < Sq ? to_f(qb[s * q_stride + c]) : 0.f;
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
      k_s[r * (D + 1) + c] = in ? to_f(kb[s * kv_stride + c]) : 0.f;
      v_s[r * D + c] = in ? to_f(vb[s * kv_stride + c]) : 0.f;
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
      p_s[row * (BK + 1) + lane + TPR * j] = to_f(from_f<T>(p));
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
    T* orow = o + (((long)b * Sq + qi) * H + h) * D + lane;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[TPR * i] = from_f<T>(acc[i] / lc);
    if (lse != nullptr && lane == 0) lse[(long)bh * Sq + qi] = m + logf(lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int H, int KV, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Sk, H, KV, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Layouts: q/o (B, Sq, H, D), k/v (B, Sk, KV, D),
// lse (B, H, Sq) fp32 or null. Returns a cudaError_t code (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Sq, int Sk, int H, int KV,
                         int D, int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                     causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                      causal, s);
  return (int)cudaErrorInvalidValue;
}
