// K2: paged decode attention for Hopper (sm_90a), fp and int8 pools,
// plain C interface.
//
// Replaces the Pallas kernels tpu_composer/ops/paged_attention.py::_kernel
// (fp pools) and ::_kernel_quant (int8 pools + fp32 scales). Same
// function: one query token per row attends its cache through the block
// table; positions >= lengths[b] are -inf with the m_safe / alpha guards
// of the online softmax; out = acc / max(l, 1e-30), so a row of length 0
// gives zeros. q, k and v are upcast to fp32 and p stays fp32. int8:
// the k scale multiplies the score after the 1/√Dh factor, the v scale
// folds into p before P·V, and l sums the unscaled p.
//
// What bounds it on this card: bytes. A decode step reads every live K/V
// position of every row once and does 4 flops per byte-pair of it, far
// below the ~295 flops/byte where the tensor cores would become the
// limit. The design therefore reads each K/V position once per KV head:
// one CTA per (row b, KV head) holds that head's G = H/KV query rows and
// scores all of them against each K/V position it loads (the GQA saving),
// and it walks only the table slots j < ceil(len / Bs), so blocks past a
// row's length are never read (they would contribute exactly 0). The
// CTA reads its own block_tables[b, j]; there is no gathered copy of the
// cache. This first version stages 64 positions at a time in shared
// memory and uses CUDA-core fp32 FMAs; splitting a long row across CTAs
// is later work.
//
// Idle engine rows still get lengths = pos + 1 and stale tables. Every
// table entry read lies in [0, N) because tables start at 0 and hold only
// ids popped from the pool; this kernel does not clamp ids.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;    // cache positions staged per iteration
constexpr int NT = 128;   // threads per CTA
constexpr int WARPS = NT / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_floats(int G, int DH) {
  return (size_t)G * DH        // q
         + (size_t)TP * (DH + 1)  // k tile
         + (size_t)TP * DH        // v tile
         + (size_t)G * TP         // scores / p
         + (size_t)G * DH         // acc
         + 2 * TP                 // k, v scales
         + 3 * (size_t)G;         // m, l, alpha
}

template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    int H, int KV, int Bs, int MB) {
  const int G = H / KV;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * DH;
  float* v_s = k_s + TP * (DH + 1);
  float* s_s = v_s + TP * DH;
  float* acc_s = s_s + G * TP;
  float* ks_s = acc_s + G * DH;
  float* vs_s = ks_s + TP;
  float* m_s = vs_s + TP;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const bool quant = k_scale != nullptr;
  const float scale = 1.0f / sqrtf((float)DH);
  // Positions past the table do not exist (the JAX kernel walks MB*Bs).
  const int n_pos = min(max(lengths[b], 0), MB * Bs);
  const int* tb = tables + (long)b * MB;

  const TQ* qb = q + ((long)b * H + (long)kvh * G) * DH;
  for (int i = tid; i < G * DH; i += NT) {
    q_s[i] = to_f(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  for (int p0 = 0; p0 < n_pos; p0 += TP) {
    __syncthreads();  // previous tile consumed (and q/acc/m/l initialised)
    for (int i = tid; i < TP * DH; i += NT) {
      const int t = i / DH, d = i % DH;
      const int p = p0 + t;
      float kv = 0.f, vv = 0.f;
      if (p < n_pos) {
        const long row = ((long)tb[p / Bs] * Bs + p % Bs) * KV + kvh;
        kv = to_f(k_pool[row * DH + d]);
        vv = to_f(v_pool[row * DH + d]);
      }
      k_s[t * (DH + 1) + d] = kv;
      v_s[t * DH + d] = vv;
    }
    if (quant) {
      for (int t = tid; t < TP; t += NT) {
        const int p = p0 + t;
        float ks = 0.f, vs = 0.f;
        if (p < n_pos) {
          const long row = ((long)tb[p / Bs] * Bs + p % Bs) * KV + kvh;
          ks = k_scale[row];
          vs = v_scale[row];
        }
        ks_s[t] = ks;
        vs_s[t] = vs;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * TP; i += NT) {
      const int g = i / TP, t = i % TP;
      float s = -INFINITY;
      if (p0 + t < n_pos) {
        const float* qr = q_s + g * DH;
        const float* kr = k_s + t * (DH + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (quant) s *= ks_s[t];  // after the 1/sqrt(Dh) factor
      }
      s_s[i] = s;
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += WARPS) {
      float* sr = s_s + g * TP;
      float mx = -INFINITY;
      for (int t = lane; t < TP; t += 32) mx = fmaxf(mx, sr[t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
      float ps = 0.f;
      for (int t = lane; t < TP; t += 32) {
        const float p = expf(sr[t] - m_safe);  // masked -> 0
        ps += p;
        sr[t] = quant ? p * vs_s[t] : p;  // l sums the unscaled p
      }
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) {
        l_s[g] = alpha * l_s[g] + ps;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    const int tmax = min(TP, n_pos - p0);
    for (int i = tid; i < G * DH; i += NT) {
      const int g = i / DH, d = i % DH;
      const float* pr = s_s + g * TP;
      float pv = 0.f;
      for (int t = 0; t < tmax; ++t) pv = fmaf(pr[t], v_s[t * DH + d], pv);
      acc_s[i] = acc_s[i] * a_s[g] + pv;
    }
  }
  __syncthreads();

  TQ* ob = out + ((long)b * H + (long)kvh * G) * DH;
  for (int i = tid; i < G * DH; i += NT)
    ob[i] = from_f<TQ>(acc_s[i] / fmaxf(l_s[i / DH], 1e-30f));
}

template <typename TQ, typename TKV, int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* lengths, void* out, int B, int H, int KV, int Bs,
           int MB, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(H / KV, DH);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<TQ, TKV, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KV);
  paged_decode_kernel<TQ, TKV, DH><<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), H, KV, Bs,
      MB);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int by_dh(int Dh, const void* q, const void* kp, const void* vp,
          const void* ks, const void* vs, const void* tables,
          const void* lengths, void* out, int B, int H, int KV, int Bs,
          int MB, cudaStream_t s) {
  if (Dh == 64)
    return launch<TQ, TKV, 64>(q, kp, vp, ks, vs, tables, lengths, out, B, H,
                               KV, Bs, MB, s);
  if (Dh == 128)
    return launch<TQ, TKV, 128>(q, kp, vp, ks, vs, tables, lengths, out, B,
                                H, KV, Bs, MB, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ>
int by_kv(int kv_dtype, int Dh, const void* q, const void* kp,
          const void* vp, const void* ks, const void* vs, const void* tables,
          const void* lengths, void* out, int B, int H, int KV, int Bs,
          int MB, cudaStream_t s) {
  if (kv_dtype == 0)
    return by_dh<TQ, float>(Dh, q, kp, vp, nullptr, nullptr, tables, lengths,
                            out, B, H, KV, Bs, MB, s);
  if (kv_dtype == 1)
    return by_dh<TQ, __nv_bfloat16>(Dh, q, kp, vp, nullptr, nullptr, tables,
                                    lengths, out, B, H, KV, Bs, MB, s);
  if (kv_dtype == 2 && ks != nullptr && vs != nullptr)
    return by_dh<TQ, int8_t>(Dh, q, kp, vp, ks, vs, tables, lengths, out, B,
                             H, KV, Bs, MB, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out (B, H, Dh); pools (N, Bs, KV, Dh); scales (N, Bs, KV) fp32 (int8
// pools only, else null); tables (B, MB) int32; lengths (B,) int32.
// q_dtype: 0 fp32, 1 bf16. kv_dtype: 0 fp32, 1 bf16, 2 int8.
// Returns a cudaError_t code (0 = launched).
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* lengths, void* out, int B, int H,
                            int KV, int Dh, int Bs, int MB, int q_dtype,
                            int kv_dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || Bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return by_kv<float>(kv_dtype, Dh, q, k_pool, v_pool, k_scale, v_scale,
                        tables, lengths, out, B, H, KV, Bs, MB, s);
  if (q_dtype == 1)
    return by_kv<__nv_bfloat16>(kv_dtype, Dh, q, k_pool, v_pool, k_scale,
                                v_scale, tables, lengths, out, B, H, KV, Bs,
                                MB, s);
  return (int)cudaErrorInvalidValue;
}
