// K2: paged decode attention for Hopper (sm_90a), fp and int8 pools,
// plain C interface. Two kernels a call: a split pass and a merge pass
// (flash-decoding).
//
// Replaces the Pallas kernels tpu_composer/ops/paged_attention.py::_kernel
// (fp pools) and ::_kernel_quant (int8 pools + fp32 scales). Same
// function: one query token per row attends its cache through the block
// table; positions >= lengths[b] are masked, with the m_safe / alpha
// guards of the online softmax; out = acc / max(l, 1e-30), so a row of
// length 0 gives zeros. q, k and v are upcast to fp32 and p stays fp32.
// int8: the k scale multiplies the score after the 1/√Dh factor, the v
// scale folds into p before P·V, and l sums the unscaled p.
//
// What bounds it on this card: bytes, and at the engine's decode shape
// (8 rows, 2 KV heads, up to 512 positions, ≈1 MB of live K/V) the
// latency of a few dependent memory round trips. A decode step reads
// every live K/V position once per KV head and does 4 operations per
// element pair, far below the ~295 operations a byte where the tensor
// cores would become the limit, so it stays on CUDA cores. The design
// fills the card and keeps each CTA's chain of memory waits short:
// - Split pass: one CTA of 4 warps per (b·KV + kvh, z), z = 0 …
//   n_split−1, attending cache positions [z·C, (z+1)·C) ∩ [0, n_pos) for
//   the head's G = H/KV query rows (the GQA saving: each K/V position is
//   read once for all G rows). C (the whole blocks that fit in 64
//   positions, 64 for larger blocks) and n_split = ceil(MB·Bs / C) come
//   from shapes only (ops/paged_attention.py::_decode_split): never from
//   lengths, so the wrapper makes no host read, and never from B, so a
//   row's sums do not depend on the batch. At the engine shape that is
//   8 · 2 · 8 = 128 CTAs for 132 SMs.
// - A CTA whose chunk starts at or past n_pos = min(lengths[b], MB·Bs)
//   reads no table entry: it writes m = −inf, l = 0 and returns. Idle
//   engine rows carry stale tables, so a slot past a row's live blocks
//   is never dereferenced. A live CTA reads each of its block ids once,
//   then copies its K and V rows into shared memory with 16-byte
//   cp.async (a bf16 row of Dh 64 is 8 copies, an int8 row 4), rows
//   padded by 16 bytes so a warp's row-strided reads hit distinct banks.
// - Warps take the G query rows, lanes the positions: a row's max and
//   sum combine with warp shuffles, p goes to shared memory, and the
//   CTA's threads then own (row, column pair) outputs of P·V. Three
//   barriers a CTA. The partials (m, l, acc[G, Dh]) are fp32, written
//   to scratch the wrapper allocates.
// - Merge pass: one thread per (b·H + h, column pair) combines the
//   n_split partials in the fixed order z = 0 … n_split−1 under the
//   m_safe / alpha guards, skipping empty chunks, and writes
//   acc / max(l, 1e-30) in q's dtype. No atomics: two launches give the
//   same bits.
//
// Every table entry read lies in [0, N): tables start at 0 and hold only
// ids popped from the pool. This kernel does not clamp ids.

#include <math.h>

#include "tensor_core.cuh"

namespace {

using tc::bf16;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
constexpr int NT = 128;  // threads per CTA, both kernels
constexpr int WARPS = NT / 32;
constexpr int MAX_CHUNK = 256;  // cache positions per split CTA, at most
constexpr size_t SMEM_MAX = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Σ k[i]·q[i] over the 16 bytes of K at k, added to acc; q is 16-byte
// aligned fp32 in shared memory.
__device__ __forceinline__ float dot16(const float* k, const float* q,
                                      float acc) {
  const float4 a = *reinterpret_cast<const float4*>(k);
  const float4 b = *reinterpret_cast<const float4*>(q);
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float dot16(const bf16* k, const float* q,
                                      float acc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(q + 4 * i);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[2 * i]));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[2 * i + 1]));
    acc = fmaf(lo.x, b.x, acc);
    acc = fmaf(lo.y, b.y, acc);
    acc = fmaf(hi.x, b.z, acc);
    acc = fmaf(hi.y, b.w, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot16(const int8_t* k, const float* q,
                                      float acc) {
  const int4 raw = *reinterpret_cast<const int4*>(k);
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(q + 4 * i);
    const char4 c = *reinterpret_cast<const char4*>(&w[i]);
    acc = fmaf((float)c.x, b.x, acc);
    acc = fmaf((float)c.y, b.y, acc);
    acc = fmaf((float)c.z, b.z, acc);
    acc = fmaf((float)c.w, b.w, acc);
  }
  return acc;
}

// Two neighbouring values as fp32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory of a split CTA: K and V rows of the chunk (row stride
// Dh·sizeof(T) + 16 bytes), then q (G x Dh fp32), p (G x chunk fp32),
// the k and v scales (chunk fp32 each) and the ids of the blocks the
// chunk touches (at most chunk / Bs + 2).
template <typename T, int DH>
size_t split_smem_bytes(int G, int chunk, int Bs) {
  return 2 * (size_t)chunk * (DH * sizeof(T) + 16) +
         sizeof(float) * ((size_t)G * DH + (size_t)G * chunk + 2 * chunk) +
         sizeof(int) * (size_t)(chunk / Bs + 2);
}

// Scratch layout, rows r = b·H + h: acc at part[(r·n_split + z)·DH],
// then (m, l) at part[rows·n_split·DH + (r·n_split + z)·2].
template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(NT)
paged_decode_split_kernel(const TQ* __restrict__ q,
                          const TKV* __restrict__ k_pool,
                          const TKV* __restrict__ v_pool,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ lengths,
                          float* __restrict__ part, int H, int KV, int Bs,
                          int MB, int chunk) {
  constexpr int VEC = 16 / sizeof(TKV);  // values per 16-byte copy
  constexpr int CH = DH / VEC;           // copies per row
  constexpr int LD = DH + VEC;           // shared row stride, elements
  const int G = H / KV;
  const int n_split = gridDim.y;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* k_s = reinterpret_cast<TKV*>(smem_raw);  // chunk x LD
  TKV* v_s = k_s + chunk * LD;                   // chunk x LD
  float* q_s = reinterpret_cast<float*>(v_s + chunk * LD);  // G x DH
  float* p_s = q_s + G * DH;                                // G x chunk
  float* ks_s = p_s + G * chunk;
  float* vs_s = ks_s + chunk;
  int* blk_s = reinterpret_cast<int*>(vs_s + chunk);

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, z = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool quant = k_scale != nullptr;
  // Positions past the table do not exist (the JAX kernel walks MB·Bs).
  const int n_pos = min(max(lengths[b], 0), MB * Bs);
  const int p0 = z * chunk;
  const long row0 = (long)b * H + (long)kvh * G;  // the head's first q row
  const long rows = (long)gridDim.x * G;          // B·H
  float* acc_out = part + (row0 * n_split + z) * DH;
  float* ml_out = part + rows * n_split * DH + (row0 * n_split + z) * 2;

  if (p0 >= n_pos) {  // an empty chunk: weight 0 in the merge
    for (int g = tid; g < G; g += NT) {
      ml_out[(long)g * n_split * 2] = -INFINITY;
      ml_out[(long)g * n_split * 2 + 1] = 0.f;
    }
    return;
  }
  // Position p0 + t lies at offset (o0 + t) % Bs of the chunk's block
  // (o0 + t) / Bs, counted from the table slot of p0.
  const int n = min(chunk, n_pos - p0);
  const int o0 = p0 % Bs;
  const int* tb = tables + (long)b * MB + p0 / Bs;
  for (int j = tid; j * Bs < o0 + n; j += NT) blk_s[j] = tb[j];
  const TQ* qb = q + row0 * DH;
  for (int i = tid; i < G * DH; i += NT) q_s[i] = to_f(qb[i]);
  __syncthreads();

  for (int i = tid; i < n * CH; i += NT) {
    const int t = i / CH, c = (i % CH) * VEC, o = o0 + t;
    const long row = ((long)blk_s[o / Bs] * Bs + o % Bs) * KV + kvh;
    cp_async16(k_s + t * LD + c, k_pool + row * DH + c, true);
    cp_async16(v_s + t * LD + c, v_pool + row * DH + c, true);
  }
  cp_async_commit();
  if (quant) {
    for (int t = tid; t < n; t += NT) {
      const int o = o0 + t;
      const long row = ((long)blk_s[o / Bs] * Bs + o % Bs) * KV + kvh;
      ks_s[t] = k_scale[row];
      vs_s[t] = v_scale[row];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Scores, max and sum: warp w takes query rows g ≡ w (mod 4), its lanes
  // the positions t ≡ lane (mod 32).
  const float scale = 1.0f / sqrtf((float)DH);
  for (int g = warp; g < G; g += WARPS) {
    const float* qg = q_s + g * DH;
    float* pg = p_s + g * chunk;
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) {
      const TKV* kr = k_s + t * LD;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += VEC) dot = dot16(kr + c, qg + c, dot);
      float s = dot * scale;
      if (quant) s *= ks_s[t];  // after the 1/sqrt(Dh) factor
      pg[t] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_safe = isfinite(mx) ? mx : 0.f;
    float ps = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(pg[t] - m_safe);
      ps += p;
      pg[t] = quant ? p * vs_s[t] : p;  // l sums the unscaled p
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    if (lane == 0) {
      ml_out[(long)g * n_split * 2] = mx;
      ml_out[(long)g * n_split * 2 + 1] = ps;
    }
  }
  __syncthreads();

  // acc[g][d, d+1] = Σ_t p[g][t] · v[t][d, d+1].
  for (int i = tid; i < G * DH / 2; i += NT) {
    const int g = i / (DH / 2), d = (i % (DH / 2)) * 2;
    const float* pg = p_s + g * chunk;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float2 v = load2(v_s + t * LD + d);
      a0 = fmaf(pg[t], v.x, a0);
      a1 = fmaf(pg[t], v.y, a1);
    }
    store2(acc_out + (long)g * n_split * DH + d, a0, a1);
  }
}

// out[r][d, d+1] from the n_split partials of row r, in the order
// z = 0 … n_split−1: the same bits on every run.
template <typename TQ, int DH>
__global__ void __launch_bounds__(NT)
paged_decode_merge_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                          int rows, int n_split) {
  const long i = (long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long)rows * (DH / 2)) return;
  const long r = i / (DH / 2);
  const int d = (int)(i % (DH / 2)) * 2;
  const float* acc = part + r * n_split * DH + d;
  const float* ml = part + (long)rows * n_split * DH + r * n_split * 2;
  float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float mz = ml[2 * z];
    if (mz == -INFINITY) continue;  // an empty chunk; its acc is unwritten
    const float m_new = fmaxf(m, mz);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float alpha = isfinite(m) ? expf(m - m_safe) : 0.f;
    const float beta = expf(mz - m_safe);
    const float2 az = *reinterpret_cast<const float2*>(acc + (long)z * DH);
    l = alpha * l + beta * ml[2 * z + 1];
    a0 = alpha * a0 + beta * az.x;
    a1 = alpha * a1 + beta * az.y;
    m = m_new;
  }
  const float lc = fmaxf(l, 1e-30f);
  store2(out + r * DH + d, a0 / lc, a1 / lc);
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *lengths;
  void *out, *scratch;
  int B, H, KV, Bs, MB, chunk, n_split;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int DH>
int launch(const Args& a) {
  const size_t smem = split_smem_bytes<TKV, DH>(a.H / a.KV, a.chunk, a.Bs);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> attr_set{0};
  cudaError_t err = smem_limit_once(
      attr_set, paged_decode_split_kernel<TQ, TKV, DH>, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.KV, a.n_split);
  paged_decode_split_kernel<TQ, TKV, DH><<<grid, NT, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.scratch),
      a.H, a.KV, a.Bs, a.MB, a.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n = (long)a.B * a.H * (DH / 2);
  paged_decode_merge_kernel<TQ, DH><<<(unsigned)((n + NT - 1) / NT), NT, 0,
                                      a.stream>>>(
      static_cast<const float*>(a.scratch), static_cast<TQ*>(a.out),
      a.B * a.H, a.n_split);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int by_dh(int Dh, const Args& a) {
  if (Dh == 64) return launch<TQ, TKV, 64>(a);
  if (Dh == 128) return launch<TQ, TKV, 128>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ>
int by_kv(int kv_dtype, int Dh, const Args& a) {
  const bool scaled = a.k_scale != nullptr && a.v_scale != nullptr;
  const bool unscaled = a.k_scale == nullptr && a.v_scale == nullptr;
  if (kv_dtype == 0 && unscaled) return by_dh<TQ, float>(Dh, a);
  if (kv_dtype == 1 && unscaled) return by_dh<TQ, bf16>(Dh, a);
  if (kv_dtype == 2 && scaled) return by_dh<TQ, int8_t>(Dh, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out (B, H, Dh); pools (N, Bs, KV, Dh), 16-byte aligned; scales
// (N, Bs, KV) fp32 (int8 pools only, else null); tables (B, MB) int32;
// lengths (B,) int32. chunk: cache positions per split CTA, 1 to 256;
// n_split = ceil(MB·Bs / chunk). scratch: fp32,
// B·H·n_split·(Dh + 2) floats. q_dtype: 0 fp32, 1 bf16. kv_dtype: 0 fp32,
// 1 bf16, 2 int8. Returns a cudaError_t code (0 = both kernels launched).
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* lengths, void* out, void* scratch,
                            int B, int H, int KV, int Dh, int Bs, int MB,
                            int chunk, int n_split, int q_dtype,
                            int kv_dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || Bs <= 0 || MB <= 0 ||
      chunk < 1 || chunk > MAX_CHUNK ||
      n_split != (MB * Bs + chunk - 1) / chunk || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out,
               scratch, B, H, KV, Bs, MB, chunk, n_split,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return by_kv<float>(kv_dtype, Dh, a);
  if (q_dtype == 1) return by_kv<bf16>(kv_dtype, Dh, a);
  return (int)cudaErrorInvalidValue;
}
