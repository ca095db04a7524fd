// The dropless MoE layer's grouped expert path for Hopper (sm_90a), bf16,
// plain C interface: four entry points, called in order by
// models/moe.py::_grouped_ffn through ops/moe_grouped.py.
//
//   moe_group    (T, k) expert ids -> each expert's row offset, each sorted
//                row's token, each (token, choice)'s sorted row
//   moe_gate_up  h[row] = bf16(silu(bf16(x[tok]·w_gate[e])) ·
//                bf16(x[tok]·w_up[e])), over each expert's own rows
//   moe_down     y[row] = bf16(h[row]·w_down[e])
//   moe_combine  out[t] = bf16(Σ_j bf16(gate_tj)·y[row(t, j)] (+ shared[t]))
//
// Replaces no TPU kernel: the JAX package dispatches by one-hot (B, S, E, C)
// einsums, which XLA fuses. The port laid the expert inputs out as
// (E, B, C) and ran every expert over every row of a routing group: at
// top-6 of 64 experts a 128-row decode step computed 8,192 rows a layer
// for 768 routed ones, and the gathers, `where`s, queue slots and combine
// around the three `bmm`s were about 140 small launches a layer. Here the
// products run over the routed rows alone, and no (E, B, C) tensor exists.
//
// What bounds it on this card. At decode (128 tokens) an expert holds a few
// to a few dozen rows, so each weight byte feeds 2·rows operations: far
// below the ~295 operations a byte where the tensor cores would become the
// limit. The bound is the bytes of the expert weights, which the products
// must stream once each (Moonlight: 1.1 GB a layer; Mixtral: 2.8 GB). A
// 2,048-token admission puts ~200 rows on each expert and approaches the
// operations bound instead. The design:
// - moe_group: one CTA of 1,024 threads. A shared-memory histogram (integer
//   atomics) gives each expert's count and offset; then tiles of 1,024
//   (token, choice) pairs in order, each pair ranked among the earlier
//   pairs of its expert by __match_any_sync within its warp and a scan over
//   the warps: the order within an expert is the (token, choice) order, so
//   a run gives the same rows every time. Its grid and outputs are sized
//   from T·k and E alone (a CUDA graph captures it).
// - moe_gate_up / moe_down: one CTA of 8 warps per (column tile, expert),
//   the same kernel with two weight matrices (gate and up, 64 columns of
//   each) or one (down, 128 columns). An expert with no rows exits at once.
//   The CTA walks its expert's rows in tiles of 128 (one tile at decode,
//   whatever the skew, since an expert holds at most T rows), and streams
//   its weight columns through a 3-stage ring of 16-byte cp.async copies
//   of 64-deep K slices (the weights bypass L1; x's rows, which every CTA
//   of the expert reads, come from L2). The gate/up CTA gathers its rows
//   straight from x by the sorted token index: no expert input is written.
//   Rows past the expert's count are not loaded, and only the 16-row
//   tiles that hold a row are computed. Products by mma.sync m16n8k16
//   (bf16 in, fp32 accumulate), fragments by ldmatrix (the weights by
//   ldmatrix.trans: they are stored K-major, N contiguous); warps split
//   the tile 2 (64 rows each) × 4 (columns). 105 KB of shared memory and
//   at most 128 registers a thread, so two CTAs share an SM and one's
//   ring refills while the other starts or drains.
// - The gate/up epilogue rounds gate and up to bf16, then computes
//   bf16(silu(float(gate)) · float(up)) as csrc/swiglu.cu does (expf, IEEE
//   division, one round to nearest even); the down epilogue rounds once.
//   So the arithmetic is the (E, B, C) path's, but for the order of the
//   sums inside the products.
// - moe_combine: a thread per (token, 8 columns); the gates rounded to bf16,
//   the products and sums in fp32 in choice order (__fmul_rn/__fadd_rn, no
//   contraction), the shared experts' output added last, one rounding: the
//   (E, B, C) path's combine bit for bit, given the same y.
// No float atomics anywhere: the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tensor_core.cuh"

namespace {

using tc::bf16;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma;
using tc::PAD;

constexpr int MAX_EXPERTS = 256;
constexpr int GT = 1024;  // moe_group's threads
constexpr int GW = GT / 32;

// Ids come from a top-k over E, so they lie in [0, E); the clamp only keeps
// a shared-memory index in bounds.
__device__ __forceinline__ int expert_of(long long id, int E) {
  return id < 0 ? 0 : (id >= E ? E - 1 : (int)id);
}

__global__ void __launch_bounds__(GT)
moe_group_kernel(const long long* __restrict__ ids, int n, int k, int E,
                 int* __restrict__ offsets, int* __restrict__ tok,
                 int* __restrict__ row) {
  __shared__ int counts[MAX_EXPERTS];
  __shared__ int base[MAX_EXPERTS];
  __shared__ int wc[GW][MAX_EXPERTS];  // per warp and expert: count, then start
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < E; e += GT) counts[e] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += GT) atomicAdd(&counts[expert_of(ids[i], E)], 1);
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int e = 0; e < E; ++e) {
      base[e] = s;
      offsets[e] = s;
      s += counts[e];
    }
    offsets[E] = s;
  }
  const unsigned below = (1u << lane) - 1u;
  for (int t0 = 0; t0 < n; t0 += GT) {
    for (int j = tid; j < GW * E; j += GT) wc[j / E][j % E] = 0;
    __syncthreads();
    const int i = t0 + tid;
    const bool valid = i < n;
    const int e = valid ? expert_of(ids[i], E) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(same & below);
    if (valid && rank == 0) wc[warp][e] = __popc(same);
    __syncthreads();
    if (tid < E) {
      int s = base[tid];
      for (int w = 0; w < GW; ++w) {
        const int c = wc[w][tid];
        wc[w][tid] = s;
        s += c;
      }
      base[tid] = s;
    }
    __syncthreads();
    if (valid) {
      const int pos = wc[warp][e] + rank;
      row[i] = pos;
      tok[pos] = i / k;
    }
    __syncthreads();
  }
}

constexpr int NT = 256;  // 8 warps: 2 along the rows, 4 along the columns
constexpr int BM = 128;  // rows a tile
constexpr int BK = 64;   // K a stage
constexpr int BW = 128;  // weight columns a stage (64 gate + 64 up, or 128)
constexpr int STAGES = 3;
constexpr int LDX = BK + PAD;
constexpr int LDW = BW + PAD;
constexpr int STAGE = BM * LDX + BK * LDW;  // bf16 elements
constexpr size_t SMEM = sizeof(bf16) * STAGE * STAGES;

// A (·, K) bf16 rows: the expert's rows are a_rows[start + r] (gate/up: x
// gathered by token) or start + r (down: h in sorted order). W0 (and W1)
// (E, K, N); out (·, N) in sorted order. DUAL: W0 = gate, W1 = up, 64
// columns of each a CTA and the SwiGLU epilogue; else 128 columns of W0.
template <bool DUAL>
__global__ void __launch_bounds__(NT, 2)
moe_grouped_kernel(const bf16* __restrict__ A, const int* __restrict__ a_rows,
                   const bf16* __restrict__ W0, const bf16* __restrict__ W1,
                   const int* __restrict__ offsets, bf16* __restrict__ out,
                   int K, int N) {
  const int e = blockIdx.y;
  const int start = offsets[e];
  const int n_rows = offsets[e + 1] - start;
  if (n_rows <= 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * (DUAL ? BW / 2 : BW);
  const int n_valid = DUAL ? BW : min(BW, N - n0);  // smem columns in use
  const size_t w_off = (size_t)e * K * N + n0;
  const bf16* w0 = W0 + w_off;
  const bf16* w1 = DUAL ? W1 + w_off : nullptr;
  const int KT = K / BK;

  // This thread's 16-byte copies of a stage: x rows (tid >> 3) + 32i at
  // column (tid & 7)·8; weight rows and columns as below.
  const int xr = tid >> 3, xc = (tid & 7) * 8;

  for (int r0 = 0; r0 < n_rows; r0 += BM) {
    const int rows = min(BM, n_rows - r0);
    const int live = (rows + 15) & ~15;  // rows in computed 16-row tiles
    const bf16* xsrc[4];
    int xmode[4];  // 2: copy, 1: zero-fill, 0: not loaded
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = xr + 32 * i;
      xmode[i] = r < rows ? 2 : (r < live ? 1 : 0);
      const long long src_row =
          r < rows ? (a_rows ? (long long)a_rows[start + r0 + r]
                             : (long long)(start + r0 + r))
                   : 0;
      xsrc[i] = A + src_row * K + xc;
    }

    auto load_stage = [&](int stage, int kt) {
      bf16* xs = smem + stage * STAGE;
      bf16* ws = xs + BM * LDX;
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (xmode[i])
          cp_async16(xs + (xr + 32 * i) * LDX + xc, xsrc[i] + k0,
                     xmode[i] == 2);
      if (DUAL) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = (tid >> 3) + 32 * (i & 1), c = (tid & 7) * 8;
          const bf16* src = (i < 2 ? w0 : w1) + (size_t)(k0 + kr) * N + c;
          cp_async16(ws + kr * LDW + (i >> 1) * (BW / 2) + c, src, true);
        }
      } else {
        const int c = (tid & 15) * 8;
        if (c < n_valid) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kr = (tid >> 4) + 16 * i;
            cp_async16(ws + kr * LDW + c, w0 + (size_t)(k0 + kr) * N + c,
                       true);
          }
        }
      }
    };

    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][j][v] = 0.f;

    // The columns of this warp's two 16-wide weight slices in a stage.
    int bcol[2];
#pragma unroll
    for (int np = 0; np < 2; ++np)
      bcol[np] = DUAL ? np * (BW / 2) + wn * 16 : wn * 32 + np * 16;
    const bool warp_live =
        wm * 64 < live && (DUAL || wn * 32 < n_valid);

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) load_stage(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage kt landed; stage kt - 1 is free
      if (kt + STAGES - 1 < KT)
        load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
      cp_async_commit();
      if (!warp_live) continue;
      const bf16* xs = smem + (kt % STAGES) * STAGE;
      const bf16* ws = xs + BM * LDX;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          if (wm * 64 + mt * 16 < live)
            ldsm_x4(af[mt], xs + (wm * 64 + mt * 16 + (lane & 15)) * LDX +
                                kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldsm_x4_t(bf, ws + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LDW + bcol[np] + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            if (wm * 64 + mt * 16 < live) {
              mma(acc[mt][2 * np], af[mt], bf[0], bf[1]);
              mma(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
            }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next row tile refills every stage

    if (warp_live) {
      // acc[mt][j] element v: row wm·64 + mt·16 + g + 8(v / 2), stage
      // column bcol[j / 2] + 8(j % 2) + 2tq + v % 2.
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 64 + mt * 16 + g + 8 * half;
          if (r >= rows) continue;
          bf16* orow = out + (size_t)(start + r0 + r) * N + n0;
          if (DUAL) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float h[2];
#pragma unroll
              for (int v = 0; v < 2; ++v) {
                const float gt = __bfloat162float(
                    __float2bfloat16_rn(acc[mt][j][2 * half + v]));
                const float up = __bfloat162float(
                    __float2bfloat16_rn(acc[mt][2 + j][2 * half + v]));
                h[v] = gt / (1.0f + expf(-gt)) * up;
              }
              *reinterpret_cast<uint32_t*>(orow + wn * 16 + 8 * j + 2 * tq) =
                  tc::pack(h[0], h[1]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = wn * 32 + 8 * j + 2 * tq;
              if (c < n_valid)
                *reinterpret_cast<uint32_t*>(orow + c) = tc::pack(
                    acc[mt][j][2 * half], acc[mt][j][2 * half + 1]);
            }
          }
        }
    }
  }
}

constexpr int CT = 128;  // moe_combine's threads, 8 columns each

__global__ void __launch_bounds__(CT)
moe_combine_kernel(const bf16* __restrict__ y, const int* __restrict__ row,
                   const float* __restrict__ gates,
                   const bf16* __restrict__ shared, bf16* __restrict__ out,
                   int k, int D) {
  const long long t = blockIdx.x;
  const int c = (blockIdx.y * CT + threadIdx.x) * 8;
  if (c >= D) return;
  float acc[8] = {};
  for (int j = 0; j < k; ++j) {
    const long long r = row[t * k + j];
    const float w = __bfloat162float(__float2bfloat16_rn(gates[t * k + j]));
    const uint4 v = *reinterpret_cast<const uint4*>(y + r * D + c);
    const bf16* yv = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = __fmul_rn(w, __bfloat162float(yv[i]));
      acc[i] = j == 0 ? p : __fadd_rn(acc[i], p);
    }
  }
  if (shared != nullptr) {
    const uint4 v = *reinterpret_cast<const uint4*>(shared + t * D + c);
    const bf16* sv = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[i] = __fadd_rn(acc[i], __bfloat162float(sv[i]));
  }
  uint4 o;
  uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) ov[i] = tc::pack(acc[2 * i], acc[2 * i + 1]);
  *reinterpret_cast<uint4*>(out + t * D + c) = o;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <bool DUAL>
int launch_grouped(const void* A, const void* a_rows, const void* W0,
                   const void* W1, const void* offsets, void* out, int E,
                   int K, int N, void* stream) {
  if (E <= 0 || E > 65535 || K <= 0 || K % BK != 0 || N <= 0 ||
      N % (BW / 2) != 0 || A == nullptr || W0 == nullptr ||
      (DUAL && (W1 == nullptr || a_rows == nullptr)) || offsets == nullptr ||
      out == nullptr || !aligned16(A) || !aligned16(W0) ||
      (DUAL && !aligned16(W1)) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  // Two CTAs an SM need the largest shared-memory carveout.
  static std::atomic<unsigned> attr_set{0}, carveout_set{0};
  cudaError_t err =
      smem_limit_once(attr_set, moe_grouped_kernel<DUAL>, SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = 1u << (dev & 31);
  if (!(carveout_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(moe_grouped_kernel<DUAL>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    carveout_set.fetch_or(bit, std::memory_order_release);
  }
  const int tile = DUAL ? BW / 2 : BW;
  dim3 grid((N + tile - 1) / tile, E);
  moe_grouped_kernel<DUAL><<<grid, NT, SMEM,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), static_cast<const int*>(a_rows),
      static_cast<const bf16*>(W0), static_cast<const bf16*>(W1),
      static_cast<const int*>(offsets), static_cast<bf16*>(out), K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// ids: n = T·k int64 expert ids, (token, choice) order; offsets (E + 1),
// tok (n) and row (n) int32 (ids, tok and row may be null where n is 0:
// the launch then writes offsets of 0). Returns the launch's cudaError_t
// (0 on success); never synchronises, like every entry point here.
extern "C" int moe_group(const void* ids, long long n, int k, int E,
                         void* offsets, void* tok, void* row, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || k <= 0 || n % k != 0 || E <= 0 ||
      E > MAX_EXPERTS || offsets == nullptr ||
      (n > 0 && (ids == nullptr || tok == nullptr || row == nullptr)))
    return (int)cudaErrorInvalidValue;
  moe_group_kernel<<<1, GT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ids), (int)n, k, E,
      static_cast<int*>(offsets), static_cast<int*>(tok),
      static_cast<int*>(row));
  return (int)cudaGetLastError();
}

// x (T, K) bf16, tok (n) int32, w_gate and w_up (E, K, N) bf16, offsets
// (E + 1) int32 -> h (n, N) bf16 in sorted order.
extern "C" int moe_gate_up(const void* x, const void* tok, const void* w_gate,
                           const void* w_up, const void* offsets, void* h,
                           int E, int K, int N, void* stream) {
  return launch_grouped<true>(x, tok, w_gate, w_up, offsets, h, E, K, N,
                              stream);
}

// h (n, K) bf16 in sorted order, w_down (E, K, N) bf16, offsets (E + 1)
// int32 -> y (n, N) bf16 in sorted order.
extern "C" int moe_down(const void* h, const void* w_down, const void* offsets,
                        void* y, int E, int K, int N, void* stream) {
  return launch_grouped<false>(h, nullptr, w_down, nullptr, offsets, y, E, K,
                               N, stream);
}

// y (n, D) bf16, row (T·k) int32, gates (T, k) fp32, shared (T, D) bf16 or
// null -> out (T, D) bf16.
extern "C" int moe_combine(const void* y, const void* row, const void* gates,
                           const void* shared, void* out, long long T, int k,
                           int D, void* stream) {
  if (T < 0 || T > 0x7fffffffLL || k <= 0 || D <= 0 || D % 8 != 0 || y == nullptr ||
      row == nullptr || gates == nullptr || out == nullptr || !aligned16(y) ||
      !aligned16(out) || (shared != nullptr && !aligned16(shared)))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  dim3 grid((unsigned)T, (D / 8 + CT - 1) / CT);
  moe_combine_kernel<<<grid, CT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(row),
      static_cast<const float*>(gates), static_cast<const bf16*>(shared),
      static_cast<bf16*>(out), k, D);
  return (int)cudaGetLastError();
}
