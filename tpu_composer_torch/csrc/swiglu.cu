// SwiGLU's element-wise step for Hopper (sm_90a), bf16, plain C interface:
// out = bf16(silu(float(gate)) * float(up)), one kernel in place of the
// five the eager chain launches (two upcasts, SiLU, the product, the
// downcast) between the gate/up products and the down product of the
// dense FFN (models/transformer.py::swiglu_ffn) and of the MoE experts
// (models/moe.py::_moe_ffn).
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA,
// which fuses it into one loop. The port ran it as five PyTorch
// kernels, which move 19 bytes an element through device memory (two
// bf16 reads and float32 writes, the float32 reads and writes of SiLU
// and the product, the float32 read and bf16 write of the cast); this
// kernel moves 6 (two bf16 reads, one bf16 write).
//
// The arithmetic is the eager chain's, bit for bit: the exact bf16 ->
// float32 widening, SiLU by the formula of PyTorch's CUDA SiLU kernel,
// x / (1 + exp(-x)) in float32 with expf and IEEE division (no fast
// math), the product in float32, and one round to nearest even to bf16
// (__float2bfloat16_rn, the instruction PyTorch's bf16 conversion uses
// on sm_80 and later).
//
// What bounds it on this card: bytes. 6 bytes and about 30 operations
// an element are far below the ~295 operations a byte where compute
// would become the limit, so the design only keeps HBM busy:
// - each thread loads one 16-byte vector (8 bf16) of gate and of up and
//   stores one of out, neighbouring threads on neighbouring vectors, so
//   a warp's accesses are 512-byte runs;
// - the grid covers every vector, one a thread: at 30 registers an SM
//   holds 2,048 threads, 64 KB of loads in flight, and a block that
//   finishes frees its slot for the next at once. Measured on an H100
//   SXM against a grid of the SM count that strides over the vectors
//   (unrolled 1, 2, 4 or 8 vectors a trip, 128 to 512 threads, with
//   and without L2 prefetch and streaming cache hints): the strided
//   grids held 77-83 % of the bytes floor at 1,024 x 14,336 and 77-80 %
//   at 2,048 x 14,336, this one 82 % and 86 %;
// - the elements past the last whole vector, and every element when a
//   pointer is not 16-byte aligned, take one scalar element a thread.
// The operands are flat: any shape whose gate, up and out are
// contiguous and of one size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ __nv_bfloat16 swiglu_one(__nv_bfloat16 g,
                                                    __nv_bfloat16 u) {
  const float x = __bfloat162float(g);
  const float silu = x / (1.0f + expf(-x));
  return __float2bfloat16_rn(silu * __bfloat162float(u));
}

__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const __nv_bfloat16* __restrict__ gate,
              const __nv_bfloat16* __restrict__ up,
              __nv_bfloat16* __restrict__ out, long long n,
              long long n_vec) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n_vec) {
    const uint4 g = reinterpret_cast<const uint4*>(gate)[i];
    const uint4 u = reinterpret_cast<const uint4*>(up)[i];
    const __nv_bfloat16* gh = reinterpret_cast<const __nv_bfloat16*>(&g);
    const __nv_bfloat16* uh = reinterpret_cast<const __nv_bfloat16*>(&u);
    uint4 o;
    __nv_bfloat16* oh = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) oh[j] = swiglu_one(gh[j], uh[j]);
    reinterpret_cast<uint4*>(out)[i] = o;
  }
  const long long t = n_vec * 8 + i;
  if (t < n) out[t] = swiglu_one(gate[t], up[t]);
}

}  // namespace

// gate, up and out: n contiguous bf16 each; stream: the caller's
// cudaStream_t. Returns the launch's cudaError_t (0 on success); never
// synchronises.
extern "C" int swiglu(const void* gate, const void* up, void* out,
                      long long n, void* stream) {
  if (n < 0 || gate == nullptr || up == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(gate) |
                         reinterpret_cast<std::uintptr_t>(up) |
                         reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  const long long n_vec = aligned ? n / 8 : 0;
  const long long tail = n - 8 * n_vec;
  const long long work = n_vec > tail ? n_vec : tail;
  const long long grid = (work + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swiglu_kernel<<<(unsigned)grid, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(gate),
      static_cast<const __nv_bfloat16*>(up),
      static_cast<__nv_bfloat16*>(out), n, n_vec);
  return (int)cudaGetLastError();
}
