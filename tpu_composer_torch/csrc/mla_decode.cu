// K3: paged decode attention over a latent (MLA) pool for Hopper (sm_90a),
// bf16, plain C interface. Two kernels a call: a split pass and a merge
// pass (flash-decoding, as K2).
//
// Replaces no TPU kernel: the JAX package has no latent attention. It is
// the absorbed decode of models/mla.py. Each row's 16 heads query one
// stream of latent entries (576 bf16 a position: the normalised c_kv, 512,
// then the roped k_pe, 64): scores are q_lat_h · entry over all 576 dims
// times `scale` (1/√192, the expanded form's), masked at positions >=
// lengths[b], softmax with fp32 m, l and acc, where l sums the unrounded
// fp32 p; P is rounded to bf16 before P·V, and V is the first 512 dims of
// the same entries. out = acc / max(l, 1e-30) in bf16, (B, 16, 512); a row
// of length 0 gives zeros.
//
// What bounds it on this card. Per position and head it does 2·(576 + 512)
// operations and reads 1,152 bytes once for all 16 heads: about 30
// operations a byte, above what CUDA cores sustain at 3.35 TB/s (the
// decode cell reads 12.7 GB of latent a step), so both products run on the
// tensor cores, and the bound is the bytes. The design:
// - Split pass: one CTA of 4 warps per (row b, split z), attending cache
//   positions [z·C, (z+1)·C) ∩ [0, n_pos) for all 16 heads, so each latent
//   entry is read from device memory once. C (`chunk`, a multiple of 32)
//   and n_split = ceil(MB·Bs / C) come from shapes only
//   (ops/mla_decode.py::_mla_split), never from lengths: the wrapper reads
//   nothing back and the call can be captured in a CUDA graph. A CTA whose
//   chunk starts at or past n_pos = min(lengths[b], MB·Bs) reads no table
//   entry, writes m = −inf, l = 0 and returns.
// - A live CTA reads its block ids once, copies the 16 query rows into
//   shared memory, then walks its positions in tiles of 32 entries, double
//   buffered with 16-byte cp.async (tile t+1 in flight while t computes;
//   rows padded by 16 bytes so ldmatrix reads hit distinct banks; entries
//   past n_pos are zero-filled by the copy).
// - S = Q·Eᵀ runs as mma.sync m16n8k16 with the heads as the 16 rows:
//   warp w takes entries 8w … 8w+7 of the tile over the 576 dims (Q and E
//   fragments by ldmatrix). The scores go to shared memory; 8 threads a
//   head take the tile's max and sum (online softmax over the tiles), write
//   P as bf16 and the head's rescale factor. Then O += P·V on the tensor
//   cores, warp w owning output columns 128w … 128w+127 (16 accumulator
//   tiles), V fragments by ldmatrix.trans from the same staged entries.
//   Four barriers a tile.
// - The partials (m, l, acc[16, 512]) are fp32 in scratch the wrapper
//   allocates. Merge pass: one thread per (b·16 + h, column pair) combines
//   the n_split partials in the order z = 0 … n_split−1 under the m_safe /
//   alpha guards, skipping empty chunks: no atomics, the same bits on
//   every run.
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
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma;
using tc::PAD;

constexpr int H = 16;        // heads: the 16 rows of every product
constexpr int L = 576;       // entry width: scores run over all of it
constexpr int R = 512;       // value width: the entry's first R dims
constexpr int BK = 32;       // entries per tile
constexpr int NT = 128;      // threads per CTA, both kernels
constexpr int LD = L + PAD;  // shared row stride of Q and the entries
constexpr int LDS = BK + 4;  // fp32 scores' row stride
constexpr int LDP = BK + PAD;  // bf16 P's row stride
constexpr int CH = L / 8;    // 16-byte copies per row
constexpr int MAX_CHUNK = 4096;

// Shared memory of a split CTA: Q (H x LD), two stages of BK entries,
// the scores (H x LDS fp32), P (H x LDP bf16), m, l and the rescale
// factors (H fp32 each), then the ids of the blocks the chunk touches (at
// most chunk / Bs + 2).
size_t split_smem_bytes(int chunk, int Bs) {
  return sizeof(bf16) * ((size_t)H * LD + 2 * (size_t)BK * LD) +
         sizeof(float) * ((size_t)H * LDS + 3 * H) + sizeof(bf16) * H * LDP +
         sizeof(int) * (size_t)(chunk / Bs + 2);
}

// Scratch layout, rows r = b·H + h: acc at part[(r·n_split + z)·R], then
// (m, l) at part[rows·n_split·R + (r·n_split + z)·2].
__global__ void __launch_bounds__(NT)
mla_decode_split_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        float* __restrict__ part, int Bs, int MB, int chunk,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);         // H x LD
  bf16* e_s = q_s + H * LD;                               // 2 x BK x LD
  float* s_s = reinterpret_cast<float*>(e_s + 2 * BK * LD);  // H x LDS
  float* m_s = s_s + H * LDS;
  float* l_s = m_s + H;
  float* a_s = l_s + H;
  bf16* p_s = reinterpret_cast<bf16*>(a_s + H);           // H x LDP
  int* blk_s = reinterpret_cast<int*>(p_s + H * LDP);

  const int b = blockIdx.x, z = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int n_pos = min(max(lengths[b], 0), MB * Bs);
  const int p0 = z * chunk;
  const long row0 = (long)b * H;
  const long rows = (long)gridDim.x * H;
  float* acc_out = part + (row0 * n_split + z) * R;
  float* ml_out = part + rows * n_split * R + (row0 * n_split + z) * 2;

  if (p0 >= n_pos) {  // an empty chunk: weight 0 in the merge
    if (tid < H) {
      ml_out[(long)tid * n_split * 2] = -INFINITY;
      ml_out[(long)tid * n_split * 2 + 1] = 0.f;
    }
    return;
  }
  // Position p0 + t lies at offset (o0 + t) % Bs of the chunk's block
  // (o0 + t) / Bs, counted from the table slot of p0.
  const int n = min(chunk, n_pos - p0);
  const int o0 = p0 % Bs;
  const int* tb = tables + (long)b * MB + p0 / Bs;
  for (int j = tid; j * Bs < o0 + n; j += NT) blk_s[j] = tb[j];
  if (tid < H) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const bf16* qb = q + row0 * L;
  for (int i = tid; i < H * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    cp_async16(q_s + r * LD + c, qb + r * L + c, true);
  }
  const int n_tiles = (n + BK - 1) / BK;
  // Tile t's entries into stage t & 1; entries past n are zero-filled
  // from the chunk's first entry, a mapped address.
  auto load_tile = [&](int t) {
    bf16* es = e_s + (t & 1) * BK * LD;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8, k = t * BK + r;
      const int o = o0 + (k < n ? k : 0);
      const long row = (long)blk_s[o / Bs] * Bs + o % Bs;
      cp_async16(es + r * LD + c, pool + row * L + c, k < n);
    }
  };
  load_tile(0);
  cp_async_commit();

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and at t = 0 the query rows)
    __syncthreads();
    const bf16* es = e_s + (t & 1) * BK * LD;

    // S = Q·Eᵀ for entries 8w … 8w+7: element e of sc is (head g + 8(e/2),
    // entry 8w + 2tq + e % 2).
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int kc = 0; kc < L / 32; ++kc) {
      uint32_t qa[4], qb2[4], ef[4];
      ldsm_x4(qa, q_s + (lane & 15) * LD + kc * 32 + (lane >> 4) * 8);
      ldsm_x4(qb2, q_s + (lane & 15) * LD + kc * 32 + 16 + (lane >> 4) * 8);
      ldsm_x4(ef, es + (warp * 8 + (lane & 7)) * LD + kc * 32 +
                      (lane >> 3) * 8);
      mma(sc, qa, ef[0], ef[1]);
      mma(sc, qb2, ef[2], ef[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = warp * 8 + 2 * tq + (e & 1);
      s_s[(g + 8 * (e >> 1)) * LDS + k] =
          t * BK + k < n ? sc[e] * scale : -INFINITY;
    }
    __syncthreads();

    // The tile's softmax: 8 neighbouring threads a head, 4 entries each.
    {
      const int h = tid / 8, j = (tid % 8) * 4;
      const float* sh = s_s + h * LDS + j;
      const float m_old = m_s[h];
      float mx = fmaxf(fmaxf(sh[0], sh[1]), fmaxf(sh[2], sh[3]));
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // The tile's first entry is live, so m_new is finite.
      const float m_new = fmaxf(m_old, mx);
      float p[4], ps = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = expf(sh[i] - m_new);
        ps += p[i];
      }
      *reinterpret_cast<uint32_t*>(p_s + h * LDP + j) = tc::pack(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(p_s + h * LDP + j + 2) =
          tc::pack(p[2], p[3]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      __syncwarp();  // every thread of the head has read m_old
      if (j == 0) {
        const float alpha = expf(m_old - m_new);  // 0 at the first tile
        a_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + ps;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // O = alpha·O + P·V on columns 128w … 128w+127.
    const float al0 = a_s[g], al1 = a_s[g + 8];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      ldsm_x4(pa, p_s + (lane & 15) * LDP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < 8; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, es + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              LD + warp * 128 + dp * 16 + (lane >> 4) * 8);
        mma(acc[2 * dp], pa, vf[0], vf[1]);
        mma(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the stage, the scores and P are refilled next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* ah = acc_out + (long)(g + 8 * r) * n_split * R + warp * 128 + 2 * tq;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(ah + j * 8) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
  if (tid < H) {
    ml_out[(long)tid * n_split * 2] = m_s[tid];
    ml_out[(long)tid * n_split * 2 + 1] = l_s[tid];
  }
}

// out[r][d, d+1] from the n_split partials of row r, in the order
// z = 0 … n_split−1: the same bits on every run.
__global__ void __launch_bounds__(NT)
mla_decode_merge_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                        int rows, int n_split) {
  const long i = (long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long)rows * (R / 2)) return;
  const long r = i / (R / 2);
  const int d = (int)(i % (R / 2)) * 2;
  const float* acc = part + r * n_split * R + d;
  const float* ml = part + (long)rows * n_split * R + r * n_split * 2;
  float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float mz = ml[2 * z];
    if (mz == -INFINITY) continue;  // an empty chunk; its acc is unwritten
    const float m_new = fmaxf(m, mz);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float alpha = isfinite(m) ? expf(m - m_safe) : 0.f;
    const float beta = expf(mz - m_safe);
    const float2 az = *reinterpret_cast<const float2*>(acc + (long)z * R);
    l = alpha * l + beta * ml[2 * z + 1];
    a0 = alpha * a0 + beta * az.x;
    a1 = alpha * a1 + beta * az.y;
    m = m_new;
  }
  const float lc = fmaxf(l, 1e-30f);
  *reinterpret_cast<__nv_bfloat162*>(out + r * R + d) =
      __floats2bfloat162_rn(a0 / lc, a1 / lc);
}

}  // namespace

// q (B, 16, 576) bf16; pool (N, Bs, 576) bf16 (one layer); q and pool
// 16-byte aligned; tables (B, MB) int32; lengths (B,) int32; out (B, 16,
// 512) bf16. chunk: cache positions per split CTA, a multiple of 32 up to
// 4096; n_split = ceil(MB·Bs / chunk). scratch: fp32,
// B·16·n_split·(512 + 2) floats. Returns a cudaError_t code (0 = both
// kernels launched).
extern "C" int mla_decode(const void* q, const void* pool, const void* tables,
                          const void* lengths, void* out, void* scratch, int B,
                          int Bs, int MB, int chunk, int n_split, float scale,
                          void* stream) {
  if (B <= 0 || Bs <= 0 || MB <= 0 || chunk < BK || chunk > MAX_CHUNK ||
      chunk % BK != 0 || n_split != (MB * Bs + chunk - 1) / chunk ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = split_smem_bytes(chunk, Bs);
  static std::atomic<unsigned> attr_set{0};
  cudaError_t err =
      smem_limit_once(attr_set, mla_decode_split_kernel, 232448);
  if (err != cudaSuccess) return (int)err;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  dim3 grid(B, n_split);
  mla_decode_split_kernel<<<grid, NT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pool),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<float*>(scratch), Bs, MB, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n = (long)B * H * (R / 2);
  mla_decode_merge_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, s>>>(
      static_cast<const float*>(scratch), static_cast<bf16*>(out), B * H,
      n_split);
  return (int)cudaGetLastError();
}
