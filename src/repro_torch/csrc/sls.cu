// SLS (sparse-lengths-sum, the embedding bag) over an fp32, a row-wise int8 or a
// packed int4 table, written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces the TPU kernels of src/repro/kernels/sls/sls.py: `_sls_fp_kernel`
// (entry `sls_pallas`), `_sls_int8_kernel` (`sls_int8_pallas`) and `_sls_int4_kernel`
// (`sls_int4_pallas`). Same function:
//   out[b, :] = sum over l < min(lengths[b], L) of row(indices[b, l]), in f32,
// with indices (NB,L) int32 and lengths (NB,) int32; a bag of length 0 (or less)
// pools to exactly 0, and no index past a bag's length is read. A lookup whose
// index lies outside [0, R) reads nothing and makes its bag NaN (the reference's
// jnp.take fills rows past the table with NaN). A row is
//   fp32: table[r, :], table (R,D) f32;
//   int8: q[r, :] * scale[r] + bias[r], q (R,D) uint8, scale/bias (R,) fp16, the bias
//         added once per lookup;
//   int4: the same over q4 (R,D/2) uint8, column 2j in the low nibble of byte j and
//         column 2j+1 in the high nibble.
//
// Bound on this card: memory by the bytes, in practice the latency of dependent
// loads. A lookup reads one row (4D, D or D/2 bytes, plus 4 bytes of scale and bias
// when quantized) and does D adds (D fused multiply-adds), far below a FLOP a byte;
// the least time is (sum of lengths x (row bytes + 4) + indices read + lengths +
// output) / 3.35 TB/s, a few microseconds at the DLRM batch (6,144 bags of about 21
// lookups). What a bag waits on is a chain: its length, then its indices, then its
// rows (random over a table of 0.4-58.6 GB), then the store; and how many bags are
// resident at once is set by the registers each lane holds.
//
// What held the first design back (one warp per bag, lanes splitting D at 4 bytes of
// int8 or 2 of int4, 24 of 32 lanes busy at D 96): 8 rows in flight per warp, each
// step waiting on the last, and an index -> shuffle -> row chain that started over
// every 32 lookups, so a 55-lookup bag took 7 dependent steps. The design now, one
// warp per bag (4 warps a block):
//   - Wide loads, several rows per load instruction. A row is cut in `vec`-byte
//     pieces, one per lane: 16 bytes where the row size and the table's address
//     allow, narrower for rows that are not a multiple of 16 bytes, a table view that
//     starts off 16-byte alignment, or int4 (8 bytes, so that a lane sums at most 16
//     columns); the wrapper picks `vec` (kernels/sls/ops.py::lane_plan). The warp's
//     lanes form groups of row_bytes/vec lanes, one row each: at D 96, int8 5 groups
//     of 6 lanes, int4 5 of 6, fp32 1 of 24. A row wider than 32 pieces takes further
//     passes over the bag.
//   - Indices up front. The warp stages up to 128 of the bag's indices (4 a lane,
//     only those below its length) in shared memory before it loads any row, so no
//     row load waits on an index load but the first.
//   - Rows in flight. Group g takes the bag's lookups l = g, g + groups, ... Each lane
//     issues `unroll` row loads (and, when quantized, their fp16 scale and bias)
//     before it adds any of them: 8 rows in flight per warp at D 96 for fp32 (1 x
//     8), 10 for int8 and int4 (5 x 2). More rows per warp cost registers, and fewer
//     resident bags cost more: at 16 or 40 rows a warp the int8 kernel ran slower.
//   - Fixed-order sums. Each group sums its lookups in the order of l, in f32; then
//     the groups' partial sums meet in shared memory and are added in group order,
//     (((p_0 + p_1) + p_2) + ...), so a bag's result does not depend on timing (no
//     atomics). The order differs from the plain "in the order of l" only in that
//     association; kernels/sls/ref.py computes the same grouping (`groups`).
//   - Quantized values become f32 without a conversion instruction: a byte (or a
//     nibble) b placed in the low bits of the float 2^23 is 2^23 + b; subtracting
//     2^23 leaves b.
// A lookup outside the table loads nothing and turns its group's sums to NaN, which
// the group sum carries into the bag. Row offsets are 64-bit: (long long)index * row
// size, since a one-card slab holds more than 2^31 bytes (585,937,456 rows of 96
// bytes).
//
// On one NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_sls_plans.py; main shape:
// 6144 bags, L 128, D 96, 130,239 lookups on a 2^23-row table): device time fp32
// 20.3 us (embedding_bag 36.7), int8 16.7, int4 16.1; the first design took 27.7,
// 21.5 and 28.3 (chip_smoke.py's device window). The same kernels on bags of length
// 0 take 3.4 / 5.2 / 5.2 us and of length 1 6.4 / 7.9 / 7.9: most of the int8 time
// is the chain and the waves of resident warps, not the bytes (4.75 us bound).
// Measured and not kept, all slower at the main shape: rows staged through shared
// memory by cp.async, 8 or 16 lanes a bag, and a cap of 40 registers a thread
// (spills).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 128;  // indices a warp stages at once, 4 a lane
constexpr unsigned kNaNBits = 0x7fc00000u;

enum Kind { kFp = 0, kInt8 = 1, kInt4 = 2 };

// the VB bytes one lane loads
template <int VB>
struct Raw;
template <>
struct Raw<16> {
  using T = uint4;
};
template <>
struct Raw<8> {
  using T = uint2;
};
template <>
struct Raw<4> {
  using T = uint32_t;
};
template <>
struct Raw<2> {
  using T = uint16_t;
};
template <>
struct Raw<1> {
  using T = uint8_t;
};

// 32-bit word i of a lane's load (zero-extended below 4 bytes)
__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ uint32_t word(const uint2& r, int i) {
  return i == 0 ? r.x : r.y;
}
__device__ __forceinline__ uint32_t word(uint32_t r, int) { return r; }
__device__ __forceinline__ uint32_t word(uint16_t r, int) { return r; }
__device__ __forceinline__ uint32_t word(uint8_t r, int) { return r; }

// byte k (0..3) of w, a value 0..255, as a float: the bits 0x4B0000bb are 2^23 + b
__device__ __forceinline__ float u8f(uint32_t w, int k) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | k)) - 8388608.f;
}

// output columns one lane holds
template <int KIND, int VB>
__host__ __device__ constexpr int cols_per_lane() {
  return KIND == kFp ? VB / 4 : KIND == kInt8 ? VB : 2 * VB;
}

// a piece of VB bytes -> its columns, in column order
template <int KIND, int VB, typename R>
__device__ __forceinline__ void unpack(const R& raw,
                                       float (&f)[cols_per_lane<KIND, VB>()]) {
  if constexpr (KIND == kFp) {
#pragma unroll
    for (int k = 0; k < VB / 4; ++k) f[k] = __uint_as_float(word(raw, k));
  } else if constexpr (KIND == kInt8) {
#pragma unroll
    for (int k = 0; k < VB; ++k) f[k] = u8f(word(raw, k / 4), k % 4);
  } else {  // byte j holds column 2j (low nibble) and 2j + 1 (high nibble)
#pragma unroll
    for (int k = 0; k < VB; ++k) {
      const uint32_t w = word(raw, k / 4);
      f[2 * k] = u8f(w & 0x0F0F0F0Fu, k % 4);
      f[2 * k + 1] = u8f((w >> 4) & 0x0F0F0F0Fu, k % 4);
    }
  }
}

template <int KIND, int VB, int U>
__global__ void __launch_bounds__(kThreads)
sls_kernel(const uint8_t* __restrict__ rows, const __half* __restrict__ scale,
           const __half* __restrict__ bias, const int* __restrict__ idx,
           const int* __restrict__ lens, float* __restrict__ out, int NB, int L, int D,
           int R) {
  using RawT = typename Raw<VB>::T;
  constexpr int CPL = cols_per_lane<KIND, VB>();
  __shared__ int s_idx[kWarps][kBatch];
  __shared__ float s_part[kWarps][32 * CPL];  // the groups' partial sums of a pass
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= NB) return;  // the whole warp leaves together
  const int n = max(0, min(lens[b], L));
  const int* bag = idx + (long long)b * L;
  const long long row_bytes = KIND == kFp ? 4LL * D : KIND == kInt4 ? D / 2 : D;
  const int lpr = (int)(row_bytes / VB);        // VB-byte pieces a row holds
  const int groups = lpr <= 32 ? 32 / lpr : 1;  // rows one warp load reads
  const int batch = kBatch / groups * groups;   // staged indices, a multiple of groups
  const int g = lpr <= 32 ? lane / lpr : 0;     // this lane's group
  int* sidx = s_idx[warp];
  float* part = s_part[warp];

  for (int p0 = 0; p0 < lpr; p0 += 32) {  // one pass unless a row is over 32 pieces
    const int piece = p0 + (lpr <= 32 ? lane % lpr : lane);
    const bool active = g < groups && piece < lpr;
    const long long off = (long long)piece * VB;  // byte offset of the piece in a row
    float acc[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[k] = 0.f;

    for (int l0 = 0; l0 < n; l0 += batch) {
      const int m = min(batch, n - l0);  // lookups of this batch
      if (p0 == 0 || n > batch) {        // stage the batch's indices, all loads first
        int v[kBatch / 32];
#pragma unroll
        for (int k = 0; k < kBatch / 32; ++k) {
          const int i = lane + 32 * k;
          v[k] = i < m ? bag[l0 + i] : 0;  // never past the bag's end
        }
        __syncwarp();  // the previous batch's indices are read
#pragma unroll
        for (int k = 0; k < kBatch / 32; ++k)
          if (lane + 32 * k < m) sidx[lane + 32 * k] = v[k];
        __syncwarp();
      }
      for (int s0 = 0; s0 < m; s0 += groups * U) {
        RawT raw[U];
        float sc[U], bi[U];
        bool take[U], inside[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {  // every load of the step before any add
          const int l = s0 + u * groups + g;
          take[u] = active && l < m;
          const int ri = take[u] ? sidx[l] : 0;
          inside[u] = (unsigned)ri < (unsigned)R;
          if (take[u] && inside[u]) {
            const long long r = ri;
            raw[u] = *reinterpret_cast<const RawT*>(rows + r * row_bytes + off);
            if constexpr (KIND != kFp) {
              sc[u] = __half2float(scale[r]);
              bi[u] = __half2float(bias[r]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {  // in the order of l within the group
          if (!take[u]) continue;
          if (!inside[u]) {
#pragma unroll
            for (int k = 0; k < CPL; ++k) acc[k] = __uint_as_float(kNaNBits);
            continue;
          }
          float v[CPL];
          unpack<KIND, VB>(raw[u], v);
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            if constexpr (KIND == kFp)
              acc[k] += v[k];
            else
              acc[k] += fmaf(v[k], sc[u], bi[u]);
          }
        }
      }
    }

    // the groups' partial sums, added in group order
    const int c0 = p0 * CPL;                // first column of this pass
    const int pw = min(32, lpr - p0) * CPL;  // columns of this pass
    if (active) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) part[g * pw + (piece - p0) * CPL + k] = acc[k];
    }
    __syncwarp();
    float* o = out + (long long)b * D + c0;
    for (int col = lane; col < pw; col += 32) {
      float s = part[col];
      for (int gg = 1; gg < groups; ++gg) s += part[gg * pw + col];
      o[col] = s;
    }
    __syncwarp();  // before the next pass writes its partial sums
  }
}

template <int KIND, int VB, int U>
int launch_one(const void* rows, const void* scale, const void* bias, const void* idx,
               const void* lens, void* out, int NB, int L, int D, int R,
               cudaStream_t st) {
  const dim3 grid((NB + kWarps - 1) / kWarps);
  sls_kernel<KIND, VB, U><<<grid, kThreads, 0, st>>>(
      (const uint8_t*)rows, (const __half*)scale, (const __half*)bias, (const int*)idx,
      (const int*)lens, (float*)out, NB, L, D, R);
  return (int)cudaGetLastError();
}

template <int KIND, int VB>
int launch_vec(int unroll, const void* rows, const void* scale, const void* bias,
               const void* idx, const void* lens, void* out, int NB, int L, int D, int R,
               cudaStream_t st) {
  if (unroll == 2)
    return launch_one<KIND, VB, 2>(rows, scale, bias, idx, lens, out, NB, L, D, R, st);
  if (unroll == 4)
    return launch_one<KIND, VB, 4>(rows, scale, bias, idx, lens, out, NB, L, D, R, st);
  if (unroll == 8)
    return launch_one<KIND, VB, 8>(rows, scale, bias, idx, lens, out, NB, L, D, R, st);
  return (int)cudaErrorInvalidValue;
}

// `vec`, the bytes a lane loads of a row (16, 8, 4, 2 or 1, dividing the row size and
// the table's address; at least 4 for fp32), and `unroll`, the row loads a lane
// issues before it adds any (2, 4 or 8), as kernels/sls/ops.py::lane_plan picks them.
template <int KIND>
int launch(const void* rows, const void* scale, const void* bias, const void* idx,
           const void* lens, void* out, int NB, int L, int D, int R, int vec, int unroll,
           void* stream) {
  const long long row_bytes = KIND == kFp ? 4LL * D : KIND == kInt4 ? D / 2 : D;
  if (NB <= 0 || L < 0 || D <= 0 || R <= 0 || (KIND == kInt4 && D % 2) || vec <= 0 ||
      row_bytes % vec != 0 || (uintptr_t)rows % vec != 0 || (KIND == kFp && vec < 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec) {
    case 16: return launch_vec<KIND, 16>(unroll, rows, scale, bias, idx, lens, out, NB, L,
                                         D, R, st);
    case 8: return launch_vec<KIND, 8>(unroll, rows, scale, bias, idx, lens, out, NB, L,
                                       D, R, st);
    case 4: return launch_vec<KIND, 4>(unroll, rows, scale, bias, idx, lens, out, NB, L,
                                       D, R, st);
  }
  if constexpr (KIND != kFp) {
    if (vec == 2)
      return launch_vec<KIND, 2>(unroll, rows, scale, bias, idx, lens, out, NB, L, D, R,
                                 st);
    if (vec == 1)
      return launch_vec<KIND, 1>(unroll, rows, scale, bias, idx, lens, out, NB, L, D, R,
                                 st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// table (R,D) f32; indices (NB,L) int32; lengths (NB,) int32; out (NB,D) f32. All on
// the device, contiguous. `vec` and `unroll` as `launch` above. Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
int sls_fp_fwd(const void* table, const void* indices, const void* lengths, void* out,
               int NB, int L, int D, int R, int vec, int unroll, void* stream) {
  return launch<kFp>(table, nullptr, nullptr, indices, lengths, out, NB, L, D, R, vec,
                     unroll, stream);
}

// q (R,D) uint8; scale and bias (R,) fp16; the rest as sls_fp_fwd.
int sls_int8_fwd(const void* q, const void* scale, const void* bias, const void* indices,
                 const void* lengths, void* out, int NB, int L, int D, int R, int vec,
                 int unroll, void* stream) {
  return launch<kInt8>(q, scale, bias, indices, lengths, out, NB, L, D, R, vec, unroll,
                       stream);
}

// q4 (R,D/2) uint8, low nibble = even column; D is the output width (even).
int sls_int4_fwd(const void* q4, const void* scale, const void* bias, const void* indices,
                 const void* lengths, void* out, int NB, int L, int D, int R, int vec,
                 int unroll, void* stream) {
  return launch<kInt4>(q4, scale, bias, indices, lengths, out, NB, L, D, R, vec, unroll,
                       stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
