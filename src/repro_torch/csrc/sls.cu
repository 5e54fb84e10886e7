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
// Design. One warp per bag (4 warps a block). The lanes split D: lane `lane` holds
// kCols consecutive output columns, read with the widest load the row allows (16,
// 8 or 4 bytes of fp32, 4, 2 or 1 bytes of int8 or packed int4, picked from D and
// the table's alignment); columns beyond 32 * kCols take further passes over the bag.
// The lanes load 32 of the bag's indices at a time and broadcast them with
// shuffles; each step issues kUnroll rows' loads (and their fp16 scale and bias)
// before it dequantizes any of them in registers, so the loads of a step are in
// flight together. A step's lookups past the bag's end, and indices outside the
// table, load row 0 instead (always in bounds) and are not added. Every lane sums
// its columns in f32 in the order of l. Row offsets are 64-bit: (long long)index *
// row size, since a one-card slab holds more than 2^31 bytes (585,937,456 rows of
// 96 bytes).
//
// Bound on this card: memory. A lookup reads one row (4D, D or D/2 bytes, plus 4
// bytes of scale and bias when quantized) and does D adds (D fused multiply-adds),
// far below a FLOP a byte; the least time is (sum of lengths x (row bytes + 4) +
// indices read + lengths + output) / 3.35 TB/s. At the DLRM batch (6,144 bags of
// about 21 lookups) that is a few microseconds, so the kernel is bound by latency:
// the dependent index -> row load chain of each step. Left for later: prefetching the
// next 32 indices while a step's rows are in flight.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;  // rows in flight per warp and step; divides 32
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNaNBits = 0x7fc00000u;

enum Kind { kFp = 0, kInt8 = 1, kInt4 = 2 };

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <int KIND>
struct Storage {
  using T = uint8_t;
};
template <>
struct Storage<kFp> {
  using T = float;
};

// V storage elements of one lane -> its kCols output values
template <int KIND, int V>
__device__ __forceinline__ void unpack(const Vec<typename Storage<KIND>::T, V>& raw,
                                       float (&out)[KIND == kInt4 ? 2 * V : V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if constexpr (KIND == kFp) {
      out[k] = raw.v[k];
    } else if constexpr (KIND == kInt8) {
      out[k] = (float)raw.v[k];
    } else {
      out[2 * k] = (float)(raw.v[k] & 0xF);
      out[2 * k + 1] = (float)(raw.v[k] >> 4);
    }
  }
}

template <int KIND, int V>
__global__ void __launch_bounds__(kThreads)
sls_kernel(const typename Storage<KIND>::T* __restrict__ rows,
           const __half* __restrict__ scale, const __half* __restrict__ bias,
           const int* __restrict__ idx, const int* __restrict__ lens,
           float* __restrict__ out, int NB, int L, int D, int R) {
  using S = typename Storage<KIND>::T;
  using Raw = Vec<S, V>;
  constexpr int kCols = KIND == kInt4 ? 2 * V : V;  // output columns a lane holds
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= NB) return;  // the whole warp leaves together
  const int n = max(0, min(lens[b], L));
  const int* bag = idx + (long long)b * L;
  const long long row_elems = KIND == kInt4 ? D / 2 : D;  // storage elements a row

  for (int c0 = 0; c0 < D; c0 += 32 * kCols) {
    const int col = c0 + lane * kCols;
    const bool active = col < D;  // D % kCols == 0, so col + kCols <= D
    const long long off = active ? (KIND == kInt4 ? col / 2 : col) : 0;
    float acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0.f;

    for (int l0 = 0; l0 < n; l0 += 32) {
      const int m = min(32, n - l0);                 // lookups of this chunk
      const int mine = lane < m ? bag[l0 + lane] : 0;  // never past the bag's end
      for (int u0 = 0; u0 < m; u0 += kUnroll) {
        Raw raw[kUnroll];
        float s[kUnroll], bi[kUnroll];
        bool inside[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          // lanes past the chunk hold index 0: a valid row, loaded and not added
          const int ri = __shfl_sync(kFull, mine, u0 + u);
          inside[u] = (unsigned)ri < (unsigned)R;
          const long long r = inside[u] ? ri : 0;
          raw[u] = *reinterpret_cast<const Raw*>(rows + r * row_elems + off);
          if constexpr (KIND != kFp) {
            s[u] = __half2float(scale[r]);
            bi[u] = __half2float(bias[r]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u0 + u >= m) break;  // the same for every lane
          if (!inside[u]) {        // the same for every lane
#pragma unroll
            for (int k = 0; k < kCols; ++k) acc[k] = __uint_as_float(kNaNBits);
            continue;
          }
          float v[kCols];
          unpack<KIND, V>(raw[u], v);
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            if constexpr (KIND == kFp)
              acc[k] += v[k];
            else
              acc[k] += v[k] * s[u] + bi[u];
          }
        }
      }
    }
    if (active) {
      float* o = out + (long long)b * D + col;
#pragma unroll
      for (int k = 0; k < kCols; ++k) o[k] = acc[k];
    }
  }
}

template <int KIND>
int launch(const void* rows, const void* scale, const void* bias, const void* idx,
           const void* lens, void* out, int NB, int L, int D, int R, void* stream) {
  if (NB <= 0 || L < 0 || D <= 0 || R <= 0 || (KIND == kInt4 && D % 2))
    return (int)cudaErrorInvalidValue;
  using S = typename Storage<KIND>::T;
  const S* t = (const S*)rows;
  const __half* s = (const __half*)scale;
  const __half* bi = (const __half*)bias;
  const int* ix = (const int*)idx;
  const int* ln = (const int*)lens;
  float* o = (float*)out;
  // the widest lane load that every row start allows
  const long long row_bytes = (KIND == kFp ? 4LL : 1LL) * (KIND == kInt4 ? D / 2 : D);
  auto fits = [&](int v) {
    const int bytes = v * (int)sizeof(S);
    return row_bytes % bytes == 0 && (uintptr_t)t % bytes == 0;
  };
  const dim3 grid((NB + kWarps - 1) / kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  if (fits(4))
    sls_kernel<KIND, 4><<<grid, kThreads, 0, st>>>(t, s, bi, ix, ln, o, NB, L, D, R);
  else if (fits(2))
    sls_kernel<KIND, 2><<<grid, kThreads, 0, st>>>(t, s, bi, ix, ln, o, NB, L, D, R);
  else
    sls_kernel<KIND, 1><<<grid, kThreads, 0, st>>>(t, s, bi, ix, ln, o, NB, L, D, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table (R,D) f32; indices (NB,L) int32; lengths (NB,) int32; out (NB,D) f32. All on
// the device, contiguous. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
int sls_fp_fwd(const void* table, const void* indices, const void* lengths, void* out,
               int NB, int L, int D, int R, void* stream) {
  return launch<kFp>(table, nullptr, nullptr, indices, lengths, out, NB, L, D, R, stream);
}

// q (R,D) uint8; scale and bias (R,) fp16; the rest as sls_fp_fwd.
int sls_int8_fwd(const void* q, const void* scale, const void* bias, const void* indices,
                 const void* lengths, void* out, int NB, int L, int D, int R,
                 void* stream) {
  return launch<kInt8>(q, scale, bias, indices, lengths, out, NB, L, D, R, stream);
}

// q4 (R,D/2) uint8, low nibble = even column; D is the output width (even).
int sls_int4_fwd(const void* q4, const void* scale, const void* bias, const void* indices,
                 const void* lengths, void* out, int NB, int L, int D, int R,
                 void* stream) {
  return launch<kInt4>(q4, scale, bias, indices, lengths, out, NB, L, D, R, stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
