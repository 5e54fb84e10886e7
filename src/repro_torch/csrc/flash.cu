// Flash attention for prefill, written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` in src/repro/kernels/flash_attn/flash.py
// (entry `flash_attention`, padded wrapper `ops.py::flash_attn`). Same function:
// q (B,S,H,hd) against k, v (B,T,K,hd) with GQA (G = H/K query heads share a kv
// head), causal or not, an optional sliding window, an optional logit softcap and
// a per-row valid key length `lens` (B,). Online softmax (m, l, acc) in f32; a row
// whose keys are all masked gives 0. Output (B,S,H,hd) in the input type.
//
// Design. One thread block per (batch, kv head, tile of 64 rows), where a "row"
// is one (query position, group head) pair: flattened row r = s*G + g, so all G
// heads that share a kv head are served by the same K/V tiles. The block keeps
// its Q tile in shared memory, streams K/V through shared memory 32 keys at a
// time, and keeps (m, l, acc) in registers: thread (ty, tx) owns rows ty*4..+3
// and output columns tx + 8*c. Scores are reduced across the 8 column lanes of
// a row with warp shuffles. The kv loop starts at the window's left edge and
// stops at the block's causal frontier and at lens[b]; the kernel masks the
// ragged S and T edges itself (the TPU wrapper pads to its block grid instead).
// Shared memory rows are padded by one float so column reads hit distinct banks.
//
// Bound on this card: at the main path's prefill shapes (S = T = 512, hd = 128,
// bf16) the work is 4*S*T*H*hd/2 FLOPs against Q+K+V+O bytes, about 180 FLOPs
// per byte, so the tensor cores (989 TFLOP/s bf16) would bound it. This first
// version does the two products with f32 FMAs on the CUDA cores (67 TFLOP/s at
// most), so it is far from that bound. Left for later: mma/wgmma tensor-core
// products on bf16 tiles, TMA loads into a multi-stage ring with mbarriers, and
// warp specialisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kRows = 64;      // flattened (query, group-head) rows per block
constexpr int kBk = 32;        // keys per K/V tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kColsPerThread = kBk / 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reduce across the 8 lanes (tx = lane & 7) that share one row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kRows * (HD + 1) + 2 * (size_t)kBk * (HD + 1) +
                          (size_t)kRows * (kBk + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ lens, T* __restrict__ o, int S, int T_, int H, int K,
                 int causal, int window, float softcap, float scale) {
  constexpr int LD = HD + 1;            // padded smem row stride for Q, K, V
  constexpr int LP = kBk + 1;           // padded smem row stride for P
  constexpr int CPT = HD / 8;           // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][LD]
  float* ks = qs + kRows * LD;          // [kBk][LD]
  float* vs = ks + kBk * LD;            // [kBk][LD]
  float* ps = vs + kBk * LD;            // [kRows][LP]

  const int G = H / K;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * kRows;    // first flattened row of this block
  const int n_rows = S * G;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;

  // Q tile; rows past the ragged S edge load zeros and are never stored
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int row = i / HD, d = i % HD, r = r0 + row;
    float val = 0.f;
    if (r < n_rows) {
      const int s = r / G, g = r % G;
      val = to_f(q[(((size_t)b * S + s) * H + h * G + g) * HD + d]);
    }
    qs[row * LD + d] = val;
  }

  // key range this block needs: from the window's left edge to the causal
  // frontier of its last row, and never past lens[b]
  const int len_b = min(lens[b], T_);
  const int q_first = r0 / G;
  const int q_last = (min(r0 + kRows, n_rows) - 1) / G;
  int k_end = len_b;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q_first - window + 1) / kBk) * kBk;

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = (r0 + ty * 4 + i) / G;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBk) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kBk * HD; i += kThreads) {
      const int row = i / HD, d = i % HD, t = k0 + row;
      float kv = 0.f, vv = 0.f;
      if (t < T_) {
        const size_t off = (((size_t)b * T_ + t) * K + h) * HD + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[row * LD + d] = kv;
      vs[row * LD + d] = vv;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 rows x 4 columns
    float sc[4][kColsPerThread];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) kv[j] = ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[kColsPerThread];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ok[j] = kpos < len_b && (!causal || kpos <= qpos[i]) &&
                (window <= 0 || qpos[i] - kpos < window);
        sc[i][j] = ok[j] ? s : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * LP + tx + 8 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = vs[j * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * LP + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= n_rows) continue;
    const int s = r / G, g = r % G;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + (((size_t)b * S + s) * H + h * G + g) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[tx + 8 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lens, void* o,
                   int B, int S, int T_, int H, int K, int causal, int window,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int G = H / K;
  dim3 grid((S * G + kRows - 1) / kRows, K, B);
  const float scale = (float)(1.0 / std::sqrt((double)HD));  // hd ** -0.5
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lens, (T*)o, S, T_, H, K, causal, window,
      softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const int* lens,
                        void* o, int B, int S, int T_, int H, int K, int causal, int window,
                        float softcap, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, lens, o, B, S, T_, H, K, causal, window, softcap, st);
    case 32: return launch<T, 32>(q, k, v, lens, o, B, S, T_, H, K, causal, window, softcap, st);
    case 64: return launch<T, 64>(q, k, v, lens, o, B, S, T_, H, K, causal, window, softcap, st);
    case 128: return launch<T, 128>(q, k, v, lens, o, B, S, T_, H, K, causal, window, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B,S,H,hd), k/v (B,T,K,hd), o (B,S,H,hd): contiguous, all float32 (dtype 0)
// or all bfloat16 (dtype 1); lens (B,) int32 on the device. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int flash_attn_fwd(const void* q, const void* k, const void* v, const void* lens, void* o,
                   int B, int S, int T, int H, int K, int hd, int causal, int window,
                   float softcap, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* ln = (const int*)lens;
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(hd, q, k, v, ln, o, B, S, T, H, K, causal, window, softcap, st);
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(hd, q, k, v, ln, o, B, S, T, H, K, causal, window,
                                   softcap, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
