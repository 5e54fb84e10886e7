// Flash decode: one query token per row against the KV cache, written for
// Hopper (sm_90a) in plain CUDA C++.
//
// Replaces the TPU kernel `_decode_kernel` in src/repro/kernels/decode_attn/decode.py
// (entry `flash_decode`). Same function: q (B,H,hd) against k, v (B,S,K,hd) with
// GQA (G = H/K query heads per kv head), keys [0, pos] valid, optional logit
// softcap, online softmax in f32, output (B,H,hd) f32. One difference: `pos` is
// per row (B,) int32, because the serving engine decodes its slots at different
// positions; the TPU kernel's scalar `pos` is the case of all rows equal.
//
// Design. One thread block of 8 warps per (kv head, batch row). Each warp walks
// the keys j = 4*warp, 4*warp+1, ... in groups of 4 (stride 32): the lanes of a
// warp split head_dim (lane l holds elements l*EPL .. of q, k and v, EPL =
// max(hd/32, 1); at hd = 16 half the lanes hold nothing), so one
// key row is one coalesced load per warp; the 4 K rows and 4 V rows of a group
// are loaded together to keep loads in flight. A dot product is reduced over
// the lanes with shuffles; every warp keeps its own (m, l, acc) for the G query
// heads, and the 8 partial states are merged through shared memory at the end.
// Only keys [0, pos[b]] are read.
//
// Bound on this card: memory. The work reads K+V up to pos (2*hd bytes per key
// per kv head in bf16) and does 4*G*hd FLOPs per key, about G FLOPs per byte,
// far below the ~295 FLOPs per byte where the tensor cores would bound it; the
// least time is (K+V bytes up to pos) / 3.35 TB/s. Left for later: at B = 4 and
// K = 32 the grid has 128 blocks for 132 SMs and each block walks its whole
// row, so a long row is latency-bound; a split-S pass (several blocks per row,
// merged by a second small kernel) would put more loads in flight.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // keys per warp iteration
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// MAXG bounds the group size G = H/K held in registers; G itself is a runtime value
template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ pos, float* __restrict__ o, int S, int H, int K,
              float softcap, float scale) {
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;  // head_dim elements per lane
  __shared__ float m_s[kWarps][MAXG];
  __shared__ float l_s[kWarps][MAXG];
  __shared__ float acc_s[kWarps][MAXG][HD];

  const int G = H / K;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = min(pos[b], S - 1);  // keys [0, last] are valid
  const bool holds = lane * EPL < HD;   // false only for the idle lanes at hd < 32

  float qr[MAXG][EPL], m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < G && holds
                     ? to_f(q[((size_t)b * H + h * G + g) * HD + lane * EPL + e])
                     : 0.f;
    }
  }

  const size_t row_stride = (size_t)K * HD;  // between consecutive positions
  const size_t lane_off = holds ? lane * EPL : 0;
  const T* kb = k + ((size_t)b * S * K + h) * HD + lane_off;
  const T* vb = v + ((size_t)b * S * K + h) * HD + lane_off;

  for (int j0 = warp * kUnroll; j0 <= last; j0 += kWarps * kUnroll) {
    float kk[kUnroll][EPL], vv[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kk[u][e] = j <= last && holds ? to_f(kb[j * row_stride + e]) : 0.f;
        vv[u][e] = j <= last && holds ? to_f(vb[j * row_stride + e]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s[kUnroll];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kk[u][e], part);
        float sv = warp_sum(part) * scale;
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        s[u] = j0 + u <= last ? sv : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = j0 + u <= last ? expf(s[u] - m_new) : 0.f;
        rs += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vv[u][e], acc[g][e]);
      }
      l[g] = l[g] * alpha + rs;
      m[g] = m_new;
    }
  }

  // merge the 8 warps' partial softmax states
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (holds) acc_s[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(m_s[w][g] - mx);
      lsum += l_s[w][g] * a;
      out += acc_s[w][g][d] * a;
    }
    o[((size_t)b * H + h * G + g) * HD + d] = out / fmaxf(lsum, 1e-30f);
  }
}

template <typename T, int HD, int MAXG>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, float* o,
                   int B, int S, int H, int K, float softcap, cudaStream_t stream) {
  const float scale = (float)(1.0 / std::sqrt((double)HD));  // hd ** -0.5
  decode_kernel<T, HD, MAXG><<<dim3(K, B), kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, pos, o, S, H, K, softcap, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v, const int* pos,
                       float* o, int B, int S, int H, int K, float softcap, cudaStream_t st) {
  if (G <= 1) return launch<T, HD, 1>(q, k, v, pos, o, B, S, H, K, softcap, st);
  if (G <= 2) return launch<T, HD, 2>(q, k, v, pos, o, B, S, H, K, softcap, st);
  if (G <= 4) return launch<T, HD, 4>(q, k, v, pos, o, B, S, H, K, softcap, st);
  if (G <= 8) return launch<T, HD, 8>(q, k, v, pos, o, B, S, H, K, softcap, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(int hd, int G, const void* q, const void* k, const void* v,
                        const int* pos, float* o, int B, int S, int H, int K, float softcap,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(G, q, k, v, pos, o, B, S, H, K, softcap, st);
    case 32: return dispatch_g<T, 32>(G, q, k, v, pos, o, B, S, H, K, softcap, st);
    case 64: return dispatch_g<T, 64>(G, q, k, v, pos, o, B, S, H, K, softcap, st);
    case 128: return dispatch_g<T, 128>(G, q, k, v, pos, o, B, S, H, K, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B,H,hd), k/v (B,S,K,hd): contiguous, all float32 (dtype 0) or all bfloat16
// (dtype 1); pos (B,) int32 on the device; o (B,H,hd) float32. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int decode_attn_fwd(const void* q, const void* k, const void* v, const void* pos, void* o,
                    int B, int S, int H, int K, int hd, float softcap, int dtype,
                    void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int G = H / K;
  const int* p = (const int*)pos;
  float* out = (float*)o;
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(hd, G, q, k, v, p, out, B, S, H, K, softcap, st);
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(hd, G, q, k, v, p, out, B, S, H, K, softcap, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
