// Flash decode: one query token per row against the KV cache, written for Hopper
// (sm_90a) in plain CUDA C++.
//
// Replaces the TPU kernel `_decode_kernel` in src/repro/kernels/decode_attn/decode.py
// (entry `flash_decode`). Same function: q (B,H,hd) against k, v (B,S,K,hd) with
// GQA (G = H/K query heads per kv head), keys [0, pos] valid, optional logit
// softcap, online softmax in f32, output (B,H,hd) f32. One difference: `pos` is
// per row (B,) int32, because the serving engine decodes its slots at different
// positions; the TPU kernel's scalar `pos` is the case of all rows equal. A row with
// no valid key outputs 0 (max(l, 1e-30)).
//
// Bound on this card: memory. The work reads K+V up to pos (2*hd*2 bytes per key per
// kv head in bf16, 2*hd*4 in f32) and does 4*G*hd FLOPs per key, about G FLOPs per
// byte in bf16, far below the ~20 FLOPs per byte where the f32 CUDA cores would bound
// it; the least time is (K+V bytes up to pos) / 3.35 TB/s.
//
// What held the first design (one 8-warp block per (kv head, row), each warp walking
// keys 4 at a time with 8-byte lane loads) back: 128 blocks on 132 SMs at the main
// shape (B=4, K=32, S=1024); the block of the row at pos 1023 streaming 512 KB alone
// with ~16 KB in flight while the short rows' SMs sat idle; 5x its bytes bound and
// slower than SDPA, which reads the whole masked cache. The design now is the split-S
// one of csrc/decode_split.cuh, shared with the int8 kernel of csrc/decode_int8.cu: a
// (K, B, ceil(S/chunk)) grid whose blocks past pos exit at once, q loaded first, the
// chunk's K/V rows by 16-byte cp.async into padded shared rows (2 * 128 * (256 + 16)
// bytes, 68 KB, for the 128-key bf16 chunk the plan takes at hd 128 and the main
// shape), warps on 16-key tiles as they land, and a long row's chunks merged in the
// same launch by the block that draws the last ticket. What is this kernel's own:
//   - bf16 becomes f32 by a 16-bit shift (or a mask, for the high half of a word); f32
//     is read as it is.
//   - A row is 2 or 4 times as wide as an int8 one (256 or 512 bytes at hd 128), so
//     the wrapper's plan (kernels/decode_attn/ops.py::chunk_plan) lets a grid hold
//     proportionally fewer blocks per SM before it doubles the chunk (the main shape
//     takes 128-key chunks: 480 working blocks of 8 warps, 3 a SM by shared memory),
//     and caps the chunk so a block stays within the card's 227 KB; the launch
//     raises the kernel's dynamic shared-memory limit to what the chunk takes.
// On one NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's device window): 20.0-20.3
// us of device time at the main shape (B=4, S=1024, H=K=32, hd 128, pos 1023, 600,
// 31, 0), against an 8.14 us bytes bound and 38.7-39.0 us for
// scaled_dot_product_attention on the same inputs; 41.0 us before this design.

#include "decode_split.cuh"

namespace {

using namespace decode_split;

struct F32Cache {
  using E = float;
  static constexpr bool kScaled = false;

  __device__ static __forceinline__ void piece(const int4& w, float (&f)[4]) {
    f[0] = __int_as_float(w.x);
    f[1] = __int_as_float(w.y);
    f[2] = __int_as_float(w.z);
    f[3] = __int_as_float(w.w);
  }

  template <int N>
  __device__ static __forceinline__ void elems(const uint8_t* p, float (&f)[N]) {
    if constexpr (N == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
    } else if constexpr (N == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      f[0] = v.x, f[1] = v.y;
    } else {
      f[0] = *reinterpret_cast<const float*>(p);
    }
  }
};

// bf16 element 2i of a 32-bit word is its low half, 2i+1 its high half
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

struct Bf16Cache {
  using E = __nv_bfloat16;
  static constexpr bool kScaled = false;

  __device__ static __forceinline__ void piece(const int4& w, float (&f)[8]) {
    const uint32_t words[4] = {(uint32_t)w.x, (uint32_t)w.y, (uint32_t)w.z,
                               (uint32_t)w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf_lo(words[i]);
      f[2 * i + 1] = bf_hi(words[i]);
    }
  }

  template <int N>
  __device__ static __forceinline__ void elems(const uint8_t* p, float (&f)[N]) {
    if constexpr (N == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      f[0] = bf_lo(v.x), f[1] = bf_hi(v.x), f[2] = bf_lo(v.y), f[3] = bf_hi(v.y);
    } else if constexpr (N == 2) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
      f[0] = bf_lo(v), f[1] = bf_hi(v);
    } else {
      f[0] = bf_lo(*reinterpret_cast<const uint16_t*>(p));
    }
  }
};

// the cache has the query's type
template <typename T>
struct CacheOf {
  using type = F32Cache;
};
template <>
struct CacheOf<__nv_bfloat16> {
  using type = Bf16Cache;
};

// MAXG bounds the group size G = H/K held in registers; G itself is a runtime value.
// Blocks of 4 or 8 warps; at most 64 registers a thread (128 from G 3 on).
template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(kMaxThreads, MAXG <= 2 ? 4 : 2)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ pos, float* __restrict__ o,
              float* __restrict__ part, int* __restrict__ ticket, int S, int H, int K,
              int chunk, float softcap, float scale) {
  split_decode<typename CacheOf<T>::type, T, HD, MAXG>(
      q, k, nullptr, v, nullptr, pos, o, part, ticket, S, H, K, chunk, softcap, scale);
}

template <typename T, int HD, int MAXG>
struct FpKernel {
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static cudaError_t set_smem(int bytes) {
    return cudaFuncSetAttribute(decode_kernel<T, HD, MAXG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  static void launch(dim3 grid, int threads, size_t smem, cudaStream_t st,
                     const Args& a, float scale) {
    decode_kernel<T, HD, MAXG><<<grid, threads, smem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.pos, a.o, a.part, a.ticket, a.S,
        a.H, a.K, a.chunk, a.softcap, scale);
  }
};

}  // namespace

extern "C" {

// q (B,H,hd), k/v (B,S,K,hd): contiguous, all float32 (dtype 0) or all bfloat16
// (dtype 1), k and v at 16-byte aligned addresses; pos (B,) int32; o (B,H,hd)
// float32. `chunk` (64, 128, 192 or 256) keys per block; `part` an f32 scratch of
// B*K*ceil(S/chunk)*G*(hd+4) floats (unused, may be null, when S <= chunk); `ticket`
// B*K int32 counters that are 0 on entry and are left 0. All on the device. Launches
// on `stream` and returns cudaGetLastError() (0 = launched).
int decode_attn_fwd(const void* q, const void* k, const void* v, const void* pos, void* o,
                    void* part, void* ticket, int B, int S, int H, int K, int hd,
                    int chunk, float softcap, int dtype, void* stream) {
  const Args a{q,     k,      nullptr,        v,      nullptr, (const int*)pos,
               (float*)o, (float*)part, (int*)ticket, B, S, H, K, chunk, softcap};
  return (int)dispatch<FpKernel>(dtype, hd, a, (cudaStream_t)stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
