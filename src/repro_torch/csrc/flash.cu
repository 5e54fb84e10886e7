// Flash attention for prefill, written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` in src/repro/kernels/flash_attn/flash.py
// (entry `flash_attention`, padded wrapper `ops.py::flash_attn`). Same function:
// q (B,S,H,hd) against k, v (B,T,K,hd) with GQA (G = H/K query heads share a kv
// head), causal or not, an optional sliding window, an optional logit softcap and
// a per-row valid key length `lens` (B,). Online softmax (m, l, acc) in f32; a row
// whose keys are all masked gives 0. Output (B,S,H,hd) in the input type.
//
// Rows. A "row" is one (query position, group head) pair: flattened row r = s*G + g,
// so all G heads that share a kv head are served by the same K/V tiles. A block
// owns one (batch, kv head, tile of rows) and loops over the kv tiles from the
// window's left edge to its last row's causal frontier and lens[b]; tiles past
// either are never loaded. The kernel masks the ragged S and T edges itself (the
// TPU wrapper pads to its block grid instead).
//
// Two kernels, chosen up front by shape in `dispatch_hd`:
//   - bf16 at hd 64 and 128, G dividing 128, 16-byte aligned tensors (the serving
//     path): `flash_fwd_kernel_tma`, on the tensor cores. 128 rows per block, three
//     warpgroups. Warpgroup 0 is the producer: one thread loads the Q tile once and
//     streams 128-key K/V tiles through a 2-stage ring, all by TMA into 128B-swizzled
//     shared memory (hd = 128 as two 64-column boxes), each stage completing on its
//     "full" mbarrier and freed on its "empty" one. Warpgroups 1 and 2 own 64 rows
//     each: S = Q K^T by `wgmma.m64n128k16` with both operands in shared memory; the
//     online softmax on the accumulator fragments in registers (a row lives in the 4
//     threads of a quad: two shuffles per reduction; masks only on tiles that cross
//     the lens, causal or window edge); P converted to bf16 in registers and used as
//     the register A operand of `wgmma.m64n{hd}k16` against V in shared memory with the
//     transpose bit (V is stored MN-major); O rescaled in registers; the epilogue
//     stages bf16 O in the block's own Q rows and stores 16-byte chunks. The row tiles
//     with the most keys launch first.
//     Where the numbers depart from the TPU kernel: that kernel casts q, k and v to
//     f32. Q K^T on bf16 inputs with f32 sums differs from it only in the order of the
//     sums (a product of two bf16 values is exact in f32). P is rounded to bf16 for the
//     P V product, where the TPU kernel keeps it in f32: a relative error up to 2^-9
//     per weight, inside the bf16 tolerance of 2e-2. The row sum l adds the f32 P.
//   - f32 at any hd, and bf16 at hd 16 and 32 or a G the TMA kernel does not take:
//     `flash_fwd_kernel` on the CUDA cores. 64 rows per block, 4 warps; Q and a
//     32-key K/V tile in shared memory as f32 (rows padded by one float), thread
//     (ty, tx) owns rows ty*4..+3 and output columns tx + 8*c, scores reduced across
//     the 8 column lanes of a row with warp shuffles. f32 stays off the tensor cores:
//     TF32 products would not reliably meet its 2e-3 tolerance.
//
// Bound on this card: at the main path's prefill shapes (S = T = 512, hd = 128,
// bf16) the work is 4*S*T*H*hd/2 FLOPs against Q+K+V+O bytes, about 180 FLOPs per
// byte, below the ~295 at which the bf16 tensor cores (989 TFLOP/s) bound it, so the
// least time is the bytes at 3.35 TB/s; with lens (512, 300, 77, 1) little work is
// left per block and the tile's latency (load, two products, softmax in series)
// bounds the kernel. Left for later: overlapping one tile's softmax with the next
// tile's products (two tiles in flight per warpgroup) and splitting long rows' key
// range across blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "hopper.cuh"

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

// ---- bf16, hd 64 and 128: TMA ring and wgmma ------------------------------------

constexpr int kFaRows = 128;        // flattened rows per block: 2 consumer warpgroups x 64
constexpr int kFaKeys = 128;        // keys per K/V tile
constexpr int kFaStages = 2;
constexpr int kFaThreads = 384;     // producer + 2 consumer warpgroups
constexpr int kBox = 128 * 128;     // one 64-column bf16 box of 128 rows, bytes
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
constexpr size_t tma_smem_bytes() {
  return 1024 + (size_t)(HD / 64) * kBox * (1 + 2 * kFaStages) +
         (2 * kFaStages + 1) * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_fwd_kernel_tma(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const int* __restrict__ lens,
                     __nv_bfloat16* __restrict__ o, int S, int T_, int H, int K, int causal,
                     int window, float softcap, float scale) {
  constexpr int HALVES = HD / 64;
  constexpr int TILE_BYTES = HALVES * kBox;   // one Q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // [half][row][128 B]
  uint8_t* sK = sQ + TILE_BYTES;                          // [stage][half][key][128 B]
  uint8_t* sV = sK + kFaStages * TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kFaStages * TILE_BYTES);
  uint64_t* empty = full + kFaStages;
  uint64_t* qbar = empty + kFaStages;

  const int G = H / K;
  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kFaRows;  // last row tiles (most keys) first
  const int n_rows = S * G;
  const int len_b = min(lens[b], T_);
  const int q_first = r0 / G;
  const int q_last = (min(r0 + kFaRows, n_rows) - 1) / G;
  int k_end = len_b;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q_first - window + 1) / kFaKeys) * kFaKeys;
  const int n_kv = k_end > k_begin ? (k_end - k_begin + kFaKeys - 1) / kFaKeys : 0;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFaStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);       // every consumer thread
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::setmaxnreg_dec<40>();
    if (tid == 0 && n_kv > 0) {
      hopper::mbar_arrive_expect_tx(qbar, TILE_BYTES);
      for (int hf = 0; hf < HALVES; ++hf)
        hopper::tma_load_5d(sQ + hf * kBox, &qmap, qbar, hf * 64, 0, h, q_first, b);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % kFaStages, k0 = k_begin + i * kFaKeys;
        hopper::mbar_wait(&empty[s], ((i / kFaStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        for (int hf = 0; hf < HALVES; ++hf) {
          hopper::tma_load_4d(sK + s * TILE_BYTES + hf * kBox, &kmap, &full[s], hf * 64, h, k0, b);
          hopper::tma_load_4d(sV + s * TILE_BYTES + hf * kBox, &vmap, &full[s], hf * 64, h, k0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns block rows c*64 .. c*64+63; this thread rows ra, ra + 8
  hopper::setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int ra = c * 64 + warp * 16 + lane / 4;
  const int qpos[2] = {(r0 + ra) / G, (r0 + ra + 8) / G};
  const float qk_scale = scale * kLog2e;      // scores in the log2 domain

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (n_kv > 0) hopper::mbar_wait(qbar, 0);

  for (int i = 0; i < n_kv; ++i) {
    const int s = i % kFaStages, k0 = k_begin + i * kFaKeys;
    hopper::mbar_wait(&full[s], (i / kFaStages) & 1);

    // S = Q K^T: 64 rows x 128 keys, f32
    float sc[kFaKeys / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int hf = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_bf16_ss_n128(
          sc, hopper::desc_sw128(sQ + hf * kBox + c * 64 * 128 + off, 16, 1024),
          hopper::desc_sw128(sK + s * TILE_BYTES + hf * kBox + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scale, softcap and mask; sc[4j + e] is row ra + 8*(e/2), key k0 + 8j + 2t + e%2
    const bool edge = k0 + kFaKeys > len_b || (causal && k0 + kFaKeys - 1 > q_first) ||
                      (window > 0 && q_last - k0 >= window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kFaKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        x = softcap > 0.f ? softcap * tanhf(x * scale / softcap) * kLog2e : x * qk_scale;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1), qp = qpos[e / 2];
          const bool ok = kpos < len_b && (!causal || kpos <= qp) &&
                          (window <= 0 || qp - kpos < window);
          if (!ok) x = -INFINITY;
        }
        sc[4 * j + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], base[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      base[rr] = m_new == -INFINITY ? 0.f : m_new;     // a row with no key yet
      alpha[rr] = exp2f(m[rr] - base[rr]);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
    // P = exp2(S - m) as the register A operand, 16 keys per k-step
    uint32_t pa[kFaKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kFaKeys / 8; ++j) {
      const float p0 = exp2f(sc[4 * j] - base[0]), p1 = exp2f(sc[4 * j + 1] - base[0]);
      const float p2 = exp2f(sc[4 * j + 2] - base[1]), p3 = exp2f(sc[4 * j + 3] - base[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P V; V (keys x hd) is MN-major: 8 keys to a 1024-byte group, hd halves kBox apart
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFaKeys / 16; ++kk) {
      const uint64_t dv = hopper::desc_sw128(sV + s * TILE_BYTES + kk * 16 * 128, kBox, 1024);
      if constexpr (HD == 128)
        hopper::wgmma_bf16_rs_n128(acc, pa[kk], dv, 1);
      else
        hopper::wgmma_bf16_rs_n64(acc, pa[kk], dv, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);
  }

  // epilogue: O / l in bf16, staged in this warpgroup's own (swizzled) Q rows
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    inv[rr] = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
  }
  hopper::named_sync(2 + c, 128);   // every product of this warpgroup has read its Q rows
  hopper::fence_proxy_async();
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t, hf = col / 64, chunk = (col % 64) / 8;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = ra + 8 * rr;
      uint8_t* p = sQ + hf * kBox + row * 128 + ((chunk ^ (row % 8)) * 16) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(p) =
          pack_bf16(acc[4 * j + 2 * rr] * inv[rr], acc[4 * j + 2 * rr + 1] * inv[rr]);
    }
  }
  hopper::named_sync(2 + c, 128);
  for (int idx = tid; idx < 64 * (HD / 8); idx += 128) {
    const int row = c * 64 + idx / (HD / 8), cc = idx % (HD / 8);
    const int r = r0 + row;
    if (r >= n_rows) continue;
    const int sq = r / G, g = r % G, hf = cc / 8, chunk = cc % 8;
    const uint4 v = *reinterpret_cast<const uint4*>(sQ + hf * kBox + row * 128 +
                                                    ((chunk ^ (row % 8)) * 16));
    *reinterpret_cast<uint4*>(o + (((size_t)b * S + sq) * H + h * G + g) * HD + cc * 8) = v;
  }
}

template <int HD>
cudaError_t launch_tma(const void* q, const void* k, const void* v, const int* lens, void* o,
                       int B, int S, int T_, int H, int K, int causal, int window,
                       float softcap, cudaStream_t stream) {
  constexpr size_t smem = tma_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel_tma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int G = H / K;
  const uint64_t e2 = sizeof(__nv_bfloat16);
  CUtensorMap qmap, kmap, vmap;
  // q as (B, S, K, G, hd): a box is G heads x 128/G positions = 128 flattened rows
  cudaError_t e = hopper::make_map<5>(
      &qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q,
      {(uint64_t)HD, (uint64_t)G, (uint64_t)K, (uint64_t)S, (uint64_t)B},
      {HD * e2, (uint64_t)G * HD * e2, (uint64_t)H * HD * e2, (uint64_t)S * H * HD * e2},
      {64u, (uint32_t)G, 1u, (uint32_t)(kFaRows / G), 1u});
  if (e != cudaSuccess) return e;
  const void* kv[2] = {k, v};
  CUtensorMap* maps[2] = {&kmap, &vmap};
  for (int i = 0; i < 2; ++i) {
    e = hopper::make_map<4>(maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kv[i],
                            {(uint64_t)HD, (uint64_t)K, (uint64_t)T_, (uint64_t)B},
                            {HD * e2, (uint64_t)K * HD * e2, (uint64_t)T_ * K * HD * e2},
                            {64u, 1u, (uint32_t)kFaKeys, 1u});
    if (e != cudaSuccess) return e;
  }
  dim3 grid(K, B, (S * G + kFaRows - 1) / kFaRows);
  const float scale = (float)(1.0 / std::sqrt((double)HD));  // hd ** -0.5
  flash_fwd_kernel_tma<HD><<<grid, kFaThreads, smem, stream>>>(
      qmap, kmap, vmap, lens, (__nv_bfloat16*)o, S, T_, H, K, causal, window, softcap, scale);
  return cudaGetLastError();
}

// the TMA kernel takes bf16 at hd 64 and 128 when G divides its 128-row tile and
// every tensor starts on 16 bytes
bool takes_tma(int hd, int G, const void* q, const void* k, const void* v, const void* o) {
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  return (hd == 64 || hd == 128) && G <= kFaRows && kFaRows % G == 0 && any % 16 == 0;
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const int* lens,
                        void* o, int B, int S, int T_, int H, int K, int causal, int window,
                        float softcap, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (takes_tma(hd, H / K, q, k, v, o)) {
      if (hd == 128)
        return launch_tma<128>(q, k, v, lens, o, B, S, T_, H, K, causal, window, softcap, st);
      return launch_tma<64>(q, k, v, lens, o, B, S, T_, H, K, causal, window, softcap, st);
    }
  }
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
