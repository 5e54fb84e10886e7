// Split-S flash decode for Hopper (sm_90a), shared by the two decode kernels:
// csrc/decode.cu (an f32 or bf16 KV cache) and csrc/decode_int8.cu (an int8 KV
// cache with fp16 scales per (token, kv head)). A header, not a source: each of the
// two sources defines its own `__global__` around `split_decode` and its own C entry.
//
// The function: q (B,H,hd) against K/V (B,S,K,hd) with GQA (G = H/K query heads per
// kv head), keys [0, pos[b]] valid, optional logit softcap, online softmax in f32,
// output (B,H,hd) f32. A row with no valid key outputs 0 (max(l, 1e-30)).
//
// The design (measured in csrc/decode_int8.cu first, then shared):
//   - Block (h, b, c) of a (K, B, ceil(S/chunk)) grid takes keys [c*chunk,
//     (c+1)*chunk) of kv head h in row b; the wrapper picks `chunk`
//     (kernels/decode_attn/ops.py::chunk_plan) and passes it. A block whose chunk
//     starts past pos[b] exits at once, so the long rows get many blocks and the short
//     ones one. The chunk index is the grid's slowest, so every row's first chunks
//     are dispatched before any row's later ones.
//   - Loads, in the order they are needed: q (issued with pos, whose value it does
//     not wait for) and, for a scaled cache, the lane's fp16 scales (which lie K
//     apart in the cache) into registers first, then the chunk's K and V rows by
//     16-byte `cp.async` copies into shared memory, all in flight together. Rows are
//     padded by 16 bytes in shared memory so 16-byte reads of consecutive keys fall
//     in distinct banks.
//   - Warps work alone: 4 a block at 64-key chunks, 8 from 128 keys on, so that a
//     warp holds one or two 16-key tiles. Each takes its share of the chunk, one
//     cp.async group per tile, and starts on a tile as soon as it has landed: scores
//     (2 lanes per key, q from shared memory), an online softmax in registers, then
//     P.V with each lane owning hd/32 output elements and each key's p (times its
//     value scale) broadcast from the lane that holds it. The cache type's trait
//     (`C` below) turns a 16-byte piece of a row, or a lane's P.V elements, into f32.
//     The warps' states merge once, through shared memory.
//   - Groups of up to 16 query heads (gemma-2b: 16 over one kv head at hd 256). A
//     warp holds the online-softmax state of at most 8 heads in registers, so a
//     larger group is walked in passes of 8 heads over the same tiles, which stay in
//     shared memory; the K/V rows are read from device memory once.
//   - Merge in the same launch. A row with one chunk writes its output at once. For
//     longer rows each block writes its (acc, m, l) to an f32 scratch record; thread 0
//     fences (`__threadfence`) and takes a ticket (`atomicAdd` on the (row, kv head)
//     counter); the block that draws the last ticket resets the counter to 0 for the
//     next call and merges the records 8 at a time (every load of a batch issued
//     before any is used): m = max m_i, l = sum l_i e^(m_i - m), o = sum acc_i
//     e^(m_i - m) / max(l, 1e-30). The wrapper allocates the scratch per call
//     (torch.empty) and keeps the counters, zeroed once, per device.
//   - Or merge in a second kernel, when a (row, kv head)'s records could pass 12 KB
//     (`merge_apart`: gemma2-27b's decode, 16-20 records of 2 x 132 floats; gemma-2b's,
//     64 of 16 x 260 for a 4096-key row). In the same launch one block reads them all
//     alone, one batch of loads after another; `merge_kernel` instead gives each
//     (row, kv head, 128 output elements) a block of its own, in the same merge
//     order, and the split kernel takes no ticket. The second launch costs ~1 us of
//     gap, so small records (deepseek-7b's 4-8 KB) still merge in the launch. Measured
//     by scripts/torch_decode_merge.py (H100): the in-launch merge ~1 us faster at 4.2
//     and 8.4 KB, 1-3 us slower at 16.9-33.8 KB, 3.3x slower at gemma-2b's 1 MB.
// Measured at the main decode shape and not kept: persistent blocks walking the work
// items, with every row's pos read once into shared memory (slower in both kernels);
// K and V of a tile in two cp.async groups, so the scores start before V lands, and
// a 4-deep unrolled P.V loop (neither moved beyond the spread).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace decode_split {

constexpr int kWarps = 4;      // warps a block has at 64-key chunks; 8 at 128 and up
constexpr int kMaxThreads = 8 * 32;
constexpr int kPad = 16;       // bytes after each shared K/V row
constexpr int kMaxGroup = 16;  // query heads per kv head
constexpr int kPassHeads = 8;  // query heads a warp holds in registers at a time
constexpr int kTile = 16;      // keys per warp tile
constexpr int kMinChunk = kWarps * kTile;
constexpr int kMaxChunk = 256;
constexpr int kMaxTiles = kMaxChunk / kWarps / kTile;  // tiles per warp, at most
constexpr int kMergeBatch = 8;  // records whose loads a merge issues together
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// at most n of this thread's cp.async groups still in flight (n clamped to 0 .. 3)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

// the warps a block of a `chunk`-key chunk has: one 16-key tile a warp at a time, 4
// warps at 64-key chunks and 8 from 128 keys on
__host__ __device__ constexpr int chunk_warps(int chunk) { return chunk % 128 ? 4 : 8; }

// the kernels' `__launch_bounds__` minimum of blocks an SM (of 8 warps): 4 up to G 2
// below hd 256 (64 registers a thread), 2 beyond (128), and 1 (255) where a pass's
// accumulators alone are 64 floats a lane (hd 256 at 8 heads a pass), which 128
// would spill
__host__ __device__ constexpr int min_blocks(int HD, int MAXG) {
  return MAXG <= 2 && HD < 256 ? 4
         : HD * (MAXG < kPassHeads ? MAXG : kPassHeads) > 1024 ? 1 : 2;
}

// bytes of dynamic shared memory one block takes (the layout in split_decode), for
// K/V rows of `row_bytes` (kernels/decode_attn/ops.py::smem_bytes is the same sum)
__host__ __device__ constexpr size_t smem_bytes(int row_bytes, int hd, int G, int chunk) {
  return (size_t)2 * chunk * (row_bytes + kPad) +  // K, V rows
         sizeof(float) * ((size_t)G * hd + (size_t)chunk_warps(chunk) * G * (hd + 2));
}

// ---- the merge machinery --------------------------------------------------------
// A record holds one block's state for the G query heads of its (row, kv head):
// acc [G][hd], then m [G], then l [G]: G * (hd + 4) floats with the padding, so
// records stay 16-byte aligned. Records of one (row, kv head) lie one after another,
// one per chunk of the grid.
__host__ __device__ __forceinline__ int record_len(int G, int hd) { return G * (hd + 4); }

// Thread 0 publishes this block's record and draws a ticket for (row, kv head); true
// in every thread of the block that drew the last of `nsplit`, which also resets the
// counter to 0 for the next launch.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int nsplit) {
  __shared__ int is_last;
  __syncthreads();  // every thread's record writes precede thread 0's release
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(ticket, 1) == nsplit - 1;
    if (is_last) {
      *ticket = 0;  // every block of the row has drawn: reset for the next call
      __threadfence();
    }
  }
  __syncthreads();
  return is_last;
}

// records of one (row, kv head) past which the merge runs as a kernel of its own:
// between the 8.4 KB where the in-launch merge was faster and the 16.9 KB where it was
// slower (a build may set it: scripts/torch_decode_merge.py times both merges)
#ifndef DECODE_MERGE_IN_LAUNCH_BYTES
#define DECODE_MERGE_IN_LAUNCH_BYTES (12 * 1024)
#endif
constexpr size_t kMergeInLaunchBytes = DECODE_MERGE_IN_LAUNCH_BYTES;

// Element idx (= g * hd + d) of the merged output from the `nsplit` records at
// `recs`, read through L2 (other blocks wrote them) kMergeBatch at a time, every load
// of a batch issued before any is used; an online merge across batches.
__device__ __forceinline__ float merge_records(const float* recs, int nsplit, int rec_len,
                                               int G, int hd, int idx) {
  const int g = idx / hd;
  float mx = kNegInf, lsum = 0.f, a = 0.f;
  for (int r0 = 0; r0 < nsplit; r0 += kMergeBatch) {
    float mv[kMergeBatch], lv[kMergeBatch], av[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const bool in = r0 + u < nsplit;
      const float* rr = recs + (size_t)(in ? r0 + u : 0) * rec_len;
      mv[u] = in ? __ldcg(rr + G * hd + g) : kNegInf;
      lv[u] = in ? __ldcg(rr + G * hd + G + g) : 0.f;
      av[u] = in ? __ldcg(rr + idx) : 0.f;
    }
    float m_new = mx;
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) m_new = fmaxf(m_new, mv[u]);
    const float f = expf(mx - m_new);
    lsum *= f;
    a *= f;
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const float w = expf(mv[u] - m_new);
      lsum = fmaf(lv[u], w, lsum);
      a = fmaf(av[u], w, a);
    }
    mx = m_new;
  }
  return a / fmaxf(lsum, 1e-30f);
}

// ---- the block ----------------------------------------------------------------------
// C, the cache's element trait:
//   using E;                       the stored element type
//   static constexpr bool kScaled; one fp16 scale per (token, kv head) on K and on V
//   static void piece(int4 w, float (&f)[16 / sizeof(E)]);  16 bytes of a row -> f32
//   template <int N> static void elems(const uint8_t* p, float (&f)[N]);  N (1, 2, 4
//                                  or 8: hd / 32) consecutive elements -> f32
// MAXG bounds the group size G = H/K; G itself is a runtime value, and so is the
// block's warp count (chunk_warps(chunk)). A warp holds min(MAXG, 8) heads' state in
// registers and walks a group of more in passes of 8.
template <class C, typename T, int HD, int MAXG>
__device__ __forceinline__ void split_decode(
    const T* __restrict__ q, const typename C::E* __restrict__ kc,
    const __half* __restrict__ ks, const typename C::E* __restrict__ vc,
    const __half* __restrict__ vs, const int* __restrict__ pos, float* __restrict__ o,
    float* __restrict__ part, int* __restrict__ ticket, int S, int H, int K, int chunk,
    int merge_apart, float softcap, float scale) {
  using E = typename C::E;
  constexpr int RB = HD * (int)sizeof(E);      // bytes of one K or V row
  constexpr int LDS = RB + kPad;               // shared row stride, bytes
  constexpr int CPR = RB / 16;                 // 16-byte pieces per row
  constexpr int EPP = 16 / (int)sizeof(E);     // elements per piece
  constexpr int TPK = CPR >= 2 ? 2 : 1;        // lanes per key in the scores
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;  // output elements per lane in P.V
  const int NT = blockDim.x, W = NT / 32;      // threads and warps a block
  const int G = H / K;
  const int h = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  // q first, in flight with pos: its address does not depend on pos
  constexpr int QPT = (MAXG * HD + 127) / 128;  // q elements per thread, at most
  const T* qb = q + ((size_t)b * H + (size_t)h * G) * HD;  // the group's G query rows
  float qr[QPT];
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = threadIdx.x + r * NT;
    qr[r] = i < G * HD ? to_f(qb[i]) : 0.f;
  }
  const int last = min(pos[b], S - 1);  // keys [0, last] are valid
  const int nsplit = last < 0 ? 1 : last / chunk + 1;
  if (c >= nsplit) return;  // the chunk starts past pos[b]
  const int j0 = c * chunk;
  const int nk = last < 0 ? 0 : min(chunk, last + 1 - j0);  // valid keys of this chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sK = smem;                                              // [chunk][LDS]
  uint8_t* sV = sK + (size_t)chunk * LDS;                          // [chunk][LDS]
  float* sq = reinterpret_cast<float*>(sV + (size_t)chunk * LDS);  // [G][HD]
  float* wacc = sq + G * HD;                                       // [warp][G][HD]
  float* wm = wacc + W * G * HD;                                   // [warp][G]
  float* wl = wm + W * G;                                          // [warp][G]

  // ---- loads, in the order they are needed: (q above,) this lane's scales into
  // registers, then the K/V rows. Warp w takes keys [w*chunk/W, (w+1)*chunk/W) of the
  // chunk in tiles of 16; every tile's rows are issued at once, one cp.async group per
  // tile.
  const size_t row = (size_t)K * RB;  // bytes between consecutive positions
  const size_t base = (((size_t)b * S + j0) * K + h) * RB;
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(kc) + base;
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(vc) + base;
  const int per_warp = chunk / W;
  const int kw0 = warp * per_warp;
  const int nkw = max(0, min(per_warp, nk - kw0));  // this warp's valid keys
  const int ntiles = (nkw + kTile - 1) / kTile;
  const int kk = lane / TPK, sub = lane % TPK;  // this lane's key in each tile
  float ksc[kMaxTiles], vsc[kMaxTiles];
  if constexpr (C::kScaled) {
    const size_t sbase = ((size_t)b * S + j0) * K + h;  // scale of key j at sbase + j*K
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {
      const int j = kw0 + i * kTile + kk;
      const bool in = kk < kTile && i * kTile + kk < nkw;
      ksc[i] = in ? __half2float(ks[sbase + (size_t)j * K]) : 0.f;
      vsc[i] = in ? __half2float(vs[sbase + (size_t)j * K]) : 0.f;
    }
  }
  for (int i = 0; i < ntiles; ++i) {
    const int t0 = kw0 + i * kTile, nt = min(kTile, nkw - i * kTile);
    for (int e = lane; e < nt * CPR; e += 32) {
      const int j = t0 + e / CPR, p = (e % CPR) * 16;
      cp_async16(sK + j * LDS + p, kb + j * row + p);
      cp_async16(sV + j * LDS + p, vb + j * row + p);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = threadIdx.x + r * NT;
    if (i < G * HD) sq[i] = qr[r];
  }
  __syncthreads();  // q is in shared memory

  // ---- each warp: its tiles as they land, with an online softmax in registers;
  // heads g0 .. g0+GP-1 of the group in each pass (one pass unless G > 8)
  constexpr int GP = MAXG < kPassHeads ? MAXG : kPassHeads;
  constexpr int PASSES = (MAXG + GP - 1) / GP;
  const int d0 = lane * EPL;   // this lane's output elements in P.V
  const bool holds = d0 < HD;  // false only for the idle lanes at hd 16
#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    const int g0 = pass * GP;
    if (g0 >= G) break;
    const int gn = min(GP, G - g0);  // heads of this pass
    float m[GP], l[GP], acc[GP][EPL];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {
      if (i >= ntiles) break;
      cp_async_wait_upto(ntiles - 1 - i);  // tile i has landed (this lane's copies)
      __syncwarp();                         // ... and every lane's
      const int t0 = kw0 + i * kTile, nt = min(kTile, nkw - i * kTile);
      const bool valid = kk < nt;
      // scores: TPK lanes per key, each taking every TPK-th 16-byte piece
      float dot[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) dot[g] = 0.f;
      if (valid) {
        const uint8_t* kr = sK + (t0 + kk) * LDS;
#pragma unroll
        for (int pp = 0; pp < CPR / TPK; ++pp) {
          const int p = pp * TPK + sub;
          float kf[EPP];
          C::piece(*reinterpret_cast<const int4*>(kr + p * 16), kf);
#pragma unroll
          for (int g = 0; g < GP; ++g) {
            if (g >= gn) break;
            const float4* q4 = reinterpret_cast<const float4*>(sq + (g0 + g) * HD + p * EPP);
#pragma unroll
            for (int e = 0; e < EPP / 4; ++e) {
              const float4 qv = q4[e];
              dot[g] = fmaf(qv.x, kf[4 * e], dot[g]);
              dot[g] = fmaf(qv.y, kf[4 * e + 1], dot[g]);
              dot[g] = fmaf(qv.z, kf[4 * e + 2], dot[g]);
              dot[g] = fmaf(qv.w, kf[4 * e + 3], dot[g]);
            }
          }
        }
      }
      // the tile's softmax, folded into the running state; pv = p (times the value
      // scale) of this lane's key
      float pv[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g >= gn) break;
        float d = dot[g];
        if (TPK == 2) d += __shfl_xor_sync(0xffffffffu, d, 1);
        if constexpr (C::kScaled) d *= ksc[i];
        float s = d * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        s = valid ? s : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(s));
        const float alpha = expf(m[g] - m_new);
        const float p = valid ? expf(s - m_new) : 0.f;
        l[g] = l[g] * alpha + warp_sum(sub == 0 ? p : 0.f);
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
        pv[g] = p;
        if constexpr (C::kScaled) pv[g] *= vsc[i];
      }
      // P.V: every key of the tile, its pv broadcast from the lane holding it
      for (int key = 0; key < nt; ++key) {
        float vf[EPL];
        if (holds) {
          C::template elems<EPL>(sV + (t0 + key) * LDS + d0 * (int)sizeof(E), vf);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) vf[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          if (g >= gn) break;
          const float pg = __shfl_sync(0xffffffffu, pv[g], key * TPK);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
        }
      }
    }

    // this pass's heads' state, for the merge of the W warps below
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g >= gn) break;
      if (lane == 0) {
        wm[warp * G + g0 + g] = m[g];
        wl[warp * G + g0 + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        if (holds) wacc[(warp * G + g0 + g) * HD + d0 + e] = acc[g][e];
    }
  }  // passes

  // ---- the W warps' states merge through shared memory into the block's (m, l, acc)
  __syncthreads();
  const int rec_len = record_len(G, HD);
  const size_t rows_base = ((size_t)b * K + h) * gridDim.z;
  float* rec = nsplit > 1 ? part + (rows_base + c) * rec_len : nullptr;
  float* ob = o + ((size_t)b * H + (size_t)h * G) * HD;
  for (int idx = threadIdx.x; idx < G * HD; idx += NT) {
    const int g = idx / HD;
    float mx = kNegInf;
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < W; ++w) {
      const float f = expf(wm[w * G + g] - mx);
      lsum = fmaf(wl[w * G + g], f, lsum);
      a = fmaf(wacc[w * G * HD + idx], f, a);
    }
    if (nsplit == 1) {  // the row's only chunk: its output, directly
      ob[idx] = a / fmaxf(lsum, 1e-30f);
    } else {
      rec[idx] = a;
      if (idx % HD == 0) {
        rec[G * HD + g] = mx;
        rec[G * HD + G + g] = lsum;
      }
    }
  }
  if (nsplit == 1 || merge_apart) return;  // merge_kernel merges the records

  // ---- the block that arrives last for (row, kv head) merges the records
  if (!last_to_arrive(ticket + (size_t)b * K + h, nsplit)) return;
  const float* recs = part + rows_base * rec_len;
  for (int idx = threadIdx.x; idx < G * HD; idx += NT)
    ob[idx] = merge_records(recs, nsplit, rec_len, G, HD, idx);
}

// The merge as a kernel of its own (after a split launch with merge_apart): block
// (x, b * K + h) merges output elements [128 x, 128 x + 128) of (row b, kv head h)
// from its records, when the row took more than one chunk.
__global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ part, const int* __restrict__ pos,
             float* __restrict__ o, int S, int H, int K, int hd, int chunk, int n_chunks) {
  const int G = H / K;
  const int bh = blockIdx.y, b = bh / K, h = bh % K;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int last = min(pos[b], S - 1);
  const int nsplit = last < 0 ? 1 : last / chunk + 1;
  if (idx >= G * hd || nsplit == 1) return;  // one chunk: the split kernel wrote it
  const int rec_len = record_len(G, hd);
  o[((size_t)b * H + (size_t)h * G) * hd + idx] =
      merge_records(part + (size_t)bh * n_chunks * rec_len, nsplit, rec_len, G, hd, idx);
}

// ---- the host side ------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const __half* ks;  // null for an unscaled cache
  const void* v;
  const __half* vs;
  const int* pos;
  float* o;
  float* part;
  int* ticket;
  int B, S, H, K, chunk;
  float softcap;
};

// The C entries' shared argument rule: 16-byte aligned K/V bases, a chunk of 64 to
// 256 keys in steps of 64, and the scratch and counters when a row may take more
// than one chunk.
inline bool args_ok(const Args& a) {
  return a.B > 0 && a.S > 0 && a.K > 0 && a.H % a.K == 0 && a.H / a.K <= kMaxGroup &&
         a.chunk >= kMinChunk && a.chunk <= kMaxChunk && a.chunk % kMinChunk == 0 &&
         (a.S <= a.chunk || (a.part && a.ticket)) &&
         ((uintptr_t)a.k | (uintptr_t)a.v) % 16 == 0;
}

// Launch the (K, B, ceil(S/chunk)) grid of KERNEL<T, HD, MAXG> (a class template
// with `static constexpr int kRowBytes`, `set_smem(bytes)` and `launch(grid, threads,
// smem, stream, args, merge_apart, scale)`) on blocks of chunk_warps(chunk) warps,
// first raising its dynamic shared-memory limit to what this chunk takes if an
// earlier launch set less; then, when a (row, kv head)'s records could pass
// kMergeInLaunchBytes, merge_kernel.
template <template <typename, int, int> class KERNEL, typename T, int HD, int MAXG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Kern = KERNEL<T, HD, MAXG>;
  static size_t configured = 0;
  const size_t smem = smem_bytes(Kern::kRowBytes, HD, a.H / a.K, a.chunk);
  if (smem > configured) {
    cudaError_t e = Kern::set_smem((int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const float scale = (float)(1.0 / std::sqrt((double)HD));  // hd ** -0.5
  const int G = a.H / a.K, n_chunks = (a.S + a.chunk - 1) / a.chunk;
  const bool apart = n_chunks > 1 &&
      (size_t)n_chunks * record_len(G, HD) * sizeof(float) > kMergeInLaunchBytes;
  // chunk slowest: every row's first chunks are dispatched before any row's later ones
  const dim3 grid(a.K, a.B, n_chunks);
  Kern::launch(grid, chunk_warps(a.chunk) * 32, smem, stream, a, apart, scale);
  if (apart) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    merge_kernel<<<dim3((G * HD + 127) / 128, a.B * a.K), 128, 0, stream>>>(
        a.part, a.pos, a.o, a.S, a.H, a.K, HD, a.chunk, n_chunks);
  }
  return cudaGetLastError();
}

template <template <typename, int, int> class KERNEL, typename T, int HD>
cudaError_t dispatch_g(const Args& a, cudaStream_t st) {
  const int G = a.H / a.K;
  if (G <= 1) return launch<KERNEL, T, HD, 1>(a, st);
  if (G <= 2) return launch<KERNEL, T, HD, 2>(a, st);
  if (G <= 4) return launch<KERNEL, T, HD, 4>(a, st);
  if (G <= 8) return launch<KERNEL, T, HD, 8>(a, st);
  if (G <= 16) return launch<KERNEL, T, HD, 16>(a, st);
  return cudaErrorInvalidValue;
}

// query type by `dtype` (0 float32, 1 bfloat16), then head_dim, then the group bound
template <template <typename, int, int> class KERNEL>
cudaError_t dispatch(int dtype, int hd, const Args& a, cudaStream_t st) {
  if (!args_ok(a)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (hd) {
      case 16: return dispatch_g<KERNEL, float, 16>(a, st);
      case 32: return dispatch_g<KERNEL, float, 32>(a, st);
      case 64: return dispatch_g<KERNEL, float, 64>(a, st);
      case 128: return dispatch_g<KERNEL, float, 128>(a, st);
      case 256: return dispatch_g<KERNEL, float, 256>(a, st);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return dispatch_g<KERNEL, __nv_bfloat16, 16>(a, st);
      case 32: return dispatch_g<KERNEL, __nv_bfloat16, 32>(a, st);
      case 64: return dispatch_g<KERNEL, __nv_bfloat16, 64>(a, st);
      case 128: return dispatch_g<KERNEL, __nv_bfloat16, 128>(a, st);
      case 256: return dispatch_g<KERNEL, __nv_bfloat16, 256>(a, st);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace decode_split
