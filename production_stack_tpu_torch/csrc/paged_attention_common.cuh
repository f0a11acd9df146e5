// The CUDA-core walk of the float32 paged-attention kernels (K2, K3 and K4
// at the tiny presets): shared-memory layout, query staging, the walk over
// one sequence's paged context with an online softmax in float32. Only the
// float32 paths use the walk now; the bf16 kernels run on the tensor cores
// (mma_attention.cuh, split_decode.cuh). Every kernel also takes from here
// the head dims it is instantiated for (with_head_dim) and allow_smem.
//
// A CTA owns R query rows that all read the same KV head `kh`. Each row
// carries its own absolute query position (qpos, -1 = not attending in the
// current walk) and its own flash state (m, l, acc). The walk stages
// kTileK context positions at a time: K and V rows of head kh are gathered
// through the block table into shared memory as float, scores for all
// R x kTileK pairs are formed, one warp per row updates the softmax state
// (one lane per staged position), and the probabilities are applied to V.
//
// Invariants kept from the TPU kernels (ragged_paged_attention_pallas.py):
//  - positions at or past `reach` are never read from the pool: their K/V
//    rows are staged as zeros, so unwritten (possibly NaN) blocks never
//    reach the accumulator (0 * NaN = NaN);
//  - masked probabilities are set to exactly 0, not left to exp underflow;
//  - a row that attends nothing keeps l = 0 and acc = 0, so it outputs 0.
// Masking follows context lengths only, never the block table's contents:
// tables are padded with block 0, which is a real block.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace pstt {

// Calls f(std::integral_constant<int, D>{}) for the head dims the kernels
// are built for, every head dim of the package's model presets (the list
// is ops/_build.py HEAD_DIMS; the wrappers refuse any other). Each is a
// whole number of 16-byte vectors in float32 and in bf16, as the staging
// loads need.
template <typename F>
inline int with_head_dim(int head_dim, F&& f) {
  switch (head_dim) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return kUnsupported;
  }
}

constexpr int kThreads = 128;  // 4 warps per CTA
constexpr int kTileK = 32;     // context positions staged per step (1/lane)
constexpr int kWarps = kThreads / 32;

struct Smem {
  float* q;      // [R][D]           queries, float
  float* k;      // [kTileK][D + 1]  staged K (padded: conflict-free dots)
  float* v;      // [kTileK][D]      staged V
  float* s;      // [R][kTileK + 1]  scores, then probabilities
  float* acc;    // [R][D]           unnormalised output
  float* m;      // [R]              running max
  float* l;      // [R]              running denominator
  float* alpha;  // [R]              this step's rescale factor
  int* qpos;     // [R]              query position, -1 = row idle
};

template <int D>
__host__ __device__ inline size_t smem_bytes(int R) {
  const size_t floats = size_t(R) * D * 2 + size_t(kTileK) * (D + 1) +
                        size_t(kTileK) * D + size_t(R) * (kTileK + 1) +
                        size_t(R) * 3;
  return floats * sizeof(float) + size_t(R) * sizeof(int);
}

template <int D>
__device__ inline Smem carve(float* base, int R) {
  Smem sm;
  sm.q = base;
  sm.k = sm.q + size_t(R) * D;
  sm.v = sm.k + size_t(kTileK) * (D + 1);
  sm.s = sm.v + size_t(kTileK) * D;
  sm.acc = sm.s + size_t(R) * (kTileK + 1);
  sm.m = sm.acc + size_t(R) * D;
  sm.l = sm.m + R;
  sm.alpha = sm.l + R;
  sm.qpos = reinterpret_cast<int*>(sm.alpha + R);
  return sm;
}

// Zero the flash state of all R rows.
template <int D>
__device__ inline void init_state(const Smem& sm, int R) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) sm.acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    sm.m[r] = -INFINITY;
    sm.l[r] = 0.f;
    sm.alpha[r] = 1.f;
    sm.qpos[r] = -1;
  }
}

// Attend every row with qpos >= 0 to context positions [0, reach) of one
// sequence, causally (a row sees position p only when p <= qpos).
//   layer_base: pool + layer * N * bs * 2KH * D
//   bt_row:     the sequence's block-table row (M entries)
// Ends with __syncthreads(), so the caller may rewrite qpos afterwards.
template <typename T, int D>
__device__ void walk_context(const Smem& sm, int R,
                             const T* __restrict__ layer_base,
                             const int* __restrict__ bt_row, int M, int N,
                             int bs, int KH, int kh, int reach, float scale,
                             float soft_cap) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t slab = size_t(2 * KH) * D;  // elements per token slab

  for (int t0 = 0; t0 < reach; t0 += kTileK) {
    // 1. stage K and V rows of head kh for positions t0 .. t0 + kTileK - 1
    for (int i = tid; i < kTileK * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int pos = t0 + t;
      float kf[kVec], vf[kVec];
      bool ok = pos < reach && pos / bs < M;
      int block = 0;
      if (ok) {
        block = bt_row[pos / bs];
        ok = block >= 0 && block < N;
      }
      if (ok) {
        const T* row = layer_base + (size_t(block) * bs + pos % bs) * slab;
        load16_as_float<T>(row + size_t(kh) * D + c, kf);
        load16_as_float<T>(row + size_t(KH + kh) * D + c, vf);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) kf[j] = vf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sm.k[t * (D + 1) + c + j] = kf[j];
        sm.v[t * D + c + j] = vf[j];
      }
    }
    __syncthreads();

    // 2. scores; a masked pair holds -inf as its marker
    for (int i = tid; i < R * kTileK; i += kThreads) {
      const int r = i / kTileK;
      const int t = i % kTileK;
      const int qp = sm.qpos[r];
      const int pos = t0 + t;
      float sc = -INFINITY;
      if (qp >= 0 && pos <= qp && pos < reach) {
        const float* qr = sm.q + size_t(r) * D;
        const float* kr = sm.k + t * (D + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        dot *= scale;
        if (soft_cap > 0.f) dot = soft_cap * tanhf(dot / soft_cap);
        sc = dot;
      }
      sm.s[r * (kTileK + 1) + t] = sc;
    }
    __syncthreads();

    // 3. online softmax: one warp per row, one lane per staged position
    for (int r = warp; r < R; r += kWarps) {
      if (sm.qpos[r] < 0) {  // warp-uniform
        if (lane == 0) sm.alpha[r] = 1.f;
        continue;
      }
      const float sc = sm.s[r * (kTileK + 1) + lane];
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mx);
      // masked lanes get exactly 0, not exp underflow
      const float p = (sc == -INFINITY) ? 0.f : expf(sc - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sm.s[r * (kTileK + 1) + lane] = p;
      if (lane == 0) {
        const float a = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        sm.alpha[r] = a;
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * a + sum;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + P V
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D;
      if (sm.qpos[r] < 0) continue;
      const int d = i % D;
      const float* pr = sm.s + r * (kTileK + 1);
      float a = sm.acc[i] * sm.alpha[r];
#pragma unroll 8
      for (int t = 0; t < kTileK; ++t) a += pr[t] * sm.v[t * D + d];
      sm.acc[i] = a;
    }
    __syncthreads();
  }
}

// Opt a kernel into more than 48 KiB of dynamic shared memory, once per
// (kernel, size) high-water mark.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e == cudaSuccess) *granted = bytes;
  return e;
}

}  // namespace pstt
