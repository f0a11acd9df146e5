// Warp-level pieces of a tensor-core attention walk over bf16 tiles staged
// in shared memory, for Hopper (sm_90a) through the Ampere-style
// instructions: cp.async for staging, ldmatrix for fragments, and
// mma.sync.m16n8k16 (bf16 in, float32 accumulate) for both products.
//
// A warp owns 16 query rows (one m16 tile). Lane l holds, of every 16 x 8
// accumulator block, rows l/4 and l/4 + 8 at columns 2(l%4) and 2(l%4) + 1
// (PTX ISA, "Matrix fragments for mma.m16n8k16"). So a row's scores lie in
// the four lanes of one quad, and its softmax reductions are two shuffles.
//
// Staged tiles are row-major [rows][D + kPad] bf16: the 16 bytes of padding
// put the 8 rows an ldmatrix reads in 8 different bank groups, whatever D.
//
// Besides the warp-level pieces, the row-tile walk of one CTA
// (`row_tile_walk`, below) is here: bf16 K4 (paged_prefill_attention.cu)
// runs it on its padded chunks and bf16 K2 (ragged_paged_attention.cu) on
// the spans of two or more tokens of its stream. The split-KV decode walk
// of bf16 K3 and of K2's one-token spans is split_decode.cuh. Only the
// float32 kernels still run the CUDA-core walk of
// paged_attention_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace pstt {
namespace mma {

constexpr int kPad = 8;  // bf16 elements of padding after each staged row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously. When !valid nothing is read
// (src-size 0) and the 16 bytes are zero-filled: a staged position past a
// reach holds zeros, never the pool's unwritten NaN (0 * NaN = NaN in a
// tensor core too). `src` must still be a mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and r[i] receives this lane's pair of it.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c (16 x 8, float32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to one bf16 pair; `lo` is the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of a warp's 16 rows at k-step kk, from a staged [16][stride]
// tile (`rows` points at the warp's first row).
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* rows, int stride,
                                       int kk, int lane) {
  ldsm_x4(a, rows + (lane & 15) * stride + kk * 16 + (lane >> 4) * 8);
}

// S (16 x BN) = A (16 x D) Kᵀ for a staged K tile [BN][stride]: A's
// fragments come from `a_frag(kk, a)`, so they may sit in registers or be
// reloaded from shared memory. One ldmatrix.x4 gives the B fragments of
// two n8 blocks at one k16 step, so any D and BN that are multiples of 16
// take whole loads (48 and 96 included).
template <int D, int BN, typename AFrag>
__device__ __forceinline__ void qk_tile(float (&s)[BN / 8][4],
                                        const __nv_bfloat16* k_tile,
                                        int stride, int lane,
                                        AFrag&& a_frag) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const __nv_bfloat16* base =
      k_tile + ((lane >> 4) * 8 + (lane & 7)) * stride + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a_frag(kk, a);
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, base + j * 8 * stride + kk * 16);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}

// Online-softmax state of one lane's two rows (g and g + 8 of the warp's
// 16): the running max in log2 units and this lane's share of the
// denominator (the quad's shares are summed once, at the end).
struct RowState {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
};

// Turn a tile of log2-scaled scores (masked pairs hold -inf) into
// probabilities in place, update the state, and return each row's rescale
// factor for the accumulator. A masked probability is exactly 0, and a row
// that has seen nothing yet keeps m = -inf and l = 0 without a NaN.
template <int NB>
__device__ __forceinline__ void softmax_step(float (&s)[NB][4], RowState& st,
                                             float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[h], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = exp2f(st.m[h] - m_use);  // exp2(-inf) = 0 on the first tile
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      s[j][2 * h] = exp2f(s[j][2 * h] - m_use);
      s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - m_use);
      sum += s[j][2 * h] + s[j][2 * h + 1];
    }
    st.m[h] = m_new;
    st.l[h] = st.l[h] * alpha[h] + sum;
  }
}

// acc (16 x D) = acc * alpha + P V for a staged V tile [BN][stride]. P is
// rounded to bf16 in registers and used as the A operand directly: the
// accumulator layout of S's n8 blocks 2k and 2k + 1 is the A layout of
// k-step k. V's B fragments come through ldmatrix.trans, two d-blocks a
// load.
template <int D, int BN>
__device__ __forceinline__ void pv_tile(float (&acc)[D / 8][4],
                                        const float (&p)[BN / 8][4],
                                        const float (&alpha)[2],
                                        const __nv_bfloat16* v_tile,
                                        int stride, int lane) {
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    acc[d][0] *= alpha[0];
    acc[d][1] *= alpha[0];
    acc[d][2] *= alpha[1];
    acc[d][3] *= alpha[1];
  }
  const __nv_bfloat16* base =
      v_tile + (((lane >> 3) & 1) * 8 + (lane & 7)) * stride + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int d = 0; d < D / 8; d += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, base + kk * 16 * stride + d * 8);
      mma_bf16(acc[d], a, b[0], b[1]);
      mma_bf16(acc[d + 1], a, b[2], b[3]);
    }
  }
}

// Sum each row's denominator over its quad, once, after the walk.
__device__ __forceinline__ void finish_rows(RowState& st) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 1);
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 2);
  }
}

// -- the row-tile walk (bf16 K4, and bf16 K2's spans of two or more tokens) --

template <int D, int kRows, int kPositions>
struct TcTile {
  static constexpr int kWarps = kRows / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStride = D + kPad;  // bf16 per staged row
  static constexpr int kChunks = D / 8;     // 16-byte pieces of a row
  static constexpr bool kQInRegs = D <= 128;
  // sQ [kRows][kStride], then sK and sV [2 stages][kPositions][kStride]
  static constexpr size_t kSmemBytes =
      size_t(kRows + 4 * kPositions) * kStride * sizeof(__nv_bfloat16);
  static_assert(kRows % 16 == 0 && kPositions % 16 == 0 && D % 16 == 0,
                "whole m16 row tiles, k16 steps and n8 pairs");
};

// One CTA's walk over kRows consecutive query rows of KV head kh: rows r0 ..
// r0 + kRows - 1 of n_rows in (token, g) order, row r = token r / G, head
// kh * G + r % G, at q + (r / G * H + kh * G + r % G) * D (out alike). Row r
// sits at position q_start + r / G and sees the positions below min(q_start
// + r / G + 1, ctx). Rows past n_rows are neither computed nor written
// (a warp wholly past them skips its products). With ctx <= 0 the rows are
// written as exact zeros and nothing else is read (q_start and bt_row
// unused). K and V tiles of kPositions positions are gathered through
// bt_row by 16-byte cp.async, two stages deep, zero-filled at or past the
// CTA's causal reach; S = Q Kᵀ and acc += P V run as mma.sync with the
// online softmax in registers; P is rounded to bf16 once for P V. `smem`
// holds TcTile::kSmemBytes.
template <int D, int kRows, int kPositions>
__device__ __forceinline__ void row_tile_walk(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    int H, int kh, int G, int r0, int n_rows, int q_start, int ctx,
    const __nv_bfloat16* __restrict__ layer_base,
    const int* __restrict__ bt_row, int KH, int N, int bs, int M,
    float scale, float soft_cap, __nv_bfloat16* smem) {
  using Tile = TcTile<D, kRows, kPositions>;
  constexpr int kStride = Tile::kStride;
  constexpr int kChunks = Tile::kChunks;
  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sK = sQ + kRows * kStride;
  __nv_bfloat16* sV = sK + 2 * kPositions * kStride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // element offset of row r's (token, head) in q and out
  auto row_at = [&](int r) {
    return (size_t(r / G) * H + kh * G + r % G) * D;
  };

  if (ctx <= 0) {  // exact zeros; q_start and bt_row unused
    for (int i = tid; i < kRows * kChunks; i += Tile::kThreads) {
      const int r = r0 + i / kChunks;
      if (r < n_rows)
        *reinterpret_cast<uint4*>(out + row_at(r) + (i % kChunks) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  // row r sees the positions below its limit; rows past n_rows take the
  // last real row's, so limits rise with r and stay within the reach
  auto limit = [&](int r) {
    return min(q_start + min(r, n_rows - 1) / G + 1, ctx);
  };
  const int reach = limit(r0 + kRows - 1);
  const size_t slab = size_t(2 * KH) * D;  // elements per token slab

  for (int i = tid; i < kRows * kChunks; i += Tile::kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < n_rows;
    cp_async16(sQ + r * kStride + c, ok ? q + row_at(r0 + r) + c : q, ok);
  }
  // K and V rows of head kh for positions t0 .. t0 + kPositions - 1
  auto stage = [&](int t0, int buf) {
    __nv_bfloat16* k_dst = sK + buf * kPositions * kStride;
    __nv_bfloat16* v_dst = sV + buf * kPositions * kStride;
    for (int i = tid; i < kPositions * kChunks; i += Tile::kThreads) {
      const int t = i / kChunks, c = (i % kChunks) * 8;
      const int pos = t0 + t;
      const __nv_bfloat16* k_src = layer_base;
      bool ok = pos < reach && pos / bs < M;
      if (ok) {
        const int block = bt_row[pos / bs];
        ok = block >= 0 && block < N;
        if (ok)
          k_src = layer_base + (size_t(block) * bs + pos % bs) * slab +
                  size_t(kh) * D + c;
      }
      cp_async16(k_dst + t * kStride + c, k_src, ok);
      cp_async16(v_dst + t * kStride + c,
                 ok ? k_src + size_t(KH) * D : layer_base, ok);
    }
  };

  const int n_tiles = (reach + kPositions - 1) / kPositions;
  stage(0, 0);
  cp_async_commit();

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int w0 = r0 + warp * 16;  // the warp's first row
  const bool live = w0 < n_rows;  // warp-uniform
  const int lim_lo = limit(w0);   // the warp's smallest and largest limits
  const int lim_hi = limit(w0 + 15);
  const int lim[2] = {limit(w0 + g), limit(w0 + g + 8)};
  const __nv_bfloat16* q_rows = sQ + warp * 16 * kStride;
  const float qk_scale = scale * (soft_cap > 0.f ? 1.f : kLog2e);

  uint32_t qf[Tile::kQInRegs ? D / 16 : 1][4];
  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  RowState st;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kPositions;
    if (it + 1 < n_tiles) stage(t0 + kPositions, (it + 1) & 1);
    cp_async_commit();  // possibly empty: keeps the group count fixed
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (Tile::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          load_a(qf[kk], q_rows, kStride, kk, lane);
      }
    }
    if (live && t0 < lim_hi) {  // some row of this warp sees the tile
      const __nv_bfloat16* k_tile = sK + (it & 1) * kPositions * kStride;
      const __nv_bfloat16* v_tile = sV + (it & 1) * kPositions * kStride;
      float s[kPositions / 8][4];
      qk_tile<D, kPositions>(s, k_tile, kStride, lane,
                             [&](int kk, uint32_t(&a)[4]) {
        if constexpr (Tile::kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
        } else {
          load_a(a, q_rows, kStride, kk, lane);
        }
      });
      const bool full = t0 + kPositions <= lim_lo;  // below every limit
#pragma unroll
      for (int j = 0; j < kPositions / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * qk_scale;
          if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap) * kLog2e;
          if (!full && t0 + j * 8 + 2 * t4 + (e & 1) >= lim[e >> 1])
            x = -INFINITY;
          s[j][e] = x;
        }
      }
      float alpha[2];
      softmax_step<kPositions / 8>(s, st, alpha);
      pv_tile<D, kPositions>(acc, s, alpha, v_tile, kStride, lane);
    }
    __syncthreads();  // the next stage overwrites the buffer just read
  }
  cp_async_wait<0>();  // nothing in flight into sQ (n_tiles = 0)
  __syncthreads();

  // normalise, round, stage the warp's 16 rows in its own rows of sQ, and
  // write them out as 16-byte pieces
  finish_rows(st);
  const float inv[2] = {st.l[0] > 0.f ? 1.f / st.l[0] : 0.f,
                        st.l[1] > 0.f ? 1.f / st.l[1] : 0.f};
  __nv_bfloat16* o_rows = sQ + warp * 16 * kStride;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(o_rows + (g + 8 * h) * kStride + d * 8 +
                                   2 * t4) =
          pack_bf16(acc[d][2 * h] * inv[h], acc[d][2 * h + 1] * inv[h]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (w0 + r < n_rows)
      *reinterpret_cast<uint4*>(out + row_at(w0 + r) + c) =
          *reinterpret_cast<const uint4*>(o_rows + r * kStride + c);
  }
}

}  // namespace mma

// The (rows, positions) tiles of the row-tile walk built for head dim D;
// TILES in ops/paged_prefill_attention.py lists the same. D = 128 (the
// llama-3 family) gets the sweep's grid; every head dim gets 64 rows at 32
// and 64 positions.
template <int D, typename F>
inline int with_tile(int rows, int positions, F&& f) {
  using std::integral_constant;
  if (rows == 64 && positions == 32)
    return f(integral_constant<int, 64>{}, integral_constant<int, 32>{});
  if (rows == 64 && positions == 64)
    return f(integral_constant<int, 64>{}, integral_constant<int, 64>{});
  if constexpr (D == 128) {
    if (rows == 64 && positions == 128)
      return f(integral_constant<int, 64>{}, integral_constant<int, 128>{});
    if (rows == 128 && positions == 32)
      return f(integral_constant<int, 128>{}, integral_constant<int, 32>{});
    if (rows == 128 && positions == 64)
      return f(integral_constant<int, 128>{}, integral_constant<int, 64>{});
    if (rows == 128 && positions == 128)
      return f(integral_constant<int, 128>{}, integral_constant<int, 128>{});
  }
  return kUnsupported;
}

}  // namespace pstt
