// The split-KV decode walk on the tensor cores: one query token against its
// paged context. bf16 K3 (paged_decode_attention.cu) runs it on every
// sequence of a decode step, bf16 K2 (ragged_paged_attention.cu) on the
// one-token spans of its stream.
//
// A CTA owns one (query token, KV head kh, split). The G query heads of kh
// (G <= kMaxGroup) are the rows of one m16 tile; rows G .. 15 are zero and
// never written. Split `split` covers positions [split * span, min((split +
// 1) * span, ctx)) of the token's context, all of them visible (the token is
// the context's last). The CTA stages that range kPositions positions at a
// time: K and V of head kh, gathered through the block table by 16-byte
// cp.async into bf16 shared memory, kStages deep, zero-filled at or past
// the range's end, so unwritten (NaN) blocks are never read. Warp w
// multiplies positions [16 w, 16 w + 16) of each stage: S = Q Kᵀ (16 x 16)
// and acc += P V as mma.sync, with its own online softmax in registers
// (mma_attention.cuh). The warps' (m, l, acc) are then merged in shared
// memory. With one split the CTA writes the normalised output; with more it
// writes a float32 partial (m in log2 units, l, acc) to scratch, and
// merge_splits combines a head's partials by the log-sum-exp rule,
//   out = sum_s 2^(m_s - m) acc_s / sum_s 2^(m_s - m) l_s,  m = max_s m_s,
// skipping a split whose m is -inf. A split wholly past its context (or a
// slot with context 0) writes m = -inf and l = 0 and nothing else, so the
// scratch's unwritten acc is never read; a token whose every split is empty
// outputs exact zeros.
//
// Bound on the H100: bytes. Each (token, KV head) reads its context's K and
// V once (4 D bytes a position) for 4 G D FLOPs a position, G = 4 at
// llama-3-8b: one FLOP a byte, far under the ~295 the tensor cores need.
// Several splits add a float32 partial of G (D + 2) values a split, written
// once and read once by the merge.
//
// Why mma.sync and not float32 CUDA cores, for a walk bound by bytes: what
// must be kept high is the bytes in flight, and that is issue slots and
// registers. On CUDA cores a position costs 2 G D FMAs plus the bf16
// unpacking and shared-memory loads of 4 D bytes, ~20 instructions a thread
// a position on a 128-thread CTA, which the cp.async address arithmetic then
// competes with. On mma.sync a warp's 16 positions cost D / 16 * 3
// ldmatrix.x4 and D / 4 mma at D = 128 (~56 instructions for 16 positions,
// ~0.1 a thread a position), with G padded to 16 rows: the tensor cores
// idle at G / 16 of their width, which costs nothing here. So the CTA
// keeps kStages - 1 stages (2 x 64 positions, 64 KB at llama-3-8b) in
// flight while one is multiplied, two CTAs an SM.
#pragma once

#include "mma_attention.cuh"

namespace pstt {
namespace decode {

constexpr int kMaxGroup = 16;  // query heads a KV head: one m16 tile

template <int D>
struct Tile {
  static constexpr int kWarps = D <= 128 ? 4 : 2;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kPositions = 16 * kWarps;  // a stage, 16 a warp
  static constexpr int kStages = 3;
  static constexpr int kStride = D + mma::kPad;  // bf16 per staged row
  static constexpr int kChunks = D / 8;          // 16-byte pieces of a row
  static constexpr bool kQInRegs = D <= 128;
  static constexpr int kAccStride = D + 4;  // floats a merge row: no conflicts
  // sQ [16][kStride], then sK and sV [kStages][kPositions][kStride]; after
  // the walk the stages hold the warps' m, l [kWarps][16] and acc
  // [kWarps][16][kAccStride] for the merge
  static constexpr size_t kStageElems = size_t(kStages) * kPositions * kStride;
  static constexpr size_t kSmemBytes =
      (16 * kStride + 2 * kStageElems) * sizeof(__nv_bfloat16);
  static_assert(size_t(kWarps) * 16 * (kAccStride + 2) * sizeof(float) <=
                    2 * kStageElems * sizeof(__nv_bfloat16),
                "the merge fits in the stages");
  static_assert(D % 16 == 0, "whole k16 steps");
};

// Scratch of several splits, float32, for `parts` = items * H * n_splits
// (item, head, split) triples: m [parts], then l [parts], then acc
// [parts][D]. Partial row `prow` (= item * H + head) of split s is at
// prow * n_splits + s.

// One CTA's split of the walk. q_rows / out_rows: the G query rows of
// (token, kh), contiguous (G * D); prow: the partial row of head kh * G.
template <int D>
__device__ __forceinline__ void split_walk(
    const __nv_bfloat16* __restrict__ q_rows,
    __nv_bfloat16* __restrict__ out_rows, float* __restrict__ part,
    size_t prow, size_t parts, int G, int ctx, int split, int n_splits,
    int span, const __nv_bfloat16* __restrict__ layer_base,
    const int* __restrict__ bt_row, int KH, int kh, int N, int bs, int M,
    float scale, float soft_cap, __nv_bfloat16* smem) {
  using Tl = Tile<D>;
  constexpr int kStride = Tl::kStride;
  constexpr int kChunks = Tl::kChunks;
  constexpr int kP = Tl::kPositions;
  constexpr int kStages = Tl::kStages;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = split * span;
  const int p1 = min(ctx, p0 + span);

  if (p0 >= p1) {  // past the context, or context 0: nothing to see
    if (n_splits == 1) {
      for (int i = tid; i < G * kChunks; i += Tl::kThreads)
        *reinterpret_cast<uint4*>(out_rows + i * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int g = tid; g < G; g += Tl::kThreads) {
        part[(prow + g) * n_splits + split] = -INFINITY;
        part[parts + (prow + g) * n_splits + split] = 0.f;
      }
    }
    return;
  }

  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sK = sQ + 16 * kStride;
  __nv_bfloat16* sV = sK + kStages * kP * kStride;
  for (int i = tid; i < 16 * kChunks; i += Tl::kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < G;
    mma::cp_async16(sQ + r * kStride + c, ok ? q_rows + r * D + c : q_rows,
                    ok);
  }
  const size_t slab = size_t(2 * KH) * D;  // elements per token slab
  // K and V rows of head kh for positions t0 .. t0 + kP - 1
  auto stage = [&](int t0, int buf) {
    __nv_bfloat16* k_dst = sK + buf * kP * kStride;
    __nv_bfloat16* v_dst = sV + buf * kP * kStride;
    for (int i = tid; i < kP * kChunks; i += Tl::kThreads) {
      const int t = i / kChunks, c = (i % kChunks) * 8;
      const int pos = t0 + t;
      const __nv_bfloat16* k_src = layer_base;
      bool ok = pos < p1 && pos / bs < M;
      if (ok) {
        const int block = bt_row[pos / bs];
        ok = block >= 0 && block < N;
        if (ok)
          k_src = layer_base + (size_t(block) * bs + pos % bs) * slab +
                  size_t(kh) * D + c;
      }
      mma::cp_async16(k_dst + t * kStride + c, k_src, ok);
      mma::cp_async16(v_dst + t * kStride + c,
                      ok ? k_src + size_t(KH) * D : layer_base, ok);
    }
  };

  const int n_tiles = (p1 - p0 + kP - 1) / kP;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // Q rides in the first group
    if (s < n_tiles) stage(p0 + s * kP, s);
    mma::cp_async_commit();
  }

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float qk_scale = scale * (soft_cap > 0.f ? 1.f : mma::kLog2e);
  uint32_t qf[Tl::kQInRegs ? D / 16 : 1][4];
  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  mma::RowState st;

  for (int it = 0; it < n_tiles; ++it) {
    const int nxt = it + kStages - 1;  // into the buffer read at it - 1
    if (nxt < n_tiles) stage(p0 + nxt * kP, nxt % kStages);
    mma::cp_async_commit();  // possibly empty: keeps the group count fixed
    mma::cp_async_wait<kStages - 1>();  // tile it has landed
    __syncthreads();
    if constexpr (Tl::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma::load_a(qf[kk], sQ, kStride, kk, lane);
      }
    }
    const int w_t0 = p0 + it * kP + warp * 16;  // the warp's 16 positions
    if (w_t0 < p1) {  // warp-uniform
      const int row = (it % kStages) * kP + warp * 16;
      float s[2][4];
      mma::qk_tile<D, 16>(s, sK + row * kStride, kStride, lane,
                          [&](int kk, uint32_t(&a)[4]) {
        if constexpr (Tl::kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
        } else {
          mma::load_a(a, sQ, kStride, kk, lane);
        }
      });
      const bool full = w_t0 + 16 <= p1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * qk_scale;
          if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap) * mma::kLog2e;
          if (!full && w_t0 + j * 8 + 2 * t4 + (e & 1) >= p1) x = -INFINITY;
          s[j][e] = x;
        }
      }
      float alpha[2];
      mma::softmax_step<2>(s, st, alpha);
      mma::pv_tile<D, 16>(acc, s, alpha, sV + row * kStride, kStride, lane);
    }
    __syncthreads();  // a later stage overwrites the buffer just read
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // merge the warps: each leaves its rows' (m, l, acc) in the stages
  mma::finish_rows(st);
  float* sm_m = reinterpret_cast<float*>(sK);
  float* sm_l = sm_m + Tl::kWarps * 16;
  float* sm_acc = sm_l + Tl::kWarps * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (t4 == 0) {
      sm_m[r] = st.m[h];
      sm_l[r] = st.l[h];
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      sm_acc[r * Tl::kAccStride + d * 8 + 2 * t4] = acc[d][2 * h];
      sm_acc[r * Tl::kAccStride + d * 8 + 2 * t4 + 1] = acc[d][2 * h + 1];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += Tl::kThreads) {
    const int r = i / D, c = i % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < Tl::kWarps; ++w) m = fmaxf(m, sm_m[w * 16 + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < Tl::kWarps; ++w) {
      const float mw = sm_m[w * 16 + r];
      if (mw != -INFINITY) {  // a warp that saw no position adds nothing
        const float f = exp2f(mw - m);
        l += f * sm_l[w * 16 + r];
        a += f * sm_acc[(w * 16 + r) * Tl::kAccStride + c];
      }
    }
    if (n_splits == 1) {
      out_rows[i] = __float2bfloat16(l > 0.f ? a / l : 0.f);
    } else {
      const size_t at = (prow + r) * n_splits + split;
      part[2 * parts + at * D + c] = a;
      if (c == 0) {
        part[at] = m;
        part[parts + at] = l;
      }
    }
  }
}

// One head's splits merged into its output row, by a CTA of D threads
// (thread c writes column c).
template <int D>
__device__ __forceinline__ void merge_splits(const float* __restrict__ part,
                                             size_t prow, size_t parts,
                                             int n_splits,
                                             __nv_bfloat16* __restrict__ out_row) {
  const int c = threadIdx.x;
  const float* pm = part + prow * n_splits;
  const float* pl = part + parts + prow * n_splits;
  const float* pa = part + 2 * parts + prow * n_splits * D;
  float m = -INFINITY;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, pm[s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    if (pm[s] != -INFINITY) {  // an empty split: its acc was never written
      const float f = exp2f(pm[s] - m);
      l += f * pl[s];
      a += f * pa[size_t(s) * D + c];
    }
  }
  out_row[c] = __float2bfloat16(l > 0.f ? a / l : 0.f);
}

}  // namespace decode
}  // namespace pstt
