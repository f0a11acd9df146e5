// K4: paged prefill attention over P chunks padded to one bucket length.
//
// Replaces: production_stack_tpu/ops/paged_attention_pallas.py
//   _prefill_kernel (entry paged_prefill_attention_pallas).
//
// Computes: q (P, S, H, D) holds P prefill chunks, each padded to the bucket
//   length S. Row s of chunk p sits at position q_starts[p] + s and attends
//   the positions below min(q_starts[p] + s + 1, ctx_totals[p]) of its paged
//   context (pages block_tables[p]), with GQA (head h = kh * G + g reads KV
//   head kh), scale D^-0.5 and the optional soft_cap * tanh(s / soft_cap)
//   before the mask. Padding rows past the chunk (s >= ctx - q_start) so
//   attend the whole context [0, ctx) and are finite; an inactive chunk
//   (ctx_totals[p] = 0, q_starts[p] = -1 as the engine passes it) outputs 0.
//   A chunk that continues a prefix-cached or earlier-chunked prompt has
//   q_start > 0 and reads the blocks below q_start that earlier steps wrote.
//
// Bound on the H100: it depends on the mix. Each chunk reads its context's
//   K and V once (4 KiB a position at llama-3-8b bf16) and q and out once
//   (8 KiB a row each), and does 4 * H * D FLOPs per (row, visible position)
//   pair. Four fresh 512-token chunks move ~42 MB for ~8.6 GFLOP and are
//   bounded by bytes over 3.35 TB/s; one fresh 2048-token chunk does ~34
//   GFLOP for the same ~42 MB and is bounded by operations over the 989
//   TFLOP/s bf16 peak.
//
// Rows: the kernel sees a chunk's queries for KV head kh as S * G rows,
//   row r = (token r / G, head kh * G + r % G), so a staged K/V tile serves
//   every head that shares it. A CTA owns `rows` consecutive rows (they may
//   cross token boundaries, so no row idles at G = 3 or 7); the last CTA of
//   a chunk masks the rows past S * G. ops/paged_prefill_attention.py
//   (launch_geometry) holds the same arithmetic for the tests.
//
// bf16 (the serving path) runs on the tensor cores: a CTA of rows / 16
//   warps, each owning one m16 tile of rows with its Q fragments loaded
//   once (kept in shared memory at D = 256, where the float32 accumulator
//   alone takes 128 registers a lane). K and V tiles of `positions` context
//   positions are gathered through the block table by 16-byte cp.async into
//   bf16 shared memory, two stages deep, so one tile loads while the last
//   is multiplied; positions at or past the CTA's causal reach are
//   zero-filled, never read. S = Q Kᵀ and acc += P V are mma.sync.m16n8k16
//   in float32, the online softmax stays in registers (mma_attention.cuh),
//   P is rounded to bf16 once for P V, and acc is normalised once at the
//   end. Tiles wholly below every row's limit skip the mask; a warp skips a
//   tile none of its rows can see; the walk stops at the reach of the CTA's
//   last row, min(ctx, q_start + its token + 1). The default tile comes from
//   a sweep in chip_smoke.py (PERF.md).
//
// float32 (the tiny presets) keeps the CUDA-core walk of
//   paged_attention_common.cuh, with R = rows a CTA, exact to 1e-5.
//
// Offsets into the pool are 64-bit: a full-size pool has more than 2^31
//   elements.
#include "mma_attention.cuh"
#include "paged_attention_common.cuh"

namespace pstt {

// -- bf16: tensor cores --------------------------------------------------------

template <int D, int kRows, int kPositions>
struct TcTile {
  static constexpr int kWarps = kRows / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStride = D + mma::kPad;  // bf16 per staged row
  static constexpr int kChunks = D / 8;          // 16-byte pieces of a row
  static constexpr bool kQInRegs = D <= 128;
  // sQ [kRows][kStride], then sK and sV [2 stages][kPositions][kStride]
  static constexpr size_t kSmemBytes =
      size_t(kRows + 4 * kPositions) * kStride * sizeof(__nv_bfloat16);
  static_assert(kRows % 16 == 0 && kPositions % 16 == 0 && D % 16 == 0,
                "whole m16 row tiles, k16 steps and n8 pairs");
};

template <int D, int kRows, int kPositions>
__global__ void __launch_bounds__(TcTile<D, kRows, kPositions>::kThreads)
    prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ pool,
                       __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ q_starts,
                       const int* __restrict__ ctx_totals, int S, int H,
                       int KH, int N, int bs, int M, int layer, float scale,
                       float soft_cap) {
  using Tile = TcTile<D, kRows, kPositions>;
  constexpr int kStride = Tile::kStride;
  constexpr int kChunks = Tile::kChunks;
  extern __shared__ float4 smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kRows * kStride;
  __nv_bfloat16* sV = sK + 2 * kPositions * kStride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kh = blockIdx.y;
  const int p = blockIdx.z;
  const int G = H / KH;
  const int n_rows = S * G;
  const int r0 = blockIdx.x * kRows;
  const int ctx = ctx_totals[p];
  const size_t chunk = size_t(p) * S * H * D;
  // element offset of row r's (token, head) in q and out
  auto row_at = [&](int r) {
    return chunk + (size_t(r / G) * H + kh * G + r % G) * D;
  };

  if (ctx <= 0) {  // an inactive chunk: exact zeros; q_start (-1) unused
    for (int i = tid; i < kRows * kChunks; i += Tile::kThreads) {
      const int r = r0 + i / kChunks;
      if (r < n_rows)
        *reinterpret_cast<uint4*>(out + row_at(r) + (i % kChunks) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int q_start = q_starts[p];
  // row r sees the positions below its limit; rows past the bucket take
  // the last real row's, so limits rise with r and stay within the reach
  auto limit = [&](int r) {
    return min(q_start + min(r, n_rows - 1) / G + 1, ctx);
  };
  const int reach = limit(r0 + kRows - 1);
  const __nv_bfloat16* layer_base =
      pool + size_t(layer) * N * bs * 2 * KH * D;
  const int* bt_row = block_tables + size_t(p) * M;
  const size_t slab = size_t(2 * KH) * D;  // elements per token slab

  for (int i = tid; i < kRows * kChunks; i += Tile::kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < n_rows;
    mma::cp_async16(sQ + r * kStride + c, ok ? q + row_at(r0 + r) + c : q,
                    ok);
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
      mma::cp_async16(k_dst + t * kStride + c, k_src, ok);
      mma::cp_async16(v_dst + t * kStride + c,
                      ok ? k_src + size_t(KH) * D : layer_base, ok);
    }
  };

  const int n_tiles = (reach + kPositions - 1) / kPositions;
  stage(0, 0);
  mma::cp_async_commit();

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int w0 = r0 + warp * 16;  // the warp's first row
  const int lim_lo = limit(w0);   // the warp's smallest and largest limits
  const int lim_hi = limit(w0 + 15);
  const int lim[2] = {limit(w0 + g), limit(w0 + g + 8)};
  const __nv_bfloat16* q_rows = sQ + warp * 16 * kStride;
  const float qk_scale = scale * (soft_cap > 0.f ? 1.f : mma::kLog2e);

  uint32_t qf[Tile::kQInRegs ? D / 16 : 1][4];
  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  mma::RowState st;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kPositions;
    if (it + 1 < n_tiles) stage(t0 + kPositions, (it + 1) & 1);
    mma::cp_async_commit();  // possibly empty: keeps the group count fixed
    mma::cp_async_wait<1>();
    __syncthreads();
    if constexpr (Tile::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma::load_a(qf[kk], q_rows, kStride, kk, lane);
      }
    }
    if (t0 < lim_hi) {  // warp-uniform: some row of this warp sees the tile
      const __nv_bfloat16* k_tile = sK + (it & 1) * kPositions * kStride;
      const __nv_bfloat16* v_tile = sV + (it & 1) * kPositions * kStride;
      float s[kPositions / 8][4];
      mma::qk_tile<D, kPositions>(s, k_tile, kStride, lane,
                                  [&](int kk, uint32_t(&a)[4]) {
        if constexpr (Tile::kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
        } else {
          mma::load_a(a, q_rows, kStride, kk, lane);
        }
      });
      const bool full = t0 + kPositions <= lim_lo;  // below every limit
#pragma unroll
      for (int j = 0; j < kPositions / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * qk_scale;
          if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap) * mma::kLog2e;
          if (!full && t0 + j * 8 + 2 * t4 + (e & 1) >= lim[e >> 1])
            x = -INFINITY;
          s[j][e] = x;
        }
      }
      float alpha[2];
      mma::softmax_step<kPositions / 8>(s, st, alpha);
      mma::pv_tile<D, kPositions>(acc, s, alpha, v_tile, kStride, lane);
    }
    __syncthreads();  // the next stage overwrites the buffer just read
  }
  mma::cp_async_wait<0>();  // nothing in flight into sQ (n_tiles = 0)
  __syncthreads();

  // normalise, round, stage the warp's 16 rows in its own rows of sQ, and
  // write them out as 16-byte pieces
  mma::finish_rows(st);
  const float inv[2] = {st.l[0] > 0.f ? 1.f / st.l[0] : 0.f,
                        st.l[1] > 0.f ? 1.f / st.l[1] : 0.f};
  __nv_bfloat16* o_rows = sQ + warp * 16 * kStride;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(o_rows + (g + 8 * h) * kStride + d * 8 +
                                   2 * t4) =
          mma::pack_bf16(acc[d][2 * h] * inv[h], acc[d][2 * h + 1] * inv[h]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (w0 + r < n_rows)
      *reinterpret_cast<uint4*>(out + row_at(w0 + r) + c) =
          *reinterpret_cast<const uint4*>(o_rows + r * kStride + c);
  }
}

// The (rows, positions) tiles built for head dim D; TILES in
// ops/paged_prefill_attention.py lists the same. D = 128 (the llama-3
// family) gets the sweep's grid; every head dim gets 64 rows at 32 and 64
// positions.
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

template <int D, int kRows, int kPositions>
int launch_mma(const void* q, const void* pool, void* out, const int* bt,
               const int* qs, const int* ctx, int P, int S, int H, int KH,
               int N, int bs, int M, int layer, float scale, float soft_cap,
               cudaStream_t stream) {
  using Tile = TcTile<D, kRows, kPositions>;
  static size_t granted = 48 * 1024;
  auto kernel = prefill_mma_kernel<D, kRows, kPositions>;
  cudaError_t e = allow_smem(kernel, Tile::kSmemBytes, &granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (P <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const int G = H / KH;
  dim3 grid((S * G + kRows - 1) / kRows, KH, P);
  kernel<<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool),
      static_cast<__nv_bfloat16*>(out), bt, qs, ctx, S, H, KH, N, bs, M,
      layer, scale, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

// -- float32: the CUDA-core walk ------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    prefill_walk_kernel(const float* __restrict__ q,
                        const float* __restrict__ pool,
                        float* __restrict__ out,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ q_starts,
                        const int* __restrict__ ctx_totals, int S, int H,
                        int KH, int N, int bs, int M, int layer, int R,
                        float scale, float soft_cap) {
  extern __shared__ float4 smem_raw[];
  const int kh = blockIdx.y;
  const int p = blockIdx.z;
  const int G = H / KH;
  const int n_rows = S * G;
  const int r0 = blockIdx.x * R;  // CTA row r = chunk row r0 + r
  const Smem sm = carve<D>(reinterpret_cast<float*>(smem_raw), R);
  const int tid = threadIdx.x;
  const int ctx = ctx_totals[p];
  const size_t chunk = size_t(p) * S * H * D;
  auto row_at = [&](int r) {
    return chunk + (size_t(r / G) * H + kh * G + r % G) * D;
  };

  init_state<D>(sm, R);
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = r0 + i / D;
    sm.q[i] = r < n_rows ? q[row_at(r) + i % D] : 0.f;
  }
  __syncthreads();

  if (ctx > 0) {  // an inactive chunk's q_start (-1) is never used
    const int q_start = q_starts[p];
    for (int r = tid; r < R; r += kThreads)
      sm.qpos[r] = r0 + r < n_rows ? q_start + (r0 + r) / G : -1;
    __syncthreads();
    // the causal reach of the CTA's last row; a CTA holding padding rows
    // reaches ctx, so those rows see the whole context
    const int reach = min(ctx, q_start + (min(r0 + R, n_rows) - 1) / G + 1);
    const float* layer_base = pool + size_t(layer) * N * bs * 2 * KH * D;
    walk_context<float, D>(sm, R, layer_base, block_tables + size_t(p) * M,
                           M, N, bs, KH, kh, reach, scale, soft_cap);
  }

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D;
    if (r0 + r < n_rows)  // an inactive chunk kept l = 0, acc = 0: output 0
      out[row_at(r0 + r) + i % D] = sm.acc[i] / fmaxf(sm.l[r], 1e-30f);
  }
}

template <int D>
int launch_walk(const void* q, const void* pool, void* out, const int* bt,
                const int* qs, const int* ctx, int P, int S, int H, int KH,
                int N, int bs, int M, int layer, int rows, float scale,
                float soft_cap, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes<D>(rows);
  auto kernel = prefill_walk_kernel<D>;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (P <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid((S * (H / KH) + rows - 1) / rows, KH, P);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool),
      static_cast<float*>(out), bt, qs, ctx, S, H, KH, N, bs, M, layer, rows,
      scale, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pstt

// q, out (P, S, H, D); pool (L, N, bs, 2KH, D); block_tables (P, M);
// q_starts, ctx_totals (P,). A CTA owns `rows` (token, head) rows of one KV
// head; bf16 stages `positions` context positions a step (the float32 walk
// always 32, kTileK).
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* pool, void* out, const int* block_tables,
    const int* q_starts, const int* ctx_totals, int P, int S, int H, int KH,
    int N, int bs, int M, int layer, int rows, int positions, float scale,
    float soft_cap, int dtype, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return pstt::kUnsupported;
  switch (dtype) {
    case pstt::kFloat32:
      return pstt::with_head_dim(head_dim, [&](auto d) {
        return pstt::launch_walk<decltype(d)::value>(
            q, pool, out, block_tables, q_starts, ctx_totals, P, S, H, KH, N,
            bs, M, layer, rows, scale, soft_cap, s);
      });
    case pstt::kBFloat16:
      return pstt::with_head_dim(head_dim, [&](auto d) {
        constexpr int D = decltype(d)::value;
        return pstt::with_tile<D>(rows, positions, [&](auto r, auto n) {
          return pstt::launch_mma<D, decltype(r)::value, decltype(n)::value>(
              q, pool, out, block_tables, q_starts, ctx_totals, P, S, H, KH,
              N, bs, M, layer, scale, soft_cap, s);
        });
      });
    default:
      return pstt::kUnsupported;
  }
}
