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
//   a sweep in chip_smoke.py (PERF.md). The walk is mma::row_tile_walk
//   (mma_attention.cuh), which bf16 K2 runs on its prefill spans too; this
//   kernel gives it a chunk's rows with q_start = q_starts[p].
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
__global__ void __launch_bounds__(mma::TcTile<D, kRows, kPositions>::kThreads)
    prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ pool,
                       __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ q_starts,
                       const int* __restrict__ ctx_totals, int S, int H,
                       int KH, int N, int bs, int M, int layer, float scale,
                       float soft_cap) {
  extern __shared__ float4 smem_raw[];
  const int p = blockIdx.z;
  const size_t chunk = size_t(p) * S * H * D;
  // an inactive chunk (ctx 0) is written as zeros; its q_start (-1) unused
  mma::row_tile_walk<D, kRows, kPositions>(
      q + chunk, out + chunk, H, blockIdx.y, H / KH, blockIdx.x * kRows,
      S * (H / KH), q_starts[p], ctx_totals[p],
      pool + size_t(layer) * N * bs * 2 * KH * D,
      block_tables + size_t(p) * M, KH, N, bs, M, scale, soft_cap,
      reinterpret_cast<__nv_bfloat16*>(smem_raw));
}

template <int D, int kRows, int kPositions>
int launch_mma(const void* q, const void* pool, void* out, const int* bt,
               const int* qs, const int* ctx, int P, int S, int H, int KH,
               int N, int bs, int M, int layer, float scale, float soft_cap,
               cudaStream_t stream) {
  using Tile = mma::TcTile<D, kRows, kPositions>;
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
