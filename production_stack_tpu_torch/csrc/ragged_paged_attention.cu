// K2: ragged paged attention over the packed mixed prefill + decode stream.
//
// Replaces: production_stack_tpu/ops/ragged_paged_attention_pallas.py
//   _ragged_kernel (entry ragged_paged_attention_pallas, tile map
//   tile_metadata).
//
// Computes: q (T, H, D) is the concatenation of every slot's span, with
//   span s = [cu_q_lens[s], cu_q_lens[s+1]) of slot s, whose context holds
//   context_lens[s] tokens (the span included) in pages block_tables[s].
//   Token j of a span of q_len tokens sits at position ctx - q_len + j and
//   attends positions <= its own, with GQA (head h = kh * G + g reads KV
//   head kh), scale D^-0.5 and the optional soft_cap * tanh(s / soft_cap)
//   before the mask. Rows that belong to no span (tail padding) output 0.
//
// Bound on the H100: it depends on the mix. Each span reads its context's
//   K and V once (4 KiB a position at llama-3-8b bf16) and does 4 * H * D
//   FLOPs per (query, visible position) pair. A prefill chunk of n tokens
//   reuses each position ~n/2 times and is bounded by FLOPs over the 989
//   TFLOP/s bf16 peak once n is in the hundreds; a decode row uses each
//   position once (G = 4 FLOP-pairs a byte) and is bounded by bytes over
//   3.35 TB/s. The slice's mixed step (chunks of 300-700 tokens beside 40
//   decode rows with contexts up to 2k) is bounded by bytes.
//
// bf16 (the serving path) works from a work map built on the host once a
//   step (ops/ragged_paged_attention.py ragged_work_map), in up to three
//   launches on one stream:
//   1. ragged_prefill_kernel, grid (tiles, KH): a tile is (span s, first
//      row r0) and owns `rows` consecutive (token, g) rows of s, never
//      crossing into another span; it runs the tensor-core row-tile walk of
//      K4 (mma::row_tile_walk, mma_attention.cuh) with q_start = ctx -
//      q_len. The tail past the last span is cut into tiles of span -1,
//      which write exact zeros and read nothing else, so no memset of the
//      whole output is needed.
//   2. ragged_decode_kernel, grid (n_splits, KH, one-token spans): the
//      split-KV decode walk of K3 (split_decode.cuh) on each one-token
//      span, its context cut into splits of `span` positions;
//   3. ragged_merge_kernel, when n_splits > 1: the log-sum-exp merge of the
//      splits' float32 partials.
//   Routing: a span of one token is a decode item, a span of two or more a
//   run of prefill tiles. A one-token span in a tile fills G of its rows
//   and cannot split its context across CTAs; a span of q_len >= 2 through
//   the decode walk would read its context q_len times, where one tile
//   reads it once for all its rows (q_len G <= rows). So two tokens is the
//   break-even, and short multi-token spans with long contexts (speculative
//   verify spans of 1 + k tokens) go through one unsplit CTA a KV head:
//   the cost this routing accepts.
//
// float32 (the tiny presets) keeps the CUDA-core walk: one CTA per (q tile
//   of q_tile stream tokens x KV head), R = q_tile * G rows, walking the
//   spans that overlap it (first span, count: tile_metadata) up to each
//   span's causal reach in the tile, exact to 1e-5.
#include "paged_attention_common.cuh"
#include "split_decode.cuh"

namespace pstt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ragged_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                  T* __restrict__ out, const int* __restrict__ block_tables,
                  const int* __restrict__ cu_q_lens,
                  const int* __restrict__ context_lens,
                  const int* __restrict__ tile_map, int T_tokens, int H,
                  int KH, int N, int bs, int M, int layer, int q_tile,
                  float scale, float soft_cap) {
  extern __shared__ float4 smem_raw[];
  const int tile = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / KH;
  const int R = q_tile * G;  // row r = (token tile_start + r / G, g = r % G)
  const Smem sm = carve<D>(reinterpret_cast<float*>(smem_raw), R);
  const int tid = threadIdx.x;
  const int tile_start = tile * q_tile;

  init_state<D>(sm, R);
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int tok = tile_start + r / G;
    sm.q[i] = tok < T_tokens
                  ? to_float<T>(q[(size_t(tok) * H + kh * G + r % G) * D + d])
                  : 0.f;
  }
  __syncthreads();

  const T* layer_base = pool + size_t(layer) * N * bs * 2 * KH * D;
  const int first = tile_map[2 * tile];  // (first span, span count)
  const int count = tile_map[2 * tile + 1];
  for (int si = 0; si < count; ++si) {
    const int s = first + si;
    const int q_start = cu_q_lens[s];
    const int q_end = cu_q_lens[s + 1];
    const int q_len = q_end - q_start;
    const int ctx = context_lens[s];
    const int lo = max(q_start, tile_start);
    const int hi = min(q_end, min(tile_start + q_tile, T_tokens));
    if (q_len <= 0 || lo >= hi) continue;  // empty span: no context walk
    // causal reach of the span's last token in this tile
    const int reach = min(ctx, ctx - q_len + (hi - 1 - q_start) + 1);
    for (int r = tid; r < R; r += kThreads) {
      const int tok = tile_start + r / G;
      sm.qpos[r] = (tok >= lo && tok < hi) ? ctx - q_len + (tok - q_start) : -1;
    }
    __syncthreads();
    walk_context<T, D>(sm, R, layer_base, block_tables + size_t(s) * M, M, N,
                       bs, KH, kh, reach, scale, soft_cap);
  }

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int tok = tile_start + r / G;
    if (tok < T_tokens)  // rows of no span kept l = 0, acc = 0: output 0
      out[(size_t(tok) * H + kh * G + r % G) * D + d] =
          from_float<T>(sm.acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

template <int D>
int launch_walk(const void* q, const void* pool, void* out, const int* bt,
                const int* cu, const int* cl, const int* tile_map,
                int T_tokens, int H, int KH, int N, int bs, int M, int layer,
                int q_tile, int num_tiles, float scale, float soft_cap,
                cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const int R = q_tile * (H / KH);
  const size_t smem = smem_bytes<D>(R);
  auto kernel = ragged_kernel<float, D>;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid(num_tiles, KH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool),
      static_cast<float*>(out), bt, cu, cl, tile_map, T_tokens, H, KH, N, bs,
      M, layer, q_tile, scale, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16: the row-tile walk on spans of two or more tokens, the split-KV
// decode walk on one-token spans ---------------------------------------------

template <int D, int kRows, int kPositions>
__global__ void __launch_bounds__(mma::TcTile<D, kRows, kPositions>::kThreads)
    ragged_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ pool,
                          __nv_bfloat16* __restrict__ out,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ cu_q_lens,
                          const int* __restrict__ context_lens,
                          const int* __restrict__ tiles, int T_tokens, int S,
                          int H, int KH, int N, int bs, int M, int layer,
                          float scale, float soft_cap) {
  extern __shared__ float4 smem_raw[];
  const int s = tiles[2 * blockIdx.x];  // span, or -1 for the tail
  const int G = H / KH;
  int tok0, q_len, ctx;
  if (s < 0) {  // rows of no span: zeros (ctx 0 reads nothing)
    tok0 = cu_q_lens[S];
    q_len = T_tokens - tok0;
    ctx = 0;
  } else {
    tok0 = cu_q_lens[s];
    q_len = cu_q_lens[s + 1] - tok0;
    ctx = context_lens[s];
  }
  const size_t base = size_t(tok0) * H * D;
  mma::row_tile_walk<D, kRows, kPositions>(
      q + base, out + base, H, blockIdx.y, G, tiles[2 * blockIdx.x + 1],
      q_len * G, ctx - q_len, ctx, pool + size_t(layer) * N * bs * 2 * KH * D,
      block_tables + size_t(max(s, 0)) * M, KH, N, bs, M, scale, soft_cap,
      reinterpret_cast<__nv_bfloat16*>(smem_raw));
}

template <int D>
__global__ void __launch_bounds__(decode::Tile<D>::kThreads)
    ragged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ pool,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ part,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ cu_q_lens,
                         const int* __restrict__ context_lens,
                         const int* __restrict__ items, int n_items, int H,
                         int KH, int N, int bs, int M, int layer, int span,
                         float scale, float soft_cap) {
  extern __shared__ float4 smem_raw[];
  const int kh = blockIdx.y;
  const int i = blockIdx.z;
  const int slot = items[i];
  const int G = H / KH;
  // the span's token in q and out; the item's partial rows in the scratch
  const size_t row = size_t(cu_q_lens[slot]) * H + size_t(kh) * G;
  const size_t prow = size_t(i) * H + size_t(kh) * G;
  decode::split_walk<D>(
      q + row * D, out + row * D, part, prow,
      size_t(n_items) * H * gridDim.x, G, context_lens[slot], blockIdx.x,
      gridDim.x, span, pool + size_t(layer) * N * bs * 2 * KH * D,
      block_tables + size_t(slot) * M, KH, kh, N, bs, M, scale, soft_cap,
      reinterpret_cast<__nv_bfloat16*>(smem_raw));
}

template <int D>
__global__ void __launch_bounds__(D)
    ragged_merge_kernel(const float* __restrict__ part,
                        __nv_bfloat16* __restrict__ out,
                        const int* __restrict__ cu_q_lens,
                        const int* __restrict__ items, int n_items, int H,
                        int n_splits) {
  const int h = blockIdx.x;
  const int i = blockIdx.y;
  const size_t token = cu_q_lens[items[i]];
  decode::merge_splits<D>(part, size_t(i) * H + h,
                          size_t(n_items) * H * n_splits, n_splits,
                          out + (token * H + h) * D);
}

template <int D, int kRows, int kPositions>
int launch_tiles(const void* q, const void* pool, void* out, const int* bt,
                 const int* cu, const int* cl, const int* tiles, int n_tiles,
                 int T_tokens, int S, int H, int KH, int N, int bs, int M,
                 int layer, float scale, float soft_cap,
                 cudaStream_t stream) {
  using Tile = mma::TcTile<D, kRows, kPositions>;
  static size_t granted = 48 * 1024;
  auto kernel = ragged_prefill_kernel<D, kRows, kPositions>;
  cudaError_t e = allow_smem(kernel, Tile::kSmemBytes, &granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  kernel<<<dim3(n_tiles, KH), Tile::kThreads, Tile::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool),
      static_cast<__nv_bfloat16*>(out), bt, cu, cl, tiles, T_tokens, S, H, KH,
      N, bs, M, layer, scale, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_decode_rows(const void* q, const void* pool, void* out,
                       void* part, const int* bt, const int* cu,
                       const int* cl, const int* items, int n_items, int H,
                       int KH, int N, int bs, int M, int layer, int n_splits,
                       int span, float scale, float soft_cap,
                       cudaStream_t stream) {
  using Tl = decode::Tile<D>;
  static size_t granted = 48 * 1024;
  auto kernel = ragged_decode_kernel<D>;
  cudaError_t e = allow_smem(kernel, Tl::kSmemBytes, &granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_items <= 0) return static_cast<int>(cudaGetLastError());
  if (H / KH > decode::kMaxGroup || n_splits <= 0 || span <= 0 ||
      span % Tl::kPositions || (n_splits > 1 && part == nullptr))
    return kUnsupported;
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* f = static_cast<float*>(part);
  kernel<<<dim3(n_splits, KH, n_items), Tl::kThreads, Tl::kSmemBytes,
           stream>>>(static_cast<const __nv_bfloat16*>(q),
                     static_cast<const __nv_bfloat16*>(pool), o, f, bt, cu,
                     cl, items, n_items, H, KH, N, bs, M, layer, span, scale,
                     soft_cap);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  ragged_merge_kernel<D><<<dim3(H, n_items), D, 0, stream>>>(
      f, o, cu, items, n_items, H, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pstt

// q, out (T, H, D); pool (L, N, bs, 2KH, D); block_tables (S, M);
// cu_q_lens (S+1,); context_lens (S,). `work` is the step's work map:
//   float32: n_tiles (first span, span count) pairs of the q tiles of
//     `rows` stream tokens each (tile_metadata); the rest unused.
//   bf16: n_tiles (span or -1, first row) pairs of the row tiles of
//     (rows, positions), then the n_decode slots of the one-token spans,
//     walked in n_splits splits of `span` positions; `part` is float32
//     scratch of n_decode * H * n_splits * (D + 2) values when n_splits > 1.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* pool, void* out, void* part,
    const int* block_tables, const int* cu_q_lens, const int* context_lens,
    const int* work, int T_tokens, int S, int H, int KH, int N, int bs,
    int M, int layer, int n_tiles, int n_decode, int n_splits, int span,
    int rows, int positions, float scale, float soft_cap, int dtype,
    int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH || rows <= 0) return pstt::kUnsupported;
  switch (dtype) {
    case pstt::kFloat32:
      return pstt::with_head_dim(head_dim, [&](auto d) {
        return pstt::launch_walk<decltype(d)::value>(
            q, pool, out, block_tables, cu_q_lens, context_lens, work,
            T_tokens, H, KH, N, bs, M, layer, rows, n_tiles, scale, soft_cap,
            s);
      });
    case pstt::kBFloat16:
      return pstt::with_head_dim(head_dim, [&](auto d) {
        constexpr int D = decltype(d)::value;
        const int rc = pstt::with_tile<D>(rows, positions, [&](auto r,
                                                               auto n) {
          return pstt::launch_tiles<D, decltype(r)::value, decltype(n)::value>(
              q, pool, out, block_tables, cu_q_lens, context_lens, work,
              n_tiles, T_tokens, S, H, KH, N, bs, M, layer, scale, soft_cap,
              s);
        });
        if (rc != 0) return rc;
        return pstt::launch_decode_rows<D>(
            q, pool, out, part, block_tables, cu_q_lens, context_lens,
            work + 2 * size_t(n_tiles), n_decode, H, KH, N, bs, M, layer,
            n_splits, span, scale, soft_cap, s);
      });
    default:
      return pstt::kUnsupported;
  }
}
