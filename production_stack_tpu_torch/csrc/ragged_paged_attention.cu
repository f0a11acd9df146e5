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
// Design (simple first; wgmma, TMA and split-KV are later work): one CTA
//   per (q tile of q_tile stream tokens x KV head), R = q_tile * G rows.
//   The tile walks only the spans that overlap it (tile_first / tile_count
//   from tile_metadata), and for each span only the context up to the causal
//   reach of the span's last token in the tile. Each context step is staged
//   once in shared memory and shared by the tile's R rows (the G heads of
//   the KV head times the tile's tokens); scores, softmax state and the
//   accumulator stay in float32. The products run on CUDA cores in float32,
//   well below the tensor-core floor: that is the gap a later wgmma version
//   closes. A tile of q_tile decode rows walks q_tile different contexts
//   one after another with only G of its rows live in each walk; such
//   tiles are the long pole of a decode-heavy step (split-KV, or one CTA
//   per decode span, is the fix).
#include "paged_attention_common.cuh"

namespace pstt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ragged_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                  T* __restrict__ out, const int* __restrict__ block_tables,
                  const int* __restrict__ cu_q_lens,
                  const int* __restrict__ context_lens,
                  const int* __restrict__ tile_first,
                  const int* __restrict__ tile_count, int T_tokens, int H,
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
  const int first = tile_first[tile];
  const int count = tile_count[tile];
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

template <typename T, int D>
int launch(const void* q, const void* pool, void* out, const int* bt,
           const int* cu, const int* cl, const int* tfirst, const int* tcount,
           int T_tokens, int H, int KH, int N, int bs, int M, int layer,
           int q_tile, int num_tiles, float scale, float soft_cap,
           cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const int R = q_tile * (H / KH);
  const size_t smem = smem_bytes<D>(R);
  auto kernel = ragged_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(num_tiles, KH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool),
      static_cast<T*>(out), bt, cu, cl, tfirst, tcount, T_tokens, H, KH, N, bs,
      M, layer, q_tile, scale, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int head_dim, const void* q, const void* pool, void* out,
               const int* bt, const int* cu, const int* cl, const int* tfirst,
               const int* tcount, int T_tokens, int H, int KH, int N, int bs,
               int M, int layer, int q_tile, int num_tiles, float scale,
               float soft_cap, cudaStream_t s) {
  return with_head_dim(head_dim, [&](auto d) {
    return launch<T, decltype(d)::value>(q, pool, out, bt, cu, cl, tfirst,
                                         tcount, T_tokens, H, KH, N, bs, M,
                                         layer, q_tile, num_tiles, scale,
                                         soft_cap, s);
  });
}

}  // namespace pstt

// q, out (T, H, D); pool (L, N, bs, 2KH, D); block_tables (S, M);
// cu_q_lens (S+1,); context_lens (S,); tile_first, tile_count (num_tiles,).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* pool, void* out, const int* block_tables,
    const int* cu_q_lens, const int* context_lens, const int* tile_first,
    const int* tile_count, int T_tokens, int H, int KH, int N, int bs, int M,
    int layer, int q_tile, int num_tiles, float scale, float soft_cap,
    int dtype, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pstt::kFloat32:
      return pstt::dispatch_d<float>(head_dim, q, pool, out, block_tables,
                                     cu_q_lens, context_lens, tile_first,
                                     tile_count, T_tokens, H, KH, N, bs, M,
                                     layer, q_tile, num_tiles, scale, soft_cap,
                                     s);
    case pstt::kBFloat16:
      return pstt::dispatch_d<__nv_bfloat16>(
          head_dim, q, pool, out, block_tables, cu_q_lens, context_lens,
          tile_first, tile_count, T_tokens, H, KH, N, bs, M, layer, q_tile,
          num_tiles, scale, soft_cap, s);
    default:
      return pstt::kUnsupported;
  }
}
