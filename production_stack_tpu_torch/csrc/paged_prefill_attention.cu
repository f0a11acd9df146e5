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
// Design (simple first; wgmma, TMA and a larger tile are later work): one
//   CTA per (tile of q_tile tokens of chunk p x KV head), R = q_tile * G
//   rows. The TPU kernel's 128-token tile (R = 512 at G = 4) does not fit
//   here: the context walk (paged_attention_common.cuh) keeps q and the
//   accumulator in shared memory as float, 2 * R * D * 4 bytes, so R = 512
//   at D = 128 would need ~630 KB against the 227 KB a CTA can have. The
//   default q_tile (ops/paged_prefill_attention.py) comes from a sweep in
//   chip_smoke.py (PERF.md): short tiles win, since more CTAs then fit an
//   SM and the walk is bound by latency, not by staging. Each staged
//   context step is shared by the tile's R rows (the G heads of the KV
//   head times the tile's tokens). The walk stops at the causal reach of the tile's last
//   row, min(ctx, q_start + tile_end), and stages nothing at or past it, so
//   unwritten (NaN) pool slots never reach the accumulator. The products run
//   on CUDA cores in float32. Offsets into the pool are 64-bit: a full-size
//   pool has more than 2^31 elements.
#include "paged_attention_common.cuh"

namespace pstt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    prefill_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                   T* __restrict__ out, const int* __restrict__ block_tables,
                   const int* __restrict__ q_starts,
                   const int* __restrict__ ctx_totals, int S, int H, int KH,
                   int N, int bs, int M, int layer, int q_tile, float scale,
                   float soft_cap) {
  extern __shared__ float4 smem_raw[];
  const int tile = blockIdx.x;
  const int kh = blockIdx.y;
  const int p = blockIdx.z;
  const int G = H / KH;
  const int R = q_tile * G;  // row r = (token s0 + r / G, g = r % G)
  const Smem sm = carve<D>(reinterpret_cast<float*>(smem_raw), R);
  const int tid = threadIdx.x;
  const int s0 = tile * q_tile;
  const int s_end = min(s0 + q_tile, S);  // the bucket need not divide
  const int ctx = ctx_totals[p];
  const size_t chunk = size_t(p) * S * H * D;

  init_state<D>(sm, R);
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = s0 + r / G;
    sm.q[i] = s < s_end ? to_float<T>(q[chunk + (size_t(s) * H + kh * G +
                                                 r % G) * D + d])
                        : 0.f;
  }
  __syncthreads();

  if (ctx > 0) {  // an inactive chunk's q_start (-1) is never used
    const int q_start = q_starts[p];
    for (int r = tid; r < R; r += kThreads) {
      const int s = s0 + r / G;
      sm.qpos[r] = s < s_end ? q_start + s : -1;
    }
    __syncthreads();
    // the causal reach of the tile's last row; a tile holding padding rows
    // reaches ctx, so those rows see the whole context
    const int reach = min(ctx, q_start + s_end);
    const T* layer_base = pool + size_t(layer) * N * bs * 2 * KH * D;
    walk_context<T, D>(sm, R, layer_base, block_tables + size_t(p) * M, M, N,
                       bs, KH, kh, reach, scale, soft_cap);
  }

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = s0 + r / G;
    if (s < s_end)  // an inactive chunk kept l = 0, acc = 0: output 0
      out[chunk + (size_t(s) * H + kh * G + r % G) * D + d] =
          from_float<T>(sm.acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* pool, void* out, const int* bt,
           const int* qs, const int* ctx, int P, int S, int H, int KH, int N,
           int bs, int M, int layer, int q_tile, float scale, float soft_cap,
           cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const int R = q_tile * (H / KH);
  const size_t smem = smem_bytes<D>(R);
  auto kernel = prefill_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (P <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid((S + q_tile - 1) / q_tile, KH, P);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool),
      static_cast<T*>(out), bt, qs, ctx, S, H, KH, N, bs, M, layer, q_tile,
      scale, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int head_dim, const void* q, const void* pool, void* out,
               const int* bt, const int* qs, const int* ctx, int P, int S,
               int H, int KH, int N, int bs, int M, int layer, int q_tile,
               float scale, float soft_cap, cudaStream_t s) {
  return with_head_dim(head_dim, [&](auto d) {
    return launch<T, decltype(d)::value>(q, pool, out, bt, qs, ctx, P, S, H,
                                         KH, N, bs, M, layer, q_tile, scale,
                                         soft_cap, s);
  });
}

}  // namespace pstt

// q, out (P, S, H, D); pool (L, N, bs, 2KH, D); block_tables (P, M);
// q_starts, ctx_totals (P,).
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* pool, void* out, const int* block_tables,
    const int* q_starts, const int* ctx_totals, int P, int S, int H, int KH,
    int N, int bs, int M, int layer, int q_tile, float scale, float soft_cap,
    int dtype, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pstt::kFloat32:
      return pstt::dispatch_d<float>(head_dim, q, pool, out, block_tables,
                                     q_starts, ctx_totals, P, S, H, KH, N, bs,
                                     M, layer, q_tile, scale, soft_cap, s);
    case pstt::kBFloat16:
      return pstt::dispatch_d<__nv_bfloat16>(
          head_dim, q, pool, out, block_tables, q_starts, ctx_totals, P, S, H,
          KH, N, bs, M, layer, q_tile, scale, soft_cap, s);
    default:
      return pstt::kUnsupported;
  }
}
