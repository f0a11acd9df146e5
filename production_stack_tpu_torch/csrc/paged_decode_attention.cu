// K3: paged decode attention, one query token per sequence.
//
// Replaces: production_stack_tpu/ops/paged_attention_pallas.py
//   _decode_kernel (entry paged_decode_attention_pallas, cell sizing
//   _pick_seqs_per_cell).
//
// Computes: for each sequence b, q[b] (H, D) attends the first
//   context_lens[b] tokens of its paged context (block_tables[b]), with GQA
//   (head h = kh * G + g reads KV head kh), scale D^-0.5, the optional
//   soft_cap * tanh(s / soft_cap), and a softmax in float32. A slot with
//   context 0 outputs 0.
//
// Bound on the H100: bytes. Each sequence's context K and V are read once
//   (2 * ctx * KH * D * sizeof(T) bytes) for 4 * H * D FLOPs per position,
//   G = 4 FLOP-pairs per element read at llama-3-8b: far below the ~295
//   FLOPs a byte the tensor cores need, so the floor is the context bytes
//   over 3.35 TB/s.
//
// Design (simple first; split-KV over long contexts is later work): one
//   CTA per (sequence x KV head). The G query heads that share KV head kh
//   are the CTA's rows, so each staged K/V position is read from device
//   memory once and used G times. A context walk stops at context_lens[b]
//   and stages only positions below it, so unwritten (NaN) blocks past the
//   context are never read. Shares the walk with K2
//   (paged_attention_common.cuh) but keeps its own entry point.
#include "paged_attention_common.cuh"

namespace pstt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                  T* __restrict__ out, const int* __restrict__ block_tables,
                  const int* __restrict__ context_lens, int H, int KH, int N,
                  int bs, int M, int layer, float scale, float soft_cap) {
  extern __shared__ float4 smem_raw[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / KH;
  const int R = G;  // row g = head kh * G + g of sequence b
  const Smem sm = carve<D>(reinterpret_cast<float*>(smem_raw), R);
  const int tid = threadIdx.x;
  const int ctx = context_lens[b];

  init_state<D>(sm, R);
  const T* qb = q + (size_t(b) * H + size_t(kh) * G) * D;
  for (int i = tid; i < R * D; i += kThreads) sm.q[i] = to_float<T>(qb[i]);
  __syncthreads();
  for (int r = tid; r < R; r += kThreads) sm.qpos[r] = ctx > 0 ? ctx - 1 : -1;
  __syncthreads();
  if (ctx > 0) {
    const T* layer_base = pool + size_t(layer) * N * bs * 2 * KH * D;
    walk_context<T, D>(sm, R, layer_base, block_tables + size_t(b) * M, M, N,
                       bs, KH, kh, ctx, scale, soft_cap);
  }
  T* ob = out + (size_t(b) * H + size_t(kh) * G) * D;
  for (int i = tid; i < R * D; i += kThreads)  // ctx 0: l = 0, acc = 0 -> 0
    ob[i] = from_float<T>(sm.acc[i] / fmaxf(sm.l[i / D], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* pool, void* out, const int* bt,
           const int* cl, int B, int H, int KH, int N, int bs, int M,
           int layer, float scale, float soft_cap, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes<D>(H / KH);
  auto kernel = decode_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid(B, KH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool),
      static_cast<T*>(out), bt, cl, H, KH, N, bs, M, layer, scale, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int head_dim, const void* q, const void* pool, void* out,
               const int* bt, const int* cl, int B, int H, int KH, int N,
               int bs, int M, int layer, float scale, float soft_cap,
               cudaStream_t s) {
  return with_head_dim(head_dim, [&](auto d) {
    return launch<T, decltype(d)::value>(q, pool, out, bt, cl, B, H, KH, N,
                                         bs, M, layer, scale, soft_cap, s);
  });
}

}  // namespace pstt

// q, out (B, H, D); pool (L, N, bs, 2KH, D); block_tables (B, M);
// context_lens (B,).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* pool, void* out, const int* block_tables,
    const int* context_lens, int B, int H, int KH, int N, int bs, int M,
    int layer, float scale, float soft_cap, int dtype, int head_dim,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pstt::kFloat32:
      return pstt::dispatch_d<float>(head_dim, q, pool, out, block_tables,
                                     context_lens, B, H, KH, N, bs, M, layer,
                                     scale, soft_cap, s);
    case pstt::kBFloat16:
      return pstt::dispatch_d<__nv_bfloat16>(head_dim, q, pool, out,
                                             block_tables, context_lens, B, H,
                                             KH, N, bs, M, layer, scale,
                                             soft_cap, s);
    default:
      return pstt::kUnsupported;
  }
}
