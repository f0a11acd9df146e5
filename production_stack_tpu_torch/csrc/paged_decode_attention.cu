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
// bf16 (the serving path): the split-KV walk of split_decode.cuh on the
//   tensor cores. A CTA owns one (sequence, KV head, split): grid (n_splits,
//   KH, B), each split `span` positions of the context, K/V staged three
//   deep by cp.async. With one split the walk writes the output; with more
//   it writes float32 partials to the caller's scratch and a second launch
//   (decode_merge_kernel, one CTA of D threads a (sequence, head)) merges
//   them. The split plan (n_splits, span) is fixed by the caller once a
//   step from host context lengths (ops/paged_decode_attention.py
//   split_plan); each CTA reads its own length from context_lens, so
//   contexts that grow on the device between the steps of a multi-step
//   decode stay covered, and a split past its context adds nothing.
//
// float32 (the tiny presets): the CUDA-core walk of
//   paged_attention_common.cuh, one CTA per (sequence x KV head) with the
//   G query heads of the KV head as its rows, exact to 1e-5. A context walk
//   stops at context_lens[b] and stages only positions below it, so
//   unwritten (NaN) blocks past the context are never read.
#include "paged_attention_common.cuh"
#include "split_decode.cuh"

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

template <int D>
int launch_walk(const void* q, const void* pool, void* out, const int* bt,
                const int* cl, int B, int H, int KH, int N, int bs, int M,
                int layer, float scale, float soft_cap, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes<D>(H / KH);
  auto kernel = decode_kernel<float, D>;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid(B, KH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool),
      static_cast<float*>(out), bt, cl, H, KH, N, bs, M, layer, scale,
      soft_cap);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16: the split-KV walk ---------------------------------------------------

template <int D>
__global__ void __launch_bounds__(decode::Tile<D>::kThreads)
    decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ pool,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ part,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ context_lens, int B, int H,
                        int KH, int N, int bs, int M, int layer, int span,
                        float scale, float soft_cap) {
  extern __shared__ float4 smem_raw[];
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const size_t row = size_t(b) * H + size_t(kh) * G;  // the CTA's first head
  decode::split_walk<D>(
      q + row * D, out + row * D, part, row, size_t(B) * H * gridDim.x, G,
      context_lens[b], blockIdx.x, gridDim.x, span,
      pool + size_t(layer) * N * bs * 2 * KH * D,
      block_tables + size_t(b) * M, KH, kh, N, bs, M, scale, soft_cap,
      reinterpret_cast<__nv_bfloat16*>(smem_raw));
}

template <int D>
__global__ void __launch_bounds__(D)
    decode_merge_kernel(const float* __restrict__ part,
                        __nv_bfloat16* __restrict__ out, int B, int H,
                        int n_splits) {
  const size_t row = size_t(blockIdx.y) * H + blockIdx.x;  // (b, head)
  decode::merge_splits<D>(part, row, size_t(B) * H * n_splits, n_splits,
                          out + row * D);
}

template <int D>
int launch_split(const void* q, const void* pool, void* out, void* part,
                 const int* bt, const int* cl, int B, int H, int KH, int N,
                 int bs, int M, int layer, int n_splits, int span,
                 float scale, float soft_cap, cudaStream_t stream) {
  using Tl = decode::Tile<D>;
  static size_t granted = 48 * 1024;
  auto kernel = decode_split_kernel<D>;
  cudaError_t e = allow_smem(kernel, Tl::kSmemBytes, &granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (H / KH > decode::kMaxGroup || n_splits <= 0 || span <= 0 ||
      span % Tl::kPositions || (n_splits > 1 && part == nullptr))
    return kUnsupported;
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* f = static_cast<float*>(part);
  kernel<<<dim3(n_splits, KH, B), Tl::kThreads, Tl::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool), o, f, bt, cl, B, H, KH, N,
      bs, M, layer, span, scale, soft_cap);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  decode_merge_kernel<D><<<dim3(H, B), D, 0, stream>>>(f, o, B, H, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pstt

// q, out (B, H, D); pool (L, N, bs, 2KH, D); block_tables (B, M);
// context_lens (B,). bf16: n_splits splits of `span` positions each (a
// multiple of the walk's stage), `part` float32 scratch of B * H * n_splits
// * (D + 2) values when n_splits > 1; float32 ignores all three.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* pool, void* out, void* part,
    const int* block_tables, const int* context_lens, int B, int H, int KH,
    int N, int bs, int M, int layer, int n_splits, int span, float scale,
    float soft_cap, int dtype, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH) return pstt::kUnsupported;
  switch (dtype) {
    case pstt::kFloat32:
      return pstt::with_head_dim(head_dim, [&](auto d) {
        return pstt::launch_walk<decltype(d)::value>(
            q, pool, out, block_tables, context_lens, B, H, KH, N, bs, M,
            layer, scale, soft_cap, s);
      });
    case pstt::kBFloat16:
      return pstt::with_head_dim(head_dim, [&](auto d) {
        return pstt::launch_split<decltype(d)::value>(
            q, pool, out, part, block_tables, context_lens, B, H, KH, N, bs,
            M, layer, n_splits, span, scale, soft_cap, s);
      });
    default:
      return pstt::kUnsupported;
  }
}
