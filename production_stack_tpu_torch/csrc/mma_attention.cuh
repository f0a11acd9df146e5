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
// Used by K4 (paged_prefill_attention.cu); K2 and K3 still run the float32
// walk of paged_attention_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace mma
}  // namespace pstt
