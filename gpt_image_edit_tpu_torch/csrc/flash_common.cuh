// Tile code shared by the flash-attention kernels for Hopper (sm_90a):
// flash_attention_fwd.cu (K1, bf16/fp16 q k^T) and flash_attention_qk8.cu
// (K3, int8 q k^T). Both use the same FA2 layout on mma.sync: a warp owns
// kMT m16 row tiles, a KV tile is kNT n8 score tiles wide, the output is kDT
// n8 tiles wide; scores are in base 2 and a row's softmax state lives in the
// 4 lanes of a quad. Only the q k^T product differs between the kernels;
// the softmax, the p v product and the store are here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gie {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with pred false the destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 2^x on the special-function unit; 2^-inf = +0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  // c (16x8 f32) += a (16x16, row) * b (16x8, col)
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Copy rows [row0, row0 + kRows) of one head (kCols elements of T each, rows
// `row_stride` elements apart in global memory) into a shared tile whose
// rows are kStride elements apart; rows at or past `rows_total` are
// zero-filled.
template <typename T, int kCols, int kRows, int kStride, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride, int row0,
                                          int rows_total, int tid) {
  constexpr int kPerChunk = 16 / (int)sizeof(T);  // elements per 16-byte copy
  static_assert(kCols % kPerChunk == 0, "rows must be whole 16-byte chunks");
  constexpr int kChunks = kCols / kPerChunk;
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < rows_total;
    const T* s = ok ? src + row * row_stride + c * kPerChunk : src;
    cp_async16(smem_u32(dst + r * kStride + c * kPerChunk), s, ok);
  }
}

// One KV tile of the online softmax. s holds this tile's base-2 scores,
// already scaled and masked (-inf = masked); on return it holds
// p = 2^(s - m), and m_i, l_i (lane-partial) and acc are rescaled.
template <int kMT, int kNT, int kDT>
__device__ __forceinline__ void online_softmax(float (&s)[kMT][kNT][4], float (&m_i)[kMT][2],
                                               float (&l_i)[kMT][2], float (&acc)[kMT][kDT][4]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_i[mt][i];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mx = fmaxf(mx, fmaxf(s[mt][nt][2 * i], s[mt][nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float base = mx == -INFINITY ? 0.f : mx;  // a row with no key yet
      const float alpha = fast_exp2(m_i[mt][i] - base);
      m_i[mt][i] = mx;
      float rowsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        s[mt][nt][2 * i] = fast_exp2(s[mt][nt][2 * i] - base);
        s[mt][nt][2 * i + 1] = fast_exp2(s[mt][nt][2 * i + 1] - base);
        rowsum += s[mt][nt][2 * i] + s[mt][nt][2 * i + 1];
      }
      l_i[mt][i] = l_i[mt][i] * alpha + rowsum;  // lane-partial; reduced at the end
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        acc[mt][dt][2 * i] *= alpha;
        acc[mt][dt][2 * i + 1] *= alpha;
      }
    }
  }
}

// acc += p v for one KV tile: p is repacked from the score accumulators as
// the A operand (rounded to T), v (kNT * 8 rows of the shared tile cV, rows
// kStride elements apart) is read transposed; each V fragment feeds kMT
// products.
template <typename T, int kMT, int kNT, int kDT, int kStride>
__device__ __forceinline__ void accumulate_pv(const float (&s)[kMT][kNT][4],
                                              float (&acc)[kMT][kDT][4], const T* cV, int lane) {
#pragma unroll
  for (int kc = 0; kc < kNT / 2; ++kc) {
    uint32_t a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      a[mt][0] = Ops<T>::pack(s[mt][2 * kc][0], s[mt][2 * kc][1]);
      a[mt][1] = Ops<T>::pack(s[mt][2 * kc][2], s[mt][2 * kc][3]);
      a[mt][2] = Ops<T>::pack(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
      a[mt][3] = Ops<T>::pack(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
    }
#pragma unroll
    for (int d2 = 0; d2 < kDT / 2; ++d2) {
      uint32_t bv[4];
      const int r = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = d2 * 16 + (lane >> 4) * 8;
      ldmatrix_x4_trans(bv, smem_u32(cV + r * kStride + c));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        Ops<T>::mma(acc[mt][2 * d2], a[mt], bv[0], bv[1]);
        Ops<T>::mma(acc[mt][2 * d2 + 1], a[mt], bv[2], bv[3]);
      }
    }
  }
}

// out = acc / l for this warp's rows row0 + mt * 16 + g + 8 * i that lie
// below Sq; a row that saw no key (l = 0) gives 0.
template <typename T, int kMT, int kDT>
__device__ __forceinline__ void store_rows(const float (&acc)[kMT][kDT][4],
                                           const float (&l_i)[kMT][2], T* o_base,
                                           long long row_stride, int row0, int Sq, int lane) {
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_i[mt][i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int r = row0 + mt * 16 + g + 8 * i;
      if (r < Sq) {
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          *reinterpret_cast<uint32_t*>(o_base + r * row_stride + dt * 8 + tig * 2) =
              Ops<T>::pack(acc[mt][dt][2 * i] * inv, acc[mt][dt][2 * i + 1] * inv);
        }
      }
    }
  }
}

}  // namespace gie
