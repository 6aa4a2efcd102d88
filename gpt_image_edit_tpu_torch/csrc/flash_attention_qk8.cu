// Flash-attention forward with int8 q k^T and bf16 p v for Hopper (sm_90a),
// BSHD layout.
//
// Replaces the Pallas TPU kernel `_resident_qk8_kernel` of
// gpt_image_edit_tpu/ops/pallas/flash_attention.py (entry
// `flash_attention_qk8`, the `--quantize w8a8-qk8` serving mode).
//
// What it computes, per (batch, head, query row):
//   s_j = float(q8 . k8_j) * (qs * ks_j) * scale * log2(e) + bias_j
//   out = sum_j 2^(s_j - m) v_j / sum_j 2^(s_j - m)
// with q8/k8 the int8 rows and qs/ks their fp32 scales (quantized per
// (batch, row, head) over d by the wrapper, as the JAX wrapper does outside
// Pallas), the int32 dot exact, bias_j = 0 for a kept key and -inf for a
// padded one (the kv pad mask, the only mask this kernel takes), p rounded
// to bf16 for the p v product and the row sum kept in fp32, as in the
// Pallas kernel. GQA: q head h reads kv head h / (Hq / Hkv). A row whose
// keys are all masked gives 0 (the Pallas kernel's finite -inf gives the
// mean of v there; FLUX never has such a row). Ragged lengths are masked
// inside the kernel, so every length runs it.
//
// What bounds it: at the FLUX serving shape (B=1, S=8704, 24 heads, d=128,
// 8,576 kept keys) one call is 2*B*H*S*8576*d = 4.6e11 int8 operations at
// 1,979 TOP/s plus as many bf16 FLOP at 989 TFLOP/s, about 0.69 ms, against
// 4.3e7 bytes of int8 q/k and 2.1e8 bytes of bf16 v/out (0.08 ms at
// 3.35 TB/s): tensor-core throughput bounds it.
//
// What the design does about it: K1's FA2 tiling on mma.sync
// (flash_attention_fwd.cu), with the score product moved to the int8 tensor
// cores:
//   - one thread block of 4 warps per (q tile of 128 rows, head, batch);
//     each warp owns 32 query rows as two m16 tiles, so every K fragment
//     feeds two products;
//   - q k^T runs as mma.sync.m16n8k32.s32.s8.s8.s32: the int8 tiles keep
//     the bf16 tiles' byte layout (32 int8 per k step = 16 bf16), so the
//     same ldmatrix addressing loads both operands;
//   - the int32 scores become fp32 with one scale per row and one per key
//     (the key scales and the 0/-inf pad row are staged per KV tile in
//     shared memory beside K), then the online softmax in base 2, p v on
//     mma.sync.m16n8k16 bf16 and the store are K1's (flash_common.cuh);
//   - int8 K and bf16 V tiles of 32 keys are double-buffered with cp.async.
// Like K1 this is the simple route; wgmma/TMA would be the fast one.

#include "flash_common.cuh"

namespace {

using namespace gie;

constexpr int kWarps = 4;
constexpr int kMT = 2;        // m16 row tiles per warp
constexpr int kBlockM = kWarps * 16 * kMT;  // query rows per thread block
constexpr int kBlockN = 32;   // keys per KV tile
constexpr int kThreads = kWarps * 32;
constexpr int kPad8 = 16;     // bytes of padding per int8 shared-memory row
constexpr int kPad16 = 8;     // halves of padding per bf16 shared-memory row

struct Params {
  const int8_t* q;          // (B, Sq, Hq, D)
  const int8_t* k;          // (B, Skv, Hkv, D)
  const __nv_bfloat16* v;   // (B, Skv, Hkv, D)
  __nv_bfloat16* o;         // (B, Sq, Hq, D)
  const float* q_scale;     // (B, Sq, Hq)
  const float* k_scale;     // (B, Skv, Hkv)
  const uint8_t* kv_keep;   // (B, Skv) or null; 0 = masked key
  int B, Sq, Skv, Hq, Hkv, group;
  float scale_log2;         // scale * log2(e)
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Per KV tile: the key scales and the additive 0/-inf pad row (keys past
// Skv are masked and scaled by 0).
__device__ __forceinline__ void load_key_terms(float* bias, float* ks, const Params& p, int b,
                                               int hk, int n0, int tid) {
  for (int i = tid; i < kBlockN; i += kThreads) {
    const int col = n0 + i;
    bool keep = col < p.Skv;
    float s = 0.f;
    if (keep) {
      s = p.k_scale[((long long)b * p.Skv + col) * p.Hkv + hk];
      if (p.kv_keep != nullptr) keep = p.kv_keep[(long long)b * p.Skv + col] != 0;
    }
    bias[i] = keep ? 0.f : -INFINITY;
    ks[i] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_qk8_kernel(const Params p) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32 (the int8 k step)");
  constexpr int kStride8 = D + kPad8;    // bytes per int8 row
  constexpr int kStride16 = D + kPad16;  // halves per bf16 row
  constexpr int kNT = kBlockN / 8;       // n8 score tiles per KV tile
  constexpr int kDT = D / 8;             // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sK = sQ + kBlockM * kStride8;                                        // 2 stages
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(sK + 2 * kBlockN * kStride8);  // 2 stages
  float* sBias = reinterpret_cast<float*>(sV + 2 * kBlockN * kStride16);      // 2 stages
  float* sKs = sBias + 2 * kBlockN;                                            // 2 stages

  const int m_start = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // accumulator row within an m16 tile
  const int tig = lane & 3;  // accumulator column pair
  const int warp_row = warp * 16 * kMT;

  const long long q_row_stride = (long long)p.Hq * D;
  const long long kv_row_stride = (long long)p.Hkv * D;
  const int8_t* q_base = p.q + ((long long)b * p.Sq * p.Hq + h) * D;
  const int8_t* k_base = p.k + ((long long)b * p.Skv * p.Hkv + hk) * D;
  const __nv_bfloat16* v_base = p.v + ((long long)b * p.Skv * p.Hkv + hk) * D;
  __nv_bfloat16* o_base = p.o + ((long long)b * p.Sq * p.Hq + h) * D;
  const int n_tiles = (p.Skv + kBlockN - 1) / kBlockN;

  load_tile<int8_t, D, kBlockM, kStride8, kThreads>(sQ, q_base, q_row_stride, m_start, p.Sq, tid);
  load_tile<int8_t, D, kBlockN, kStride8, kThreads>(sK, k_base, kv_row_stride, 0, p.Skv, tid);
  load_tile<__nv_bfloat16, D, kBlockN, kStride16, kThreads>(sV, v_base, kv_row_stride, 0, p.Skv,
                                                             tid);
  load_key_terms(sBias, sKs, p, b, hk, 0, tid);
  cp_async_commit();

  // this thread's rows: m_start + warp_row + mt * 16 + g + 8 * i
  float qs[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m_start + warp_row + mt * 16 + g + 8 * i;
      qs[mt][i] = r < p.Sq ? p.q_scale[((long long)b * p.Sq + r) * p.Hq + h] : 0.f;
    }
  }

  float acc[kMT][kDT][4];
  float m_i[kMT][2];
  float l_i[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) acc[mt][dt][0] = acc[mt][dt][1] = acc[mt][dt][2] = acc[mt][dt][3] = 0.f;
    m_i[mt][0] = m_i[mt][1] = -INFINITY;
    l_i[mt][0] = l_i[mt][1] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      const int n1 = (j + 1) * kBlockN;
      load_tile<int8_t, D, kBlockN, kStride8, kThreads>(sK + (stage ^ 1) * kBlockN * kStride8,
                                                        k_base, kv_row_stride, n1, p.Skv, tid);
      load_tile<__nv_bfloat16, D, kBlockN, kStride16, kThreads>(
          sV + (stage ^ 1) * kBlockN * kStride16, v_base, kv_row_stride, n1, p.Skv, tid);
      load_key_terms(sBias + (stage ^ 1) * kBlockN, sKs + (stage ^ 1) * kBlockN, p, b, hk, n1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* cK = sK + stage * kBlockN * kStride8;
    const __nv_bfloat16* cV = sV + stage * kBlockN * kStride16;

    // int32 q k^T for this warp's kMT x 16 rows x kBlockN keys, 32 int8 of
    // d per step; each K fragment feeds kMT products
    int si[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) si[mt][nt][0] = si[mt][nt][1] = si[mt][nt][2] = si[mt][nt][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t qf[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = warp_row + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = kk * 32 + (lane >> 4) * 16;
        ldmatrix_x4(qf[mt], smem_u32(sQ + r * kStride8 + c));
      }
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t bk[4];
        const int r = n2 * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        const int c = kk * 32 + ((lane >> 3) & 1) * 16;
        ldmatrix_x4(bk, smem_u32(cK + r * kStride8 + c));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_s8(si[mt][2 * n2], qf[mt], bk[0], bk[1]);
          mma_s8(si[mt][2 * n2 + 1], qf[mt], bk[2], bk[3]);
        }
      }
    }

    // to fp32 base-2 scores: float(dot) * (qs * ks) * scale * log2(e), in
    // that order and without fused multiply-adds, then the 0/-inf pad row
    const float* cBias = sBias + stage * kBlockN;
    const float* cKs = sKs + stage * kBlockN;
    float s[kMT][kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float2 cb = *reinterpret_cast<const float2*>(cBias + nt * 8 + tig * 2);
      const float2 ck = *reinterpret_cast<const float2*>(cKs + nt * 8 + tig * 2);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float qk_scale = __fmul_rn(qs[mt][c >> 1], (c & 1) ? ck.y : ck.x);
          const float x = __fmul_rn(__fmul_rn((float)si[mt][nt][c], qk_scale), p.scale_log2);
          s[mt][nt][c] = __fadd_rn(x, (c & 1) ? cb.y : cb.x);
        }
      }
    }

    online_softmax<kMT, kNT, kDT>(s, m_i, l_i, acc);
    accumulate_pv<__nv_bfloat16, kMT, kNT, kDT, kStride16>(s, acc, cV, lane);
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }
  cp_async_wait<0>();
  store_rows<__nv_bfloat16, kMT, kDT>(acc, l_i, o_base, q_row_stride, m_start + warp_row, p.Sq,
                                      lane);
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(kBlockM + 2 * kBlockN) * (D + kPad8) +
                      (size_t)2 * kBlockN * (D + kPad16) * sizeof(__nv_bfloat16) +
                      (size_t)4 * kBlockN * sizeof(float);
  auto kernel = flash_qk8_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.Hq, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch; D must be 128 (FLUX's head dim).
extern "C" int gie_flash_attention_qk8(const void* q, const void* k, const void* v, void* o,
                                       const void* q_scale, const void* k_scale,
                                       const void* kv_keep, int B, int Sq, int Skv, int Hq,
                                       int Hkv, int D, float scale_log2, void* stream) {
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_scale = static_cast<const float*>(q_scale);
  p.k_scale = static_cast<const float*>(k_scale);
  p.kv_keep = static_cast<const uint8_t*>(kv_keep);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return (int)launch<128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
