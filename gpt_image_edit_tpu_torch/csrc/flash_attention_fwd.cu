// Flash-attention forward for Hopper (sm_90a), BSHD layout, bf16 or fp16.
//
// Replaces the Pallas TPU kernels `_resident_kernel` (KV resident in VMEM)
// and `_grid_kernel` (KV as a sequential grid axis) of
// gpt_image_edit_tpu/ops/pallas/flash_attention.py. On the GPU there is no
// resident/grid split: every thread block walks the whole KV sequence in an
// inner loop, so one kernel covers both.
//
// What it computes: out = softmax(q k^T * scale + bias, masked) v per head,
// with
//   - a kv keep mask (B, Skv) uint8 (the FLUX prompt-padding case),
//   - q/kv segment ids (B, Sq)/(B, Skv) int32 (attend within equal ids),
//   - end-aligned causal masking (key j visible to query i iff
//     j <= i + Skv - Sq), with the KV loop cut at the last visible tile,
//   - an optional additive fp32 bias with broadcast strides,
//   - GQA (q head h reads kv head h / (Hq / Hkv)),
//   - rows that see no key at all give 0.
// Ragged lengths are masked inside the kernel: out-of-range rows load as
// zeros and are not stored, out-of-range keys are masked.
//
// What bounds it: at the FLUX serving shape (B=1, S=8704, 24 heads, d=128)
// one call is 4*B*H*S^2*d = 0.93 TFLOP against 214 MB of q/k/v/o, about
// 4,300 FLOP per byte, far above the H100's ~295 FLOP/byte ridge: it is
// bound by tensor-core throughput (0.94 ms at 989 TFLOP/s dense bf16).
//
// What the design does about it (FA2 on mma.sync, the simple route):
//   - one thread block of 4 warps per (q tile of 128 rows, head, batch); each
//     warp owns 32 query rows as two m16 tiles, so every K and V fragment it
//     reads from shared memory feeds two tensor-core products, and a row's
//     softmax state lives in the 4 lanes of a quad;
//   - q k^T and p v run on tensor cores as mma.sync.m16n8k16 with fp32
//     accumulators; p never leaves registers (the S accumulator is repacked
//     as the A operand of the p v product);
//   - online softmax in base 2: scale * log2(e) and the per-key mask row
//     (padding and the ragged tail, staged in shared memory as 0 / -inf)
//     fold into one FMA per score; exp2 runs on the SFU (ex2.approx); (m, l,
//     acc) are carried in registers across KV tiles;
//   - K/V tiles of 32 rows are double-buffered in shared memory with
//     cp.async, so the next tile's load overlaps this tile's math; rows are
//     padded by 8 halves so ldmatrix reads are free of bank conflicts.
// The cp.async/ldmatrix primitives, the softmax, the p v product and the
// store are shared with K3 (flash_attention_qk8.cu) in flash_common.cuh.
// At the FLUX shape this runs at about a quarter of the bf16 peak (PERF.md);
// wgmma/TMA and warp specialisation, the way to Hopper's full rate, are
// later work.

#include "flash_common.cuh"

namespace {

using namespace gie;

constexpr int kWarps = 4;
constexpr int kMT = 2;        // m16 row tiles per warp
constexpr int kBlockM = kWarps * 16 * kMT;  // query rows per thread block
constexpr int kBlockN = 32;   // keys per KV tile
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // halves of padding per shared-memory row

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* q_seg;     // (B, Sq) or null
  const int32_t* kv_seg;    // (B, Skv) or null
  const uint8_t* kv_keep;   // (B, Skv) or null; 0 = masked key
  const float* bias;        // additive, element strides below, or null
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  int B, Sq, Skv, Hq, Hkv, group;
  int causal;
  float scale_log2;         // scale * log2(e)
};

// The per-key part of the mask for one KV tile, as an additive row:
// 0 for a key that is in range and kept, -inf otherwise.
__device__ __forceinline__ void load_col_bias(float* dst, const Params& p, int b, int n0,
                                              int tid) {
  for (int i = tid; i < kBlockN; i += kThreads) {
    const int col = n0 + i;
    bool keep = col < p.Skv;
    if (keep && p.kv_keep != nullptr) keep = p.kv_keep[(long long)b * p.Skv + col] != 0;
    dst[i] = keep ? 0.f : -INFINITY;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + kPad;
  constexpr int kNT = kBlockN / 8;  // n8 score tiles per KV tile
  constexpr int kDT = D / 8;        // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBlockM * kStride;       // 2 stages
  T* sV = sK + 2 * kBlockN * kStride;   // 2 stages
  float* sColBias = reinterpret_cast<float*>(sV + 2 * kBlockN * kStride);  // 2 stages

  const int m_start = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // accumulator row within an m16 tile
  const int tig = lane & 3;  // accumulator column pair
  const int off = p.Skv - p.Sq;  // end-aligned causal diagonal
  const int warp_row = warp * 16 * kMT;  // first row of this warp within the block

  const long long q_row_stride = (long long)p.Hq * D;
  const long long kv_row_stride = (long long)p.Hkv * D;
  const T* q_base = reinterpret_cast<const T*>(p.q) + ((long long)b * p.Sq * p.Hq + h) * D;
  const T* k_base = reinterpret_cast<const T*>(p.k) + ((long long)b * p.Skv * p.Hkv + hk) * D;
  const T* v_base = reinterpret_cast<const T*>(p.v) + ((long long)b * p.Skv * p.Hkv + hk) * D;
  T* o_base = reinterpret_cast<T*>(p.o) + ((long long)b * p.Sq * p.Hq + h) * D;

  int n_tiles = (p.Skv + kBlockN - 1) / kBlockN;
  if (p.causal) {
    int last = m_start + kBlockM - 1 + off;  // last key any row of this block sees
    if (last > p.Skv - 1) last = p.Skv - 1;
    n_tiles = last < 0 ? 0 : last / kBlockN + 1;
  }

  if (n_tiles > 0) {
    load_tile<T, D, kBlockM, kStride, kThreads>(sQ, q_base, q_row_stride, m_start, p.Sq, tid);
    load_tile<T, D, kBlockN, kStride, kThreads>(sK, k_base, kv_row_stride, 0, p.Skv, tid);
    load_tile<T, D, kBlockN, kStride, kThreads>(sV, v_base, kv_row_stride, 0, p.Skv, tid);
    load_col_bias(sColBias, p, b, 0, tid);
    cp_async_commit();
  }

  // this thread's rows: m_start + warp_row + mt * 16 + g + 8 * i
  int qseg[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m_start + warp_row + mt * 16 + g + 8 * i;
      qseg[mt][i] = (p.q_seg != nullptr && r < p.Sq) ? p.q_seg[(long long)b * p.Sq + r] : 0;
    }
  }
  const bool any_elem_mask = p.kv_seg != nullptr || p.bias != nullptr;

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
      load_tile<T, D, kBlockN, kStride, kThreads>(sK + (stage ^ 1) * kBlockN * kStride, k_base,
                                                  kv_row_stride, (j + 1) * kBlockN, p.Skv, tid);
      load_tile<T, D, kBlockN, kStride, kThreads>(sV + (stage ^ 1) * kBlockN * kStride, v_base,
                                                  kv_row_stride, (j + 1) * kBlockN, p.Skv, tid);
      load_col_bias(sColBias + (stage ^ 1) * kBlockN, p, b, (j + 1) * kBlockN, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + stage * kBlockN * kStride;
    const T* cV = sV + stage * kBlockN * kStride;

    // s = q k^T for this warp's kMT x 16 rows x kBlockN keys; each K
    // fragment feeds kMT products
    float s[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = warp_row + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qf[mt], smem_u32(sQ + r * kStride + c));
      }
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t bk[4];
        const int r = n2 * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        const int c = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bk, smem_u32(cK + r * kStride + c));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          Ops<T>::mma(s[mt][2 * n2], qf[mt], bk[0], bk[1]);
          Ops<T>::mma(s[mt][2 * n2 + 1], qf[mt], bk[2], bk[3]);
        }
      }
    }

    // scale to base 2 and mask: the per-key row (padding, ragged tail) is an
    // additive 0/-inf; segments, the causal diagonal and a bias go per element
    const int n_start = j * kBlockN;
    const float* cBias = sColBias + stage * kBlockN;
    const bool need_mask = any_elem_mask || (p.causal && n_start + kBlockN - 1 > m_start + off);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float2 cb = *reinterpret_cast<const float2*>(cBias + nt * 8 + tig * 2);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = fmaf(s[mt][nt][c], p.scale_log2, (c & 1) ? cb.y : cb.x);
          if (need_mask) {
            const int r = m_start + warp_row + mt * 16 + g + (c >> 1) * 8;
            const int col = n_start + nt * 8 + tig * 2 + (c & 1);
            bool keep = col < p.Skv && r < p.Sq;
            if (keep && p.causal) keep = col <= r + off;
            if (keep && p.kv_seg != nullptr)
              keep = p.kv_seg[(long long)b * p.Skv + col] == qseg[mt][c >> 1];
            if (keep && p.bias != nullptr)
              x += p.bias[b * p.bias_sb + h * p.bias_sh + r * p.bias_sq + col * p.bias_sk] * kLog2e;
            x = keep ? x : -INFINITY;
          }
          s[mt][nt][c] = x;
        }
      }
    }

    // online softmax; a row's scores are spread over the 4 lanes of a quad
    online_softmax<kMT, kNT, kDT>(s, m_i, l_i, acc);
    // acc += p v, with p repacked from the score accumulators
    accumulate_pv<T, kMT, kNT, kDT, kStride>(s, acc, cV, lane);
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }
  cp_async_wait<0>();
  store_rows<T, kMT, kDT>(acc, l_i, o_base, q_row_stride, m_start + warp_row, p.Sq, lane);
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kStride = D + kPad;
  const size_t smem =
      (size_t)(kBlockM + 4 * kBlockN) * kStride * sizeof(T) + 2 * kBlockN * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.Hq, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. Returns the cudaError_t of the launch.
extern "C" int gie_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       const void* q_seg, const void* kv_seg, const void* kv_keep,
                                       const void* bias, long long bias_sb, long long bias_sh,
                                       long long bias_sq, long long bias_sk, int B, int Sq,
                                       int Skv, int Hq, int Hkv, int D, int dtype, int causal,
                                       float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_seg = static_cast<const int32_t*>(q_seg);
  p.kv_seg = static_cast<const int32_t*>(kv_seg);
  p.kv_keep = static_cast<const uint8_t*>(kv_keep);
  p.bias = static_cast<const float*>(bias);
  p.bias_sb = bias_sb;
  p.bias_sh = bias_sh;
  p.bias_sq = bias_sq;
  p.bias_sk = bias_sk;
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_head_dim<__nv_bfloat16>(p, D, s);
  if (dtype == 1) return (int)dispatch_head_dim<__half>(p, D, s);
  return (int)cudaErrorInvalidValue;
}
