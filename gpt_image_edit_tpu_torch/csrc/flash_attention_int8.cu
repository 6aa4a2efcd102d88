// Flash-attention forward with int8 q k^T AND int8 p v for Hopper (sm_90a),
// BSHD layout.
//
// Replaces the Pallas TPU kernel `_resident_int8_kernel` of
// gpt_image_edit_tpu/ops/pallas/flash_attention.py (entry
// `flash_attention_int8`, the `--quantize w8a8-attn` serving mode).
//
// What it computes, per (batch, head, query row), over the keys in groups
// of kGroup = 512 (the Pallas kernel's block_kv; a ragged last group is
// shorter):
//   s_j   = float(q8 . k8_j) * (qs * ks_j) * (scale * log2 e), or
//           kNegInf (-0.7 FLT_MAX) for a masked key
//   m_new = max(m, max_j s_j over the whole group)
//   p_j   = 2^(s_j - m_new), 0 for a masked key;  alpha = 2^(m - m_new)
//   p_max = max(max_j p_j, 1e-8);  p8_j = round_half_even(p_j * (127 / p_max))
//   l     = alpha * l + sum_j p_j
//   acc   = acc * alpha + float(sum_j p8_j v8_j) * (p_max / 127)
//   out   = (acc / l) * vs   (l = 0 -> 1, so a row that sees no key gives 0)
// with q8/k8 int8 per (batch, row, head) over d and v8 int8 per (batch, kv
// head, feature column) over all keys (vs its column scales), quantized by
// the wrapper as the JAX wrapper does outside Pallas. Masks: a kv pad mask,
// segment ids and an end-aligned causal mask; GQA reads kv head h / (Hq /
// Hkv). Any Sq and Skv: keys past Skv are masked, which is the Pallas
// function on the input zero-padded to a multiple of 512.
//
// The group's maximum has to be known before any p of the group is
// quantized, so each group is read twice (two passes over its K tiles):
//   pass 0: int8 q k^T, scale, mask, running row max -> m_new, alpha and
//           p_max = max(2^(max_j s_j - m_new), 1e-8), which is the largest
//           p of the group (2^x and the rounded subtraction are monotonic);
//   pass 1: int8 q k^T again (the same exact int32 dots, so the same
//           scores), p, its row sum, p8, and p8 v on the int8 tensor cores
//           into an int32 accumulator (at most 127 * 127 * 512 ~ 8.3e6 per
//           group: exact in int32 and in fp32), folded into acc once at the
//           end of the group.
//
// What bounds it: at the FLUX serving shape (B=1, S=8704, 24 heads, d=128)
// one call is 4*B*H*S*S*d = 9.3e11 int8 operations (two products; the
// second q k^T pass is work this design adds) at 1,979 TOP/s, about 0.47
// ms, and B*H*S*S = 1.8e9 exp2 on the special-function units (16 per SM
// per clock on sm_90, ~0.44 ms at the boost clock); the bytes (int8 q, k,
// v, bf16 out) take ~0.03 ms. Operations bound it.
//
// What the design does about it: FA2's tiling on mma.sync, every product
// int8:
//   - one thread block of 4 warps per (64 query rows, head, batch); each
//     warp owns one m16 row tile, so the fp32 output accumulator, the int32
//     group accumulator and a 64-key score tile fit in registers;
//   - q k^T runs as mma.sync.m16n8k32.s32.s8.s8.s32. The key order inside a
//     32-key chunk is permuted when K's rows are addressed for ldmatrix, so
//     that the score accumulator a lane holds (2 keys of each of 4 n8
//     tiles) is the 4-consecutive-key A fragment of the p v product: p8 is
//     packed in registers, with no shuffle and no trip through shared
//     memory;
//   - v arrives transposed, (B, Hkv, D, Skv padded to 64), from the
//     wrapper: the B operand of m16n8k32.s8 wants 4 consecutive keys per
//     register and ldmatrix has no 8-bit transpose;
//   - K and V^T tiles of 64 keys are double-buffered with cp.async; a
//     causal block stops at its last visible key.
// This is the simple route; wgmma/TMA with warp specialisation would be
// the fast one.

#include <float.h>
#include <limits.h>

#include "flash_common.cuh"

namespace {

using namespace gie;

constexpr int kD = 128;        // head dim (FLUX's)
constexpr int kWarps = 4;
constexpr int kBlockM = kWarps * 16;  // query rows per thread block
constexpr int kBlockN = 64;    // keys per tile
constexpr int kGroup = 512;    // keys per p requantization group (Pallas block_kv)
constexpr int kTilesPerGroup = kGroup / kBlockN;
constexpr int kThreads = kWarps * 32;
constexpr int kStrideQK = kD + 16;    // bytes per int8 q/k row in shared memory
constexpr int kStrideV = kBlockN + 16;  // bytes per int8 v^T row (one feature, 64 keys)
constexpr int kNT = kBlockN / 8;      // n8 score tiles per K tile
constexpr int kDT = kD / 8;           // n8 output tiles
constexpr int kMaskedSeg = INT_MIN;   // segment id staged for a masked key
// the Pallas kernel's finite mask value, -0.7 * FLT_MAX rounded once
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);

struct Params {
  const int8_t* q;          // (B, Sq, Hq, D)
  const int8_t* k;          // (B, Skv, Hkv, D)
  const int8_t* vt;         // (B, Hkv, D, Skv_pad), keys past Skv zero
  __nv_bfloat16* o;         // (B, Sq, Hq, D)
  const float* q_scale;     // (B, Sq, Hq)
  const float* k_scale;     // (B, Skv, Hkv)
  const float* v_scale;     // (B, Hkv, D)
  const uint8_t* kv_keep;   // (B, Skv) or null; 0 = masked key
  const int* q_seg;         // (B, Sq) or null
  const int* kv_seg;        // (B, Skv) or null
  int B, Sq, Skv, Skv_pad, Hq, Hkv, group;
  int causal;
  float scale_log2;         // scale * log2(e)
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The key (within a 32-key chunk) that column c of n8 score tile t (0..3)
// stands for. A lane holds columns 2*tig and 2*tig+1 of each tile, which
// are keys 4*tig .. 4*tig+3 (tiles 0, 1) and 16 + 4*tig .. (tiles 2, 3):
// the A fragment layout of mma.m16n8k32.s8.
__device__ __forceinline__ int chunk_key(int t, int c) {
  return (t >> 1) * 16 + (c >> 1) * 4 + (t & 1) * 2 + (c & 1);
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// Per K tile: the key scales and each key's segment id, kMaskedSeg for a
// padded key or one past Skv (scaled by 0).
__device__ __forceinline__ void load_key_terms(float* ks, int* kseg, const Params& p, int b,
                                               int hk, int n0, int tid) {
  for (int i = tid; i < kBlockN; i += kThreads) {
    const int col = n0 + i;
    float s = 0.f;
    int seg = kMaskedSeg;
    if (col < p.Skv) {
      s = p.k_scale[((long long)b * p.Skv + col) * p.Hkv + hk];
      const bool keep = p.kv_keep == nullptr || p.kv_keep[(long long)b * p.Skv + col] != 0;
      if (keep) seg = p.kv_seg == nullptr ? 0 : p.kv_seg[(long long)b * p.Skv + col];
    }
    ks[i] = s;
    kseg[i] = seg;
  }
}

// The tiles a block visits: group g holds tiles [0, tiles(g)); each tile is
// read by pass 0 (q k^T only) and then pass 1 (q k^T and p v).
struct Step {
  int g, pass, t;
};

__device__ __forceinline__ int tiles_in_group(int g, int n_keys) {
  const int left = n_keys - g * kGroup;
  const int n = (left + kBlockN - 1) / kBlockN;
  return n < kTilesPerGroup ? n : kTilesPerGroup;
}

__device__ __forceinline__ bool advance(Step& s, int n_keys) {
  if (++s.t < tiles_in_group(s.g, n_keys)) return true;
  s.t = 0;
  if (++s.pass < 2) return true;
  s.pass = 0;
  return ++s.g * kGroup < n_keys;
}

__global__ void __launch_bounds__(kThreads) flash_int8_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sK = sQ + kBlockM * kStrideQK;                 // 2 stages
  int8_t* sV = sK + 2 * kBlockN * kStrideQK;             // 2 stages of v^T
  float* sKs = reinterpret_cast<float*>(sV + 2 * kD * kStrideV);  // 2 stages
  int* sKseg = reinterpret_cast<int*>(sKs + 2 * kBlockN);          // 2 stages

  const int m_start = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // accumulator row within the m16 tile
  const int tig = lane & 3;  // accumulator column pair
  const int warp_row = warp * 16;

  const long long q_row_stride = (long long)p.Hq * kD;
  const long long kv_row_stride = (long long)p.Hkv * kD;
  const int8_t* q_base = p.q + ((long long)b * p.Sq * p.Hq + h) * kD;
  const int8_t* k_base = p.k + ((long long)b * p.Skv * p.Hkv + hk) * kD;
  const int8_t* v_base = p.vt + ((long long)b * p.Hkv + hk) * kD * p.Skv_pad;
  __nv_bfloat16* o_base = p.o + ((long long)b * p.Sq * p.Hq + h) * kD;

  // keys this block can see: a causal block stops at the last key visible
  // to its last row (the groups after it are fully masked, which changes
  // nothing: alpha = 1, p = 0)
  int n_keys = p.Skv;
  if (p.causal) {
    const int last = m_start + kBlockM - 1 + (p.Skv - p.Sq);
    n_keys = last + 1 < n_keys ? last + 1 : n_keys;
  }

  // this thread's rows: m_start + warp_row + g + 8 * i
  float qs[2];
  int qseg[2];
  int row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = m_start + warp_row + g + 8 * i;
    const bool ok = row[i] < p.Sq;
    qs[i] = ok ? p.q_scale[((long long)b * p.Sq + row[i]) * p.Hq + h] : 0.f;
    qseg[i] = (ok && p.q_seg != nullptr) ? p.q_seg[(long long)b * p.Sq + row[i]] : 0;
  }

  float acc[kDT][4];
  int acc8[kDT][4];  // this group's int32 p v
  float m_i[2], l_i[2];
  float m_new[2], alpha[2], p_scale[2], p_dequant[2], rowsum[2], m_grp[2];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
    m_grp[i] = kNegInf;
  }

  if (n_keys > 0) {
    auto prefetch = [&](const Step& s, int stage) {
      const int n0 = s.g * kGroup + s.t * kBlockN;
      load_tile<int8_t, kD, kBlockN, kStrideQK, kThreads>(sK + stage * kBlockN * kStrideQK,
                                                          k_base, kv_row_stride, n0, p.Skv, tid);
      if (s.pass == 1) {
        // 128 feature rows of 64 keys each, rows Skv_pad bytes apart
        load_tile<int8_t, kBlockN, kD, kStrideV, kThreads>(sV + stage * kD * kStrideV,
                                                           v_base + n0, p.Skv_pad, 0, kD, tid);
      }
      load_key_terms(sKs + stage * kBlockN, sKseg + stage * kBlockN, p, b, hk, n0, tid);
    };

    load_tile<int8_t, kD, kBlockM, kStrideQK, kThreads>(sQ, q_base, q_row_stride, m_start, p.Sq,
                                                        tid);
    Step cur{0, 0, 0};
    prefetch(cur, 0);
    cp_async_commit();

    uint32_t qf[kD / 32][4];
    int stage = 0;
    bool first = true;
    while (true) {
      Step nxt = cur;
      const bool more = advance(nxt, n_keys);
      if (more) {
        prefetch(nxt, stage ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (first) {  // q fragments stay in registers for the whole row block
#pragma unroll
        for (int kk = 0; kk < kD / 32; ++kk) {
          const int r = warp_row + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int c = kk * 32 + (lane >> 4) * 16;
          ldmatrix_x4(qf[kk], smem_u32(sQ + r * kStrideQK + c));
        }
        first = false;
      }
      const int8_t* cK = sK + stage * kBlockN * kStrideQK;
      const float* cKs = sKs + stage * kBlockN;
      const int* cKseg = sKseg + stage * kBlockN;
      const int n0 = cur.g * kGroup + cur.t * kBlockN;

      // int32 q k^T for this warp's 16 rows x 64 keys; n8 tile nt holds
      // keys (nt / 4) * 32 + chunk_key(nt % 4, column)
      int si[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) si[nt][0] = si[nt][1] = si[nt][2] = si[nt][3] = 0;
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < kNT / 2; ++n2) {
          uint32_t bk[4];
          const int mat = lane >> 3;
          const int nt = 2 * n2 + (mat >> 1);
          const int key = (nt >> 2) * 32 + chunk_key(nt & 3, lane & 7);
          const int c = kk * 32 + (mat & 1) * 16;
          ldmatrix_x4(bk, smem_u32(cK + key * kStrideQK + c));
          mma_s8(si[2 * n2], qf[kk], bk[0], bk[1]);
          mma_s8(si[2 * n2 + 1], qf[kk], bk[2], bk[3]);
        }
      }

      // fp32 base-2 scores, float(dot) * (qs * ks) * scale * log2(e) in
      // that order without fused multiply-adds, kNegInf where masked
      float s[kNT][4];
      bool keep[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = (nt >> 2) * 32 + chunk_key(nt & 3, 2 * tig + (c & 1));
          const int i = c >> 1;
          bool kp = cKseg[j] == qseg[i];
          if (p.causal) kp = kp && (n0 + j <= row[i] + (p.Skv - p.Sq));
          const float qk_scale = __fmul_rn(qs[i], cKs[j]);
          const float x = __fmul_rn(__fmul_rn((float)si[nt][c], qk_scale), p.scale_log2);
          s[nt][c] = kp ? x : kNegInf;
          keep[nt][c] = kp;
        }
      }

      const int n_tiles = tiles_in_group(cur.g, n_keys);
      if (cur.pass == 0) {
        // pass 0: the group's row max
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          m_grp[0] = fmaxf(m_grp[0], fmaxf(s[nt][0], s[nt][1]));
          m_grp[1] = fmaxf(m_grp[1], fmaxf(s[nt][2], s[nt][3]));
        }
        if (cur.t == n_tiles - 1) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float mx = m_grp[i];
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            m_new[i] = fmaxf(m_i[i], mx);
            alpha[i] = fast_exp2(m_i[i] - m_new[i]);
            const float p_max = fmaxf(fast_exp2(mx - m_new[i]), 1e-8f);
            p_scale[i] = __fdiv_rn(127.f, p_max);
            p_dequant[i] = __fdiv_rn(p_max, 127.f);
            rowsum[i] = 0.f;
            m_grp[i] = kNegInf;
          }
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt) acc8[dt][0] = acc8[dt][1] = acc8[dt][2] = acc8[dt][3] = 0;
        }
      } else {
        // pass 1: p, its row sum, p8 and the int8 p v
        int p8[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = c >> 1;
            const float pv = keep[nt][c] ? fast_exp2(s[nt][c] - m_new[i]) : 0.f;
            rowsum[i] += pv;
            p8[nt][c] = min(__float2int_rn(__fmul_rn(pv, p_scale[i])), 127);
          }
        }
        const int8_t* cV = sV + stage * kD * kStrideV;
#pragma unroll
        for (int kc = 0; kc < kBlockN / 32; ++kc) {
          const int t0 = kc * 4;
          uint32_t a[4];
          a[0] = pack_s8(p8[t0][0], p8[t0][1], p8[t0 + 1][0], p8[t0 + 1][1]);
          a[1] = pack_s8(p8[t0][2], p8[t0][3], p8[t0 + 1][2], p8[t0 + 1][3]);
          a[2] = pack_s8(p8[t0 + 2][0], p8[t0 + 2][1], p8[t0 + 3][0], p8[t0 + 3][1]);
          a[3] = pack_s8(p8[t0 + 2][2], p8[t0 + 2][3], p8[t0 + 3][2], p8[t0 + 3][3]);
#pragma unroll
          for (int d2 = 0; d2 < kDT / 2; ++d2) {
            uint32_t bv[4];
            const int mat = lane >> 3;
            const int r = (2 * d2 + (mat >> 1)) * 8 + (lane & 7);
            const int c = kc * 32 + (mat & 1) * 16;
            ldmatrix_x4(bv, smem_u32(cV + r * kStrideV + c));
            mma_s8(acc8[2 * d2], a, bv[0], bv[1]);
            mma_s8(acc8[2 * d2 + 1], a, bv[2], bv[3]);
          }
        }
        if (cur.t == n_tiles - 1) {  // end of the group: fold it into acc and l
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float rs = rowsum[i];
            rs += __shfl_xor_sync(0xffffffffu, rs, 1);
            rs += __shfl_xor_sync(0xffffffffu, rs, 2);
            l_i[i] = __fadd_rn(__fmul_rn(alpha[i], l_i[i]), rs);
            m_i[i] = m_new[i];
          }
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int i = c >> 1;
              acc[dt][c] = __fadd_rn(__fmul_rn(acc[dt][c], alpha[i]),
                                     __fmul_rn((float)acc8[dt][c], p_dequant[i]));
            }
          }
        }
      }
      __syncthreads();  // this stage is refilled by the next iteration's loads
      if (!more) break;
      cur = nxt;
      stage ^= 1;
    }
  }

  // out = (acc / l) * vs, a row that saw no key (l = 0 -> 1, acc = 0) gives 0
  const float* vs = p.v_scale + ((long long)b * p.Hkv + hk) * kD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];
    if (row[i] < p.Sq) {
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const int d = dt * 8 + tig * 2;
        const float o0 = __fmul_rn(__fdiv_rn(acc[dt][2 * i], l), vs[d]);
        const float o1 = __fmul_rn(__fdiv_rn(acc[dt][2 * i + 1], l), vs[d + 1]);
        __nv_bfloat162 v2 = __floats2bfloat162_rn(o0, o1);
        *reinterpret_cast<__nv_bfloat162*>(o_base + row[i] * q_row_stride + d) = v2;
      }
    }
  }
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(kBlockM + 2 * kBlockN) * kStrideQK + (size_t)2 * kD * kStrideV +
                      (size_t)2 * kBlockN * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(flash_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.Hq, p.B);
  flash_int8_kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch; D must be 128 and Skv_pad a
// multiple of 64 that is at least Skv.
extern "C" int gie_flash_attention_int8(const void* q, const void* k, const void* vt, void* o,
                                        const void* q_scale, const void* k_scale,
                                        const void* v_scale, const void* kv_keep,
                                        const void* q_seg, const void* kv_seg, int B, int Sq,
                                        int Skv, int Skv_pad, int Hq, int Hkv, int D, int causal,
                                        float scale_log2, void* stream) {
  if (D != kD || Skv_pad % kBlockN != 0 || Skv_pad < Skv || Hq % Hkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.vt = static_cast<const int8_t*>(vt);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_scale = static_cast<const float*>(q_scale);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.kv_keep = static_cast<const uint8_t*>(kv_keep);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Skv_pad = Skv_pad;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.causal = causal;
  p.scale_log2 = scale_log2;
  return (int)launch(p, static_cast<cudaStream_t>(stream));
}
