// Fused LayerNorm + adaLN modulate + int8 row quantization for Hopper
// (sm_90a), bf16 in, int8 and one fp32 scale per row out.
//
// Replaces the Pallas TPU kernel `_kernel` of
// gpt_image_edit_tpu/ops/pallas/fused_quant.py (entry
// `ln_modulate_quant_rows`), the prologue of every W8A8 FLUX block.
//
// What it computes, per row x of (B, S, D) with the shift/scale rows of its
// batch entry:
//   mean = sum(x) / D, var = sum((x - mean)^2) / D            (fp32)
//   ln   = bf16((x - mean) * rsqrt(var + eps))                 (no affine)
//   mod  = bf16(bf16(ln * bf16(1 + scale)) + shift)            (bf16 ops)
//   s    = max(max|mod| / 127, 1e-8)                           (fp32)
//   q    = clip(round_half_even(mod / s), -127, 127)           (int8)
// which is quantize_rows(modulate(layer_norm(x), shift, scale)) with each
// bf16 op rounded where the unfused chain rounds it. The division is an
// IEEE division (not a multiply by 1/s) and the rounding is rint (half to
// even, as jnp.round and torch.round), so the codes agree with the chain's
// up to the fp32 reduction order of the mean, variance and absmax.
//
// What bounds it: bytes. Each element is read once as bf16 and written once
// as int8, plus a 4-byte scale per row: 75.5 MB at the 8,192-row image site
// of FLUX at 1024^2 (D = 3072), about 22.5 us at 3.35 TB/s. It does a few
// operations per byte, far below the card's ridge.
//
// What the design does about it: one warp per row, the whole row held in
// registers from one pass of 16-byte loads (D = 3072 is 12 loads of 8 bf16
// per lane), so x is read from device memory once and the int8 row and its
// scale are written once, coalesced (8-byte stores of 8 codes per lane).
// The mean, the centred variance and the absmax are warp shuffles. Any S
// and any batch run (shift/scale are per batch entry); D up to 4096, in
// 16-byte vectors when D % 8 == 0 and element by element otherwise. No row
// blocks, so no alignment and no fallback.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per thread block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 4096;

struct Params {
  const __nv_bfloat16* x;      // (B, S, D)
  const __nv_bfloat16* shift;  // (B, D)
  const __nv_bfloat16* scale;  // (B, D)
  int8_t* q;                   // (B, S, D)
  float* s;                    // (B, S)
  long long rows;              // B * S
  int S, D;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC elements per load (8: one 16-byte vector, or 1), E elements per lane:
// lane l holds elements (l + 32 i) * VEC + j, i < E / VEC, j < VEC.
template <int VEC, int E>
__global__ void __launch_bounds__(kThreads) ln_modulate_quant_kernel(const Params p) {
  constexpr int kChunks = E / VEC;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // whole warps only
  const long long b = row / p.S;
  const __nv_bfloat16* xr = p.x + row * p.D;
  const __nv_bfloat16* shr = p.shift + b * p.D;
  const __nv_bfloat16* scr = p.scale + b * p.D;

  float v[E];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int e0 = (lane + 32 * i) * VEC;
    if (e0 < p.D) {
      if constexpr (VEC == 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + e0);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i * 8 + j] = __bfloat162float(h[j]);
      } else {
        v[i] = __bfloat162float(xr[e0]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i * VEC + j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum += v[i * VEC + j];
  }
  const float mean = __fdiv_rn(warp_sum(sum), (float)p.D);

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if ((lane + 32 * i) * VEC < p.D) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[i * VEC + j] - mean;
        sq += __fmul_rn(d, d);
      }
    }
  }
  const float rstd = rsqrtf(__fdiv_rn(warp_sum(sq), (float)p.D) + p.eps);

  // ln -> bf16, then the modulate in bf16 steps; v becomes the modulated row
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int e0 = (lane + 32 * i) * VEC;
    if (e0 < p.D) {
      float sh[VEC], sc[VEC];
      if constexpr (VEC == 8) {
        const uint4 rsh = *reinterpret_cast<const uint4*>(shr + e0);
        const uint4 rsc = *reinterpret_cast<const uint4*>(scr + e0);
        const __nv_bfloat16* hsh = reinterpret_cast<const __nv_bfloat16*>(&rsh);
        const __nv_bfloat16* hsc = reinterpret_cast<const __nv_bfloat16*>(&rsc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sh[j] = __bfloat162float(hsh[j]);
          sc[j] = __bfloat162float(hsc[j]);
        }
      } else {
        sh[0] = __bfloat162float(shr[e0]);
        sc[0] = __bfloat162float(scr[e0]);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float ln = round_bf16(__fmul_rn(v[i * VEC + j] - mean, rstd));
        const float m1 = round_bf16(__fmul_rn(ln, round_bf16(__fadd_rn(1.f, sc[j]))));
        const float m = round_bf16(__fadd_rn(m1, sh[j]));
        v[i * VEC + j] = m;
        amax = fmaxf(amax, fabsf(m));
      }
    }
  }
  const float s = fmaxf(__fdiv_rn(warp_max(amax), 127.f), 1e-8f);

  int8_t* qr = p.q + row * p.D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int e0 = (lane + 32 * i) * VEC;
    if (e0 < p.D) {
      uint32_t packed[2] = {0u, 0u};  // VEC codes, little-endian bytes
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i * VEC + j], s)), -127.f), 127.f);
        packed[j >> 2] |= (uint32_t)(uint8_t)(int8_t)r << (8 * (j & 3));
      }
      if constexpr (VEC == 8) {
        *reinterpret_cast<uint2*>(qr + e0) = make_uint2(packed[0], packed[1]);
      } else {
        qr[e0] = (int8_t)(uint8_t)packed[0];
      }
    }
  }
  if (lane == 0) p.s[row] = s;
}

template <int VEC, int E>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long blocks = (p.rows + kWarps - 1) / kWarps;
  ln_modulate_quant_kernel<VEC, E><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The smallest per-lane register row that holds D.
template <int VEC>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  const int per_lane = (p.D + 31) / 32;
  if (per_lane <= 8) return launch<VEC, 8>(p, stream);
  if (per_lane <= 16) return launch<VEC, 16>(p, stream);
  if (per_lane <= 32) return launch<VEC, 32>(p, stream);
  if (per_lane <= 64) return launch<VEC, 64>(p, stream);
  if (per_lane <= 96) return launch<VEC, 96>(p, stream);
  return launch<VEC, 128>(p, stream);
}

}  // namespace

// Returns the cudaError_t of the launch; D must be in [1, 4096].
extern "C" int gie_ln_modulate_quant(const void* x, const void* shift, const void* scale, void* q,
                                     void* s, int B, int S, int D, float eps, void* stream) {
  if (D < 1 || D > kMaxD || B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.shift = static_cast<const __nv_bfloat16*>(shift);
  p.scale = static_cast<const __nv_bfloat16*>(scale);
  p.q = static_cast<int8_t*>(q);
  p.s = static_cast<float*>(s);
  p.rows = (long long)B * S;
  p.S = S;
  p.D = D;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte loads of x, shift and scale and 8-byte stores of q need D % 8
  // == 0 and aligned rows
  const bool vec = D % 8 == 0 &&
                   ((uintptr_t)x | (uintptr_t)shift | (uintptr_t)scale) % 16 == 0 &&
                   (uintptr_t)q % 8 == 0;
  return (int)(vec ? dispatch<8>(p, st) : dispatch<1>(p, st));
}
