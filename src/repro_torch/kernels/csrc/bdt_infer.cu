// Node-parallel quantized BDT inference: feature select, compare, the
// depth routing steps and the 14-bit hi/lo leaf readout for a tile of
// events in one launch.
//
// Replaces: repro/kernels/bdt_infer/bdt_infer.py bdt_infer_pallas (body
// _kernel). Same arithmetic: fval = sum_f x[:, f] * featsel[f, :] in
// wrapping int32, cond = fval <= thr, h = root, then `depth` times
// h = (h*cond) @ left + (h - h*cond) @ right in float32, and
// out = (int(h @ value_hi) << 14) + int(h @ value_lo), all 128 columns.
//
// Bound on the H100: per event the two routing products are
// 2 * depth * P * P multiply-adds and the readout 2 * P * 128, against
// F * 4 bytes of features in and 128 * 4 bytes out, so the operations
// bound it (989 TFLOP/s on the tensor cores for its 0/1 operands). This
// first kernel runs them literally on the CUDA cores in float32, so it
// stays at least 15x above that bound.
//
// Design: a block owns a tile of events and keeps, per event, the
// compare bits, the one-hot traversal state h and its two routed halves
// (4 x P x tile f32, event fastest) in dynamic shared memory. Each
// product is a thread per (output column, 8 events): it walks the P
// rows, reads one float of each child matrix (adjacent threads, adjacent
// columns: coalesced, cached in L1 across the block's threads) and
// accumulates 8 events against two float4 broadcast reads of shared
// memory. Barriers separate the elementwise split, the product and the
// write of the new h. Integer steps run in uint32 so that wrapping is
// defined; float-to-int conversions truncate, as the reference's casts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEv = 8;          // events per thread
constexpr int kMaxThreads = 512;
constexpr int kOut = 128;       // output columns (column 0 holds the score)

__device__ __forceinline__ void load8(const float* p, float v[kEv]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__global__ void __launch_bounds__(kMaxThreads)
bdt_infer_kernel(const int* __restrict__ x,          // (B, F)
                 const int* __restrict__ featsel,    // (F, P)
                 const int* __restrict__ thr,        // (P,)
                 const float* __restrict__ root,     // (P,)
                 const float* __restrict__ left,     // (P, P)
                 const float* __restrict__ right,    // (P, P)
                 const float* __restrict__ vhi,      // (P, 128)
                 const float* __restrict__ vlo,      // (P, 128)
                 int* __restrict__ out,              // (B, 128)
                 int B, int F, int P, int depth, int tile) {
  extern __shared__ __align__(16) float smem[];
  const size_t PT = (size_t)P * tile;
  float* cond = smem;               // [P][tile]
  float* h = smem + PT;             // [P][tile]
  float* gl = smem + 2 * PT;        // [P][tile]  h * cond
  float* gr = smem + 3 * PT;        // [P][tile]  h - h * cond
  const int b0 = blockIdx.x * tile;
  const int n_ev = min(tile, B - b0);

  // feature MAC (wrapping int32), compare, root one-hot
  for (int i = threadIdx.x; i < P * tile; i += blockDim.x) {
    const int p = i / tile, t = i - p * tile;
    uint32_t fval = 0u;
    if (t < n_ev) {
      const int* xr = x + (size_t)(b0 + t) * F;
      for (int f = 0; f < F; ++f)
        fval += (uint32_t)xr[f] * (uint32_t)featsel[(size_t)f * P + p];
    }
    cond[i] = (int)fval <= thr[p] ? 1.f : 0.f;
    h[i] = root[p];
  }
  __syncthreads();

  const int items = P * (tile / kEv);
  for (int d = 0; d < depth; ++d) {
    for (int i = threadIdx.x; i < P * tile; i += blockDim.x) {
      const float g = h[i] * cond[i];
      gl[i] = g;
      gr[i] = h[i] - g;
    }
    __syncthreads();
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int q = it % P;
      const int t0 = (it / P) * kEv;
      float al[kEv], ar[kEv];
#pragma unroll
      for (int e = 0; e < kEv; ++e) al[e] = ar[e] = 0.f;
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        const float wl = __ldg(left + (size_t)p * P + q);
        const float wr = __ldg(right + (size_t)p * P + q);
        float a[kEv], b[kEv];
        load8(gl + (size_t)p * tile + t0, a);
        load8(gr + (size_t)p * tile + t0, b);
#pragma unroll
        for (int e = 0; e < kEv; ++e) {
          al[e] = fmaf(a[e], wl, al[e]);
          ar[e] = fmaf(b[e], wr, ar[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < kEv; ++e)
        h[(size_t)q * tile + t0 + e] = __fadd_rn(al[e], ar[e]);
    }
    __syncthreads();
  }

  // leaf readout: 14-bit halves, exact in float32
  for (int it = threadIdx.x; it < kOut * (tile / kEv); it += blockDim.x) {
    const int j = it % kOut;
    const int t0 = (it / kOut) * kEv;
    float hi[kEv], lo[kEv];
#pragma unroll
    for (int e = 0; e < kEv; ++e) hi[e] = lo[e] = 0.f;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float wh = __ldg(vhi + (size_t)p * kOut + j);
      const float wl = __ldg(vlo + (size_t)p * kOut + j);
      float a[kEv];
      load8(h + (size_t)p * tile + t0, a);
#pragma unroll
      for (int e = 0; e < kEv; ++e) {
        hi[e] = fmaf(a[e], wh, hi[e]);
        lo[e] = fmaf(a[e], wl, lo[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kEv; ++e) {
      if (t0 + e < n_ev) {
        const uint32_t v = ((uint32_t)__float2int_rz(hi[e]) << 14) +
                           (uint32_t)__float2int_rz(lo[e]);
        out[(size_t)(b0 + t0 + e) * kOut + j] = (int)v;
      }
    }
  }
}

}  // namespace

extern "C" {

// x (B, F) i32; featsel (F, P) i32; thr (P,) i32; root (P,) f32; left,
// right (P, P) f32; value_hi, value_lo (P, 128) f32 -> out (B, 128) i32.
// `tile` is a multiple of 8 whose 4 x P x tile x 4 B fit in shared
// memory. Launches on `stream`; returns cudaGetLastError (or the
// cudaFuncSetAttribute error).
int bdt_infer_launch(const void* x, const void* featsel, const void* thr,
                     const void* root, const void* left, const void* right,
                     const void* value_hi, const void* value_lo, void* out,
                     int B, int F, int P, int depth, int tile,
                     void* stream) {
  if (B <= 0) return 0;
  if (tile <= 0 || tile % kEv) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * P * tile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bdt_infer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int items = (P > kOut ? P : kOut) * (tile / kEv);
  int threads = items < kMaxThreads ? items : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid((B + tile - 1) / tile);
  bdt_infer_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)featsel, (const int*)thr,
      (const float*)root, (const float*)left, (const float*)right,
      (const float*)value_hi, (const float*)value_lo, (int*)out, B, F, P,
      depth, tile);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
