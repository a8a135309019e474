// Smart-pixel featurizer: charge frame (T=8, Y=13, X=21) -> 13-bin y-profile
// + y0, one event per warp.
//
// Replaces: repro/kernels/yprofile/yprofile.py yprofile_pallas_stacked
// (_kernel_stacked) and yprofile_pallas (the same at C=1). The TPU kernel
// reduces a tile of flattened, 128-padded frames with a one-hot fold
// matrix on the MXU. Here the reduction is direct: the frame is summed
// over t and x into its y bins, with no padding, no fold matrix and no
// reshape copy — the (C, B, 8, 13, 21) frames are read in place.
//
// Bound on the H100: device-memory bytes. Every input float is read once
// and added once (2,184 adds per event against 8,736 bytes), so the
// kernel can at best stream the frames at the memory rate. Design for
// that: a warp owns one event; its lanes walk the event's 546 float4s
// with a stride of 32, so each warp load instruction covers 512
// contiguous bytes. Each lane keeps 13 partial sums in a shared-memory
// column of its own (bin-major, lane-minor: conflict-free, no atomics,
// no synchronisation), then a butterfly shuffle sums the 32 columns of
// each bin. The sum order is fixed per event (not per batch or chip), so
// an event's features do not depend on where it sits in a dispatch.
//
// The epilogue keeps the reference's arithmetic: max(p, 0), p > thr ? p :
// 0, then an IEEE division by 1000 (nvcc's default -prec-div=true; no
// fast-math), y0 in column 13 and zeros in the pad columns of the
// (C, B, 128) output. There is no product anywhere, so TF32 is moot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 8, kY = 13, kX = 21;
constexpr int kCells = kT * kY * kX;       // 2184 floats per event
constexpr int kVec = kCells / 4;           // 546 float4 (8736 B, 16-aligned)
constexpr int kCols = 128;                 // public output width
constexpr int kWarps = 4;                  // events per block

__global__ void __launch_bounds__(kWarps * 32)
yprofile_kernel(const float4* __restrict__ frames,
                const float* __restrict__ y0,
                float* __restrict__ out,
                long long n_events, float threshold) {
  __shared__ float acc[kWarps][kY][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * kWarps + warp;
  if (e >= n_events) return;               // whole warps only: no barriers

  float (*a)[32] = acc[warp];
#pragma unroll
  for (int b = 0; b < kY; ++b) a[b][lane] = 0.0f;

  const float4* f = frames + e * kVec;
  for (int j = lane; j < kVec; j += 32) {
    const float4 v = __ldcs(f + j);        // streamed once: evict first
    const int i = 4 * j;                   // flat (t, y, x) cell index
    a[((i + 0) / kX) % kY][lane] += v.x;
    a[((i + 1) / kX) % kY][lane] += v.y;
    a[((i + 2) / kX) % kY][lane] += v.z;
    a[((i + 3) / kX) % kY][lane] += v.w;
  }

  float mine = 0.0f;                       // lane b keeps bin b
#pragma unroll
  for (int b = 0; b < kY; ++b) {
    float s = a[b][lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == b) mine = s;
  }
  float p = fmaxf(mine, 0.0f);
  p = (p > threshold) ? p : 0.0f;
  p = p / 1000.0f;

  float* o = out + e * kCols;
  o[lane] = (lane < kY) ? p : (lane == kY ? 0.0f + y0[e] : 0.0f);
  o[32 + lane] = 0.0f;
  o[64 + lane] = 0.0f;
  o[96 + lane] = 0.0f;
}

}  // namespace

extern "C" {

// frames: (n_events, 8, 13, 21) f32 contiguous; y0: (n_events,) f32;
// out: (n_events, 128) f32. Launches on `stream`; returns cudaGetLastError.
int yprofile_launch(const void* frames, const void* y0, void* out,
                    long long n_events, float threshold, void* stream) {
  if (n_events <= 0) return 0;
  const long long blocks = (n_events + kWarps - 1) / kWarps;
  yprofile_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                    (cudaStream_t)stream>>>(
      (const float4*)frames, (const float*)y0, (float*)out, n_events,
      threshold);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
