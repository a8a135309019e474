// Selection-matmul fabric evaluation, dense and banded: every level's
// routing product, 4-bit LUT index and truth-table read for a tile of
// events, the whole net buffer kept on chip.
//
// Replaces: repro/kernels/lut_eval/lut_eval.py lut_eval_pallas_stacked
// (body _kernel) and lut_eval_pallas_banded_stacked (body
// _banded_kernel), and their C=1 forms lut_eval_pallas /
// lut_eval_pallas_banded. A null `win_base` selects the dense row view
// (all N rows of the buffer); otherwise level l routes from the input
// segment [0, in_seg) followed by the window [win_base[l],
// win_base[l] + rows - in_seg) of the buffer.
//
// Bound on the H100: the routing product is 2 * rows * 4M flops per
// event and level, far more than the bytes (sel is read once per chip,
// the (C, B, N) f32 buffer written once), so at any real batch the
// operations bound it; on the tensor cores (0/1 bf16 operands are exact)
// that is 989 TFLOP/s. This first kernel does the product literally on
// the CUDA cores in float32 (67 TFLOP/s at best), so it stays at least
// 15x above that bound; tensor cores are the redesign.
//
// Design: a block owns one chip row and a tile of `tile` events, and
// keeps the tile's whole net buffer (N x tile f32, event fastest) plus a
// result staging area (M x tile) in dynamic shared memory, opted in
// above 48 KB. The buffer is zeroed, the input segment copied in, then
// the levels run in order. Inside a level a thread owns one LUT m and 8
// events: it walks the level's rows, reads the four bf16 selection
// entries of its LUT's input columns (m, M+m, 2M+m, 3M+m; adjacent
// threads read adjacent m, so the loads coalesce) and accumulates 4 x 8
// float32 products against two float4 reads of the buffer (the same
// address across a warp: a broadcast). The row ranges are resolved
// before the loop, which has no branch, so the loads of 8 unrolled rows
// issue before the first product waits on them: with one 131 KB block
// per SM, the latency of those L2 reads is what limits the kernel. The index is formed with the
// reference's rounding order, an index outside [0, 16) reads 0 as the
// one-hot compare does, and the table value goes to the staging area;
// after a barrier the staging area is copied to the level's slots at
// level_base[l], so no thread reads a slot while another writes it.
// Rows that would fall outside the buffer read 0 and slots outside it
// are not written. Finally the whole buffer is written to (C, B, N).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEv = 8;          // events per thread
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float bf16_to_f32(uint16_t u) {
  return __uint_as_float((uint32_t)u << 16);
}

// acc[k][e] += sum over rows r in [r0, r1) of vals[r + off][t0 + e] *
// sel[r][k*M + m]. No branch in the loop, so the unrolled iterations'
// selection loads are all issued before their products wait on them.
__device__ __forceinline__ void route_rows(float (&acc)[4][kEv],
                                           const uint16_t* __restrict__ S,
                                           const float* vals, int r0, int r1,
                                           int off, int m, int M, int t0,
                                           int tile) {
  const size_t M4 = (size_t)4 * M;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) {
    const uint16_t* s = S + (size_t)r * M4 + m;
    const float s0 = bf16_to_f32(__ldg(s));
    const float s1 = bf16_to_f32(__ldg(s + M));
    const float s2 = bf16_to_f32(__ldg(s + 2 * M));
    const float s3 = bf16_to_f32(__ldg(s + 3 * M));
    const float4* vp =
        reinterpret_cast<const float4*>(vals + (size_t)(r + off) * tile + t0);
    const float4 va = vp[0], vb = vp[1];
    const float v[kEv] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int e = 0; e < kEv; ++e) {
      acc[0][e] = fmaf(v[e], s0, acc[0][e]);
      acc[1][e] = fmaf(v[e], s1, acc[1][e]);
      acc[2][e] = fmaf(v[e], s2, acc[2][e]);
      acc[3][e] = fmaf(v[e], s3, acc[3][e]);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lut_eval_kernel(const float* __restrict__ bits_ext,   // (C, B, in_seg)
                const uint16_t* __restrict__ sel,     // (C, L, rows, 4M)
                const float* __restrict__ tables,     // (C, L, M, 16)
                const int* __restrict__ level_base,   // (L,)
                const int* __restrict__ win_base,     // (L,) or null
                float* __restrict__ out,              // (C, B, N)
                int B, int in_seg, int L, int rows, int M, int N,
                int tile) {
  extern __shared__ __align__(16) float smem[];
  float* vals = smem;                            // [N][tile]
  float* res = smem + (size_t)N * tile;          // [M][tile]
  const int c = blockIdx.y;
  const int b0 = blockIdx.x * tile;
  const int n_ev = min(tile, B - b0);

  // zeroed buffer, input segment (const0 | const1 | inputs | pad) in
  // [0, in_seg); events past B stay zero and are never stored
  for (int i = threadIdx.x; i < N * tile; i += blockDim.x) {
    const int t = i / N, n = i - t * N;
    float v = 0.f;
    if (n < in_seg && t < n_ev)
      v = bits_ext[((size_t)c * B + b0 + t) * in_seg + n];
    vals[(size_t)n * tile + t] = v;
  }
  __syncthreads();

  const int items = M * (tile / kEv);
  const int n_in = min(in_seg, rows);
  for (int l = 0; l < L; ++l) {
    const uint16_t* S = sel + ((size_t)c * L + l) * rows * 4 * M;
    // window rows [in_seg, rows) read buffer row r + shift; the rows
    // whose buffer row would fall outside [0, N) are skipped (read 0)
    const int shift = (win_base ? win_base[l] : in_seg) - in_seg;
    const int w0 = max(in_seg, -shift), w1 = min(rows, N - shift);
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int m = it % M;
      const int t0 = (it / M) * kEv;
      float acc[4][kEv];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < kEv; ++e) acc[k][e] = 0.f;
      route_rows(acc, S, vals, 0, n_in, 0, m, M, t0, tile);
      route_rows(acc, S, vals, w0, w1, shift, m, M, t0, tile);
      const float* tb = tables + (((size_t)c * L + l) * M + m) * 16;
#pragma unroll
      for (int e = 0; e < kEv; ++e) {
        // ((ins0 + 2 ins1) + 4 ins2) + 8 ins3, rounded step by step
        const float f = __fadd_rn(
            __fadd_rn(__fadd_rn(acc[0][e], __fmul_rn(2.f, acc[1][e])),
                      __fmul_rn(4.f, acc[2][e])),
            __fmul_rn(8.f, acc[3][e]));
        const int idx = __float2int_rz(f);
        res[(size_t)m * tile + t0 + e] =
            (idx >= 0 && idx < 16) ? __ldg(tb + idx) : 0.f;
      }
    }
    __syncthreads();
    const int base = level_base[l];
    for (int i = threadIdx.x; i < M * tile; i += blockDim.x) {
      const int n = base + i / tile;
      if (n >= 0 && n < N) vals[(size_t)n * tile + (i % tile)] = res[i];
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < N * n_ev; i += blockDim.x) {
    const int t = i / N, n = i - t * N;
    out[((size_t)c * B + b0 + t) * N + n] = vals[(size_t)n * tile + t];
  }
}

}  // namespace

extern "C" {

// bits_ext (C, B, in_seg) f32; sel (C, L, rows, 4M) bf16; tables
// (C, L, M, 16) f32; level_base (L,) i32; win_base (L,) i32 or null
// (dense) -> out (C, B, N) f32. `tile` is a multiple of 8 whose
// (N + M) x tile x 4 B fit in shared memory. Launches on `stream`;
// returns cudaGetLastError (or the cudaFuncSetAttribute error).
int lut_eval_launch(const void* bits_ext, const void* sel,
                    const void* tables, const void* level_base,
                    const void* win_base, void* out, int C, int B,
                    int in_seg, int L, int rows, int M, int N, int tile,
                    void* stream) {
  if (C <= 0 || B <= 0) return 0;
  if (tile <= 0 || tile % kEv) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(N + M) * tile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lut_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int items = M * (tile / kEv);
  int threads = items < kMaxThreads ? items : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid((B + tile - 1) / tile, C);
  lut_eval_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)bits_ext, (const uint16_t*)sel, (const float*)tables,
      (const int*)level_base, (const int*)win_base, (float*)out, B, in_seg,
      L, rows, M, N, tile);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
