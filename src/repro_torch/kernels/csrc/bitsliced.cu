// Bit-sliced fabric walk with the TMR vote: 32 events per 32-bit word,
// every LUT of every level, every replica, the 2-of-3 vote and the
// per-replica disagreement words, in one launch.
//
// Replaces: repro/kernels/lut_eval/bitsliced.py eval_words_voted (the
// per-level eval_words walk, its loop at :135, and the vote at :228). In
// the JAX package this is jnp that XLA compiles; a torch-op version costs
// about 20 launches per level, so it gets a kernel of its own.
//
// Bound on the H100: per (replica, word, LUT) the 4-input mux tree is 15
// two-way selects of 32-lane words, one LOP3 each, on the integer/logic
// pipe (64 lanes per SM, a quarter of the float32 rate). The truth
// tables are read whatever the word count, so on the 4-chip envelope the
// bytes decide the bound at R=1 at every width and at R=3 up to about 600
// words per chip, the integer operations beyond; at the served widths
// either bound is under a microsecond, and what limits this kernel is the
// latency of its per-level loads and barriers. Design: a block owns one logical chip and
// a tile of `tile` words, and
// keeps the whole net buffer of all R replicas for that tile in dynamic
// shared memory (R * n_nets * tile * 4 bytes, opted in above 48 KB), so
// the level walk never touches device memory except to read each LUT's
// four source indices and truth table. Levels run in order with a
// barrier between them; inside a level every thread takes (replica, LUT,
// word) items, word fastest, so the `tile` threads of one LUT read
// adjacent words of the same source nets. What limits it is the latency
// of those per-LUT loads, paid once per serial pass of a level: blocks of
// 1,024 threads make a level one pass (R=1) or three (R=3) at the tile
// the wrapper picks, and the wrapper narrows the tile until every SM has
// a block. The truth table's 16 entries become all-ones / all-zeros masks
// (`table > 0.5`), and the mux tree is the one of bitsliced.py:141-143,
// on unsigned words (the torch side carries them as int32 bit patterns).
//
// Padded LUT slots read net 0 (const0) with an all-zero table, so they
// write 0. Const1 is all ones in every lane, tail lanes included; the
// caller's valid mask drops those lanes later, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t mux(uint32_t s, uint32_t hi,
                                        uint32_t lo) {
  return (s & hi) | (~s & lo);
}

__device__ __forceinline__ uint32_t mask(float t) {
  return t > 0.5f ? 0xFFFFFFFFu : 0u;
}

__global__ void __launch_bounds__(kThreads)
eval_words_voted_kernel(const uint32_t* __restrict__ in_words,  // (C, W, in_seg)
                        const int4* __restrict__ src,           // (R*C, L, M)
                        const float4* __restrict__ tables,      // (R*C, L, M, 4)
                        const int* __restrict__ output_nets,    // (R*C, O)
                        uint32_t* __restrict__ voted,           // (C, W, O)
                        uint32_t* __restrict__ dis,             // (C, R, W)
                        int R, int W, int in_seg, int L, int M, int O,
                        int tile) {
  extern __shared__ uint32_t vals[];       // [R][n_nets][tile]
  const int c = blockIdx.y;
  const int w0 = blockIdx.x * tile;
  const int n_nets = in_seg + L * M;
  const int T = tile;

  // input segment (const0 | const1 | input bits | pad), shared by the
  // replicas of this chip; words past W are zero and never stored back
  for (int idx = threadIdx.x; idx < in_seg * T; idx += blockDim.x) {
    const int t = idx / in_seg, net = idx - t * in_seg;
    const int w = w0 + t;
    const uint32_t v =
        w < W ? in_words[((size_t)c * W + w) * in_seg + net] : 0u;
    for (int r = 0; r < R; ++r) vals[((size_t)r * n_nets + net) * T + t] = v;
  }
  __syncthreads();

  const int items = R * M * T;
  for (int l = 0; l < L; ++l) {
    const int base = in_seg + l * M;
    for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
      const int t = idx % T;
      const int rm = idx / T;
      const int m = rm % M, r = rm / M;
      const size_t lut = ((size_t)(c * R + r) * L + l) * M + m;
      const int4 s = src[lut];
      const float4* tb = tables + lut * 4;
      const float4 q0 = tb[0], q1 = tb[1], q2 = tb[2], q3 = tb[3];
      uint32_t* V = vals + (size_t)r * n_nets * T;
      const uint32_t s0 = V[s.x * T + t], s1 = V[s.y * T + t];
      const uint32_t s2 = V[s.z * T + t], s3 = V[s.w * T + t];
      // select on in0: r_j = s0 ? t[2j+1] : t[2j]
      const uint32_t r0 = mux(s0, mask(q0.y), mask(q0.x));
      const uint32_t r1 = mux(s0, mask(q0.w), mask(q0.z));
      const uint32_t r2 = mux(s0, mask(q1.y), mask(q1.x));
      const uint32_t r3 = mux(s0, mask(q1.w), mask(q1.z));
      const uint32_t r4 = mux(s0, mask(q2.y), mask(q2.x));
      const uint32_t r5 = mux(s0, mask(q2.w), mask(q2.z));
      const uint32_t r6 = mux(s0, mask(q3.y), mask(q3.x));
      const uint32_t r7 = mux(s0, mask(q3.w), mask(q3.z));
      // select on in1, in2, in3
      const uint32_t p0 = mux(s1, r1, r0), p1 = mux(s1, r3, r2);
      const uint32_t p2 = mux(s1, r5, r4), p3 = mux(s1, r7, r6);
      const uint32_t u0 = mux(s2, p1, p0), u1 = mux(s2, p3, p2);
      V[(size_t)(base + m) * T + t] = mux(s3, u1, u0);
    }
    __syncthreads();
  }

  // output gather, 2-of-3 vote, replica-vs-vote disagreement words
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int w = w0 + t;
    if (w >= W) continue;
    uint32_t d0 = 0u, d1 = 0u, d2 = 0u;
    for (int o = 0; o < O; ++o) {
      const uint32_t a = vals[(size_t)output_nets[(c * R) * O + o] * T + t];
      uint32_t v = a;
      if (R == 3) {
        const uint32_t b = vals[((size_t)n_nets +
                                 output_nets[(c * R + 1) * O + o]) * T + t];
        const uint32_t e = vals[((size_t)2 * n_nets +
                                 output_nets[(c * R + 2) * O + o]) * T + t];
        v = (a & b) | (a & e) | (b & e);
        d1 |= b ^ v;
        d2 |= e ^ v;
      }
      d0 |= a ^ v;
      voted[((size_t)c * W + w) * O + o] = v;
    }
    dis[((size_t)c * R + 0) * W + w] = d0;
    if (R == 3) {
      dis[((size_t)c * R + 1) * W + w] = d1;
      dis[((size_t)c * R + 2) * W + w] = d2;
    }
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes a block needs for `tile` words (the wrapper sizes
// the tile from this and the device limit).
long long eval_words_voted_smem_bytes(int R, int n_nets, int tile) {
  return (long long)R * n_nets * tile * 4;
}

// in_words (C, W, in_seg) i32; src (R*C, L, M, 4) i32; tables
// (R*C, L, M, 16) f32; output_nets (R*C, O) i32 -> voted (C, W, O) i32,
// dis (C, R, W) i32. R is 1 or 3. Launches on `stream`; returns
// cudaGetLastError (or the cudaFuncSetAttribute error).
int eval_words_voted_launch(const void* in_words, const void* src,
                            const void* tables, const void* output_nets,
                            void* voted, void* dis, int C, int R, int W,
                            int in_seg, int L, int M, int O, int tile,
                            void* stream) {
  if (C <= 0 || W <= 0) return 0;
  const long long smem =
      eval_words_voted_smem_bytes(R, in_seg + L * M, tile);
  cudaError_t err = cudaFuncSetAttribute(
      eval_words_voted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tile - 1) / tile, C);
  eval_words_voted_kernel<<<grid, kThreads, (size_t)smem,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)in_words, (const int4*)src, (const float4*)tables,
      (const int*)output_nets, (uint32_t*)voted, (uint32_t*)dis, R, W,
      in_seg, L, M, O, tile);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
