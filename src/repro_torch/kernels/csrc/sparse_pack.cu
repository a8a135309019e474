// Sparse trigger egress: the word-domain keep cut, the SEU counters and
// the popcount prefix-sum compaction of the kept events (kernel B6).
//
// Replaces: repro/kernels/lut_eval/ops.py decode_keep_words_device
// (bitsliced.py mask_words, sign_extended_planes, keep_words,
// lane_scores, disagree_counts_words) followed by
// repro/parallel/compression.py sparse_trigger_pack_words, which the JAX
// package fuses into one jit behind the fabric walk (ops.py
// _eval_stack_scored, frontend.py _score_frames_impl). Those are jnp, no
// Pallas; on the GPU the same ops would be some 200 launches (a 32-step
// word loop), and torch.nonzero, boolean indexing and masked_select all
// synchronise with the host and size their output by the data.
//
// Bound on the H100: device-memory bytes. The voted output words, the
// disagreement words and the valid mask are read once, the (idx, vals)
// pair is written once (n = C*W*32 slots, 8 bytes each, padding
// included), and the work per event is a few dozen integer operations.
// At the served shape (4 chips x 16 words) the call is launch-bound.
//
// Design, three passes on one stream, nothing allocated here and no host
// synchronisation (the count stays on the device):
//   1. decode: one warp per word, lane e = event w*32+e. The lane builds
//      its int32 score from the sign-extended planes (plane j reads
//      output word min(j, sign position), the first negative weight; a
//      row with none reads word 0 for every plane, as the reference's
//      argmax of an all-False row does). The cut is score <= threshold
//      on valid lanes, which is what the reference's biased bit-serial
//      compare decides; __ballot_sync gives the keep word. Per (chip,
//      replica) the disagreement words masked by the valid word are
//      popcounted, summed in shared memory and added with integer
//      atomics (order-free, so exact).
//   2. scan: one block runs an exclusive scan over the popcounts of all
//      C*W keep words in chip-major order (the flat index space is one
//      ascending order across chips) and writes the count.
//   3. scatter: a kept lane writes its flat index and score to
//      base[word] + popc(keep & lanes below it); every slot at or past the
//      count is written -1 / 0 by the lane of the same flat index, so no
//      two threads write one slot.
// The keep-words entry (voted == nullptr) starts at pass 2 from given
// keep words and per-lane scores: the event-domain pack of the matmul
// layout, and compression.sparse_trigger_pack_words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // words per block in passes 1 and 3
constexpr int kScanThreads = 1024;
constexpr int kMaxReplicas = 32;
constexpr unsigned kFull = 0xffffffffu;

// First o of the chip's weight row with a negative weight, else 0; the
// whole warp calls it and gets the same answer.
__device__ __forceinline__ int sign_position(const int* __restrict__ w_row,
                                             int O) {
  const int lane = threadIdx.x & 31;
  for (int o0 = 0; o0 < O; o0 += 32) {
    const int o = o0 + lane;
    const unsigned neg = __ballot_sync(kFull, o < O && w_row[o] < 0);
    if (neg) return o0 + __ffs(neg) - 1;
  }
  return 0;
}

// The lane's score: bit j is bit `lane` of output word min(j, sp). Lane o
// loads word o once; the planes come round by shuffles.
__device__ __forceinline__ int lane_score(const int* __restrict__ words,
                                          int O, int sp) {
  const int lane = threadIdx.x & 31;
  const int mine = (lane <= sp && lane < O) ? words[lane] : 0;
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const unsigned wj = (unsigned)__shfl_sync(kFull, mine, min(j, sp));
    s |= ((wj >> lane) & 1u) << j;
  }
  return (int)s;
}

__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const int* __restrict__ voted,      // (C, W, O)
              const int* __restrict__ dis_w,      // (C, R, W)
              const int* __restrict__ out_weight, // (C, O)
              const int* __restrict__ threshold,  // (C,)
              const uint8_t* __restrict__ valid,  // (C, B)
              int* __restrict__ keep,             // (C, W) out
              int* __restrict__ dis,              // (C, R) out, zeroed
              int W, int O, int R, int B) {
  __shared__ int sdis[kMaxReplicas];
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  for (int r = threadIdx.x; r < R; r += blockDim.x) sdis[r] = 0;
  __syncthreads();
  if (w < W) {                             // whole warps only
    const int e = w * 32 + lane;
    const bool v = e < B && valid[(long long)c * B + e] != 0;
    const unsigned vw = __ballot_sync(kFull, v);
    const int sp = sign_position(out_weight + (long long)c * O, O);
    const int s = lane_score(voted + ((long long)c * W + w) * O, O, sp);
    const unsigned kw = __ballot_sync(kFull, v && s <= threshold[c]);
    if (lane == 0) keep[(long long)c * W + w] = (int)kw;
    for (int r = lane; r < R; r += 32) {
      const unsigned d = (unsigned)dis_w[((long long)c * R + r) * W + w];
      const int n = __popc(d & vw);
      if (n) atomicAdd(&sdis[r], n);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    if (sdis[r]) atomicAdd(&dis[c * R + r], sdis[r]);
}

// Exclusive scan of the keep words' popcounts, 1,024 words a round with a
// running carry; writes each word's output base and the total count.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ keep, int* __restrict__ base,
            int* __restrict__ count, int n_words) {
  __shared__ int wsum[kScanThreads / 32];
  __shared__ int carry;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int r0 = 0; r0 < n_words; r0 += kScanThreads) {
    const int i = r0 + threadIdx.x;
    const int n = i < n_words ? __popc((unsigned)keep[i]) : 0;
    int x = n;                             // inclusive scan in the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {                       // scan of the 32 warp totals
      int t = wsum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, t, off);
        if (lane >= off) t += y;
      }
      wsum[lane] = t;
    }
    __syncthreads();
    if (i < n_words) base[i] = carry + (warp ? wsum[warp - 1] : 0) + x - n;
    __syncthreads();                       // every read of carry is done
    if (threadIdx.x == 0) carry += wsum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = carry;
}

__global__ void __launch_bounds__(kWarps * 32)
scatter_kernel(const int* __restrict__ keep,       // (C*W,)
               const int* __restrict__ base,       // (C*W,)
               const int* __restrict__ count,      // ()
               const int* __restrict__ voted,      // (C, W, O) or null
               const int* __restrict__ out_weight, // (C, O) or null
               const int* __restrict__ scores,     // (C*W*32,) or null
               int* __restrict__ idx, int* __restrict__ vals,
               int n_words, int W, int O) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gw >= n_words) return;               // whole warps only
  const long long i = gw * 32 + lane;      // the lane's flat index
  const unsigned kw = (unsigned)keep[gw];
  int s = 0;
  if (voted != nullptr) {                  // the warp decodes together
    const int c = (int)(gw / W);
    const int sp = sign_position(out_weight + (long long)c * O, O);
    s = lane_score(voted + gw * O, O, sp);
  } else if ((kw >> lane) & 1u) {
    s = scores[i];
  }
  if (i >= *count) {
    idx[i] = -1;
    vals[i] = 0;
  }
  if ((kw >> lane) & 1u) {
    const int pos = base[gw] + __popc(kw & ((1u << lane) - 1u));
    idx[pos] = (int)i;
    vals[pos] = s;
  }
}

}  // namespace

extern "C" {

// Decode entry (voted != null): voted (C, W, O), dis_w (C, R, W),
// out_weight (C, O), threshold (C,) int32 and valid (C, B) bool ->
// count (), idx (C*W*32,), vals (C*W*32,), dis (C, R) int32; scratch
// holds 2*C*W int32 (keep words, word bases). Keep-words entry (voted ==
// null): keep_in (C, W) and scores_in (C, W, 32) int32 -> count, idx,
// vals; scratch holds C*W int32; dis_w, out_weight, threshold, valid and
// dis are unused. W == ceil(B/32) and R <= 32. Launches on `stream`;
// returns the first CUDA error.
int sparse_pack_launch(const void* voted, const void* dis_w,
                       const void* out_weight, const void* threshold,
                       const void* valid, const void* keep_in,
                       const void* scores_in, void* scratch, void* count,
                       void* idx, void* vals, void* dis, int C, int W, int O,
                       int R, int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_words = C * W;
  if (n_words <= 0) return (int)cudaMemsetAsync(count, 0, sizeof(int), s);
  if (R > kMaxReplicas) return (int)cudaErrorInvalidValue;
  const int* keep = (const int*)keep_in;
  int* base = (int*)scratch;
  if (voted != nullptr) {
    int* kw = (int*)scratch;
    base = kw + n_words;
    keep = kw;
    cudaError_t err = cudaMemsetAsync(dis, 0, sizeof(int) * C * R, s);
    if (err != cudaSuccess) return (int)err;
    decode_kernel<<<dim3((W + kWarps - 1) / kWarps, C), kWarps * 32, 0, s>>>(
        (const int*)voted, (const int*)dis_w, (const int*)out_weight,
        (const int*)threshold, (const uint8_t*)valid, kw, (int*)dis, W, O,
        R, B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  scan_kernel<<<1, kScanThreads, 0, s>>>(keep, base, (int*)count, n_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<(n_words + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      keep, base, (const int*)count, (const int*)voted,
      (const int*)out_weight, (const int*)scores_in, (int*)idx, (int*)vals,
      n_words, W, O);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
