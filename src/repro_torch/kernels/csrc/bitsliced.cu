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
// either bound is under a microsecond. What limits the kernel is the
// latency of its 13 dependent levels.
//
// Design. A level computes in a few hundred cycles, less than one read
// of device memory (L2 included) takes, so no level may wait on one: a
// copy issued one level ahead still stalls every level (measured: a
// first form of this design, which staged each level's descriptors a
// level ahead, ran no faster than the per-item loads it replaced). So
// the walk reads device memory once, before its first level. Two passes
// on one stream:
//  1. desc_kernel, a thread per (replica row, level, LUT) of the stack:
//     the LUT's descriptor, its four source nets as 16-bit indices into
//     the block's net buffer (two per 32-bit word) and its truth table
//     as a 16-bit mask (entry k set iff table[k] > 0.5), into a scratch
//     buffer the wrapper passes, each chip's descriptors contiguous.
//     Every launch converts every LUT once: the tables change in place
//     (hot swap, scrubbing, upsets).
//  2. eval_words_voted_kernel, launched as a programmatic dependent of
//     pass 1: a block owns one logical chip and a tile of `tile` words.
//     It copies its input words into shared memory while pass 1 runs,
//     waits for it (griddepcontrol.wait), then copies its chip's
//     descriptors for every level and replica (10 bytes a LUT, 50 KB on
//     the TMR envelope) into shared memory with cp.async. The net buffer
//     of the tile is there too: [tile][in_seg + R*L*M] words, the input
//     segment once (the replicas share it), then each replica's level
//     slots; the descriptors' indices already point into that layout.
//     The levels then run from shared memory alone, one barrier each. A
//     thread owns one (replica, LUT) slot and a group of the tile's
//     words: the block has R*M*groups threads (at most 1,024), groups =
//     min(tile, 1024 / (R*M)), and each thread runs the mux tree for its
//     ceil(tile / groups) words from one descriptor read. Its slot is the
//     same at every level, so its indices are worked out once and the
//     next level's descriptor is read while this one computes. Adjacent
//     threads take adjacent LUTs, so a level's writes fall in distinct
//     banks. The mux tree is the one of bitsliced.py:141-143 on unsigned
//     words (the torch side carries them as int32 bit patterns). The
//     output phase takes (word, output) items, output fastest, so the
//     voted words go out coalesced; the disagreement words gather by
//     shared-memory atomicOr.
//
// Envelopes too deep for one block (fault C.3 of the fleet: 32 levels x
// 256 LUTs under TMR needs 344,588 B for one word) take the split path,
// which the wrapper picks from the sizes: a block per (chip, replica,
// tile) runs the same walk with one replica (the descriptor pass sees the
// R*C replica rows as chips of one replica each, and a block reads its
// logical chip's input words, `split` rows sharing them), writing each
// replica's output words to a scratch; a third pass, vote_kernel, takes
// the 2-of-3 vote and the disagreement words from them. The block then
// holds one replica's levels (115,204 B for that envelope's word). A
// window of levels (the net buffer as a ring of fanin-reach slots) would
// keep R replicas in one block, but the output nets may read any level,
// and the descriptors would stream a level ahead, which stalled every
// level in the staged design's first form (above).
//
// Envelopes whose descriptors do not fit beside one word's net buffer
// take the streamed path (a boosted ensemble on efpga_28nm_xl: 33 levels
// x 640 LUTs with a 384-word input segment needs 297,220 B for one
// replica's word on the split path, 211,200 B of it descriptors; the
// adders read tree outputs from the first levels, so a ring of recent
// levels cannot bound the net buffer). eval_words_streamed_kernel, a
// block per (replica row, tile), holds only the net buffer of its tile's
// words in shared memory and streams the descriptors from the scratch
// through a ring of kRing levels with cp.async, kRing - 1 levels ahead of
// the level it computes (one level ahead stalled every level in the
// staged design's first form, above). The descriptor pass lays each
// level out at a stride of M rounded up to 8 LUTs, so a level's copy is
// whole 16-byte pieces. Under TMR its replica rows' output words go to
// the split path's scratch and vote_kernel votes them, as on the split
// path. The wrapper takes the staged path where it fits, else the split
// path, else this one.
//
// Padded LUT slots read net 0 (const0) with an all-zero table, so they
// write 0. Const1 is all ones in every lane, tail lanes included; the
// caller's valid mask drops those lanes later, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kDescThreads = 256;
// levels of descriptors a streamed walk block holds (bitsliced.py RING)
constexpr int kRing = 4;

__device__ __forceinline__ uint32_t mux(uint32_t s, uint32_t hi,
                                        uint32_t lo) {
  return (s & hi) | (~s & lo);
}

// all ones where truth-table entry k is set
__device__ __forceinline__ uint32_t entry(uint32_t mk, int k) {
  return 0u - ((mk >> k) & 1u);
}

__device__ __forceinline__ uint32_t bit(float t, int k) {
  return t > 0.5f ? 1u << k : 0u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// LUT slots a level takes in the streamed walk's descriptor layout: M
// rounded up to whole 16-byte pieces of masks
__host__ __device__ __forceinline__ int level_stride(int M) {
  return (M + 7) / 8 * 8;
}

// descriptors (uint2) and masks (uint16) of one chip, padded to 16 bytes
__host__ __device__ __forceinline__ long long desc_stride(int R, int L,
                                                          int M) {
  return ((long long)R * L * M + 1) / 2 * 2;
}
__host__ __device__ __forceinline__ long long mask_stride(int R, int L,
                                                          int M) {
  return ((long long)R * L * M + 7) / 8 * 8;
}

// Pass 1: one descriptor per (row, level, LUT) of the stack. A level
// takes `ls` LUT slots of the layout: M, or with kLevelStride the
// streamed walk's level_stride(M), the slots past M left unwritten (only
// that layout pays for the level's division).
template <bool kLevelStride>
__global__ void __launch_bounds__(kDescThreads)
desc_kernel(const int4* __restrict__ src,       // (R*C, L, M)
            const float4* __restrict__ tables,  // (R*C, L, M, 4)
            uint2* __restrict__ desc,           // (C, desc_stride)
            uint16_t* __restrict__ masks,       // (C, mask_stride)
            int C, int R, int in_seg, int L, int M, int ls) {
  // the walk may launch now: it waits for this grid before it reads
  // the descriptors
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long long n = (long long)C * R * L * M;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const long long LM = (long long)L * M;
  const int row = (int)(k / LM);
  const int c = row / R, r = row - c * R;
  const int lm = (int)(k - (long long)row * LM);
  long long within = (long long)r * LM + lm;
  if (kLevelStride) {
    const int l = lm / M;
    within = ((long long)r * L + l) * ls + (lm - l * M);
  }
  // a level net of replica r lies after the shared input segment and the
  // level slots of replicas 0..r-1
  const int shift = r * L * M;
  const int4 s = src[k];
  const uint32_t s0 = s.x < in_seg ? s.x : s.x + shift;
  const uint32_t s1 = s.y < in_seg ? s.y : s.y + shift;
  const uint32_t s2 = s.z < in_seg ? s.z : s.z + shift;
  const uint32_t s3 = s.w < in_seg ? s.w : s.w + shift;
  desc[c * desc_stride(R, L, ls) + within] =
      make_uint2(s0 | (s1 << 16), s2 | (s3 << 16));
  uint32_t mk = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 q = tables[k * 4 + j];
    mk |= bit(q.x, 4 * j) | bit(q.y, 4 * j + 1) | bit(q.z, 4 * j + 2) |
          bit(q.w, 4 * j + 3);
  }
  masks[c * mask_stride(R, L, ls) + within] = (uint16_t)mk;
}

// One LUT over words [t0, t1) of the tile: its four source words, the mux
// tree of bitsliced.py:141-143, the result into slot `out_net`.
__device__ __forceinline__ void walk_words(uint32_t* vals, int n_tot, uint2 d,
                                           uint32_t mk, int out_net, int t0,
                                           int t1) {
  const int a0 = d.x & 0xFFFF, a1 = d.x >> 16;
  const int a2 = d.y & 0xFFFF, a3 = d.y >> 16;
  uint32_t e[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) e[k] = entry(mk, k);
  for (int t = t0; t < t1; ++t) {
    uint32_t* Vt = vals + (size_t)t * n_tot;
    const uint32_t s0 = Vt[a0], s1 = Vt[a1], s2 = Vt[a2], s3 = Vt[a3];
    // select on in0: r_j = s0 ? t[2j+1] : t[2j]
    const uint32_t r0 = mux(s0, e[1], e[0]), r1 = mux(s0, e[3], e[2]);
    const uint32_t r2 = mux(s0, e[5], e[4]), r3 = mux(s0, e[7], e[6]);
    const uint32_t r4 = mux(s0, e[9], e[8]), r5 = mux(s0, e[11], e[10]);
    const uint32_t r6 = mux(s0, e[13], e[12]), r7 = mux(s0, e[15], e[14]);
    // select on in1, in2, in3
    const uint32_t p0 = mux(s1, r1, r0), p1 = mux(s1, r3, r2);
    const uint32_t p2 = mux(s1, r5, r4), p3 = mux(s1, r7, r6);
    const uint32_t u0 = mux(s2, p1, p0), u1 = mux(s2, p3, p2);
    Vt[out_net] = mux(s3, u1, u0);
  }
}

// Pass 2: the level walk of one chip and one tile of words. Block row c
// reads the input words of chip c / split (split > 1: the rows are one
// logical chip's replicas, each walked alone).
__global__ void __launch_bounds__(kThreads)
eval_words_voted_kernel(const uint32_t* __restrict__ in_words,  // (C/split, W, in_seg)
                        const uint2* __restrict__ desc,         // (C, desc_stride)
                        const uint16_t* __restrict__ masks,     // (C, mask_stride)
                        const int* __restrict__ output_nets,    // (R*C, O)
                        uint32_t* __restrict__ voted,           // (C, W, O)
                        uint32_t* __restrict__ dis,             // (C, R, W)
                        int R, int W, int in_seg, int L, int M, int O,
                        int tile, int split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.y;
  const int c_in = c / split;
  const int T = tile;
  const int w0 = blockIdx.x * T;
  const int nT = min(T, W - w0);
  const int RM = R * M, LM = L * M;
  const int n_tot = in_seg + R * LM;
  const long long dst = desc_stride(R, L, M), mst = mask_stride(R, L, M);
  uint2* desc_s = reinterpret_cast<uint2*>(smem);                  // [R][L][M]
  uint16_t* msk_s = reinterpret_cast<uint16_t*>(desc_s + dst);      // [R][L][M]
  uint32_t* vals = reinterpret_cast<uint32_t*>(msk_s + mst);        // [T][n_tot]
  uint32_t* dis_s = vals + (size_t)T * n_tot;                       // [R][T]
  const int tid = threadIdx.x, bd = blockDim.x;

  // the input segment and the zeroed dis words while the descriptor
  // pass may still run; then this chip's descriptors and masks for every
  // level
  for (int idx = tid; idx < nT * in_seg; idx += bd) {
    const int t = idx / in_seg, net = idx - t * in_seg;
    vals[(size_t)t * n_tot + net] =
        in_words[((size_t)c_in * W + w0 + t) * in_seg + net];
  }
  for (int i = tid; i < R * T; i += bd) dis_s[i] = 0u;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  {
    const char* dg = reinterpret_cast<const char*>(desc + c * dst);
    char* ds = reinterpret_cast<char*>(desc_s);
    for (long long u = tid; u < dst / 2; u += bd)
      cp_async16(ds + 16 * u, dg + 16 * u);
    const char* mg = reinterpret_cast<const char*>(masks + c * mst);
    char* ms = reinterpret_cast<char*>(msk_s);
    for (long long u = tid; u < mst / 8; u += bd)
      cp_async16(ms + 16 * u, mg + 16 * u);
  }
  cp_async_wait_all();
  __syncthreads();

  const int groups = min(T, max(1, bd / RM));
  const int G = (T + groups - 1) / groups;
  const int n_slots = RM * groups;
  if (n_slots > bd) {
    // more (replica, LUT) slots than threads (R*M > 1024)
    for (int l = 0; l < L; ++l) {
      for (int sl = tid; sl < n_slots; sl += bd) {
        const int g = sl / RM, i = sl - g * RM;
        const int r = i / M, m = i - r * M;
        const size_t at = (size_t)r * LM + (size_t)l * M + m;
        walk_words(vals, n_tot, desc_s[at], msk_s[at],
                   in_seg + r * LM + l * M + m, g * G, min(g * G + G, nT));
      }
      __syncthreads();
    }
  } else {
    // one slot a thread, the same at every level: its indices worked out
    // once, the next level's descriptor read while this one computes
    const bool has = tid < n_slots;
    const int g = tid / RM, i = tid - g * RM;
    const int r = i / M, m = i - r * M;
    const int t0 = g * G, t1 = min(t0 + G, nT);
    const size_t at0 = (size_t)r * LM + m;
    const int out0 = in_seg + r * LM + m;
    uint2 d = has ? desc_s[at0] : make_uint2(0u, 0u);
    uint32_t mk = has ? msk_s[at0] : 0u;
    for (int l = 0; l < L; ++l) {
      const size_t nx = at0 + (size_t)(l + 1 < L ? l + 1 : l) * M;
      const uint2 dn = has ? desc_s[nx] : d;
      const uint32_t mn = has ? msk_s[nx] : mk;
      if (has) walk_words(vals, n_tot, d, mk, out0 + l * M, t0, t1);
      __syncthreads();
      d = dn;
      mk = mn;
    }
  }

  // output gather, 2-of-3 vote, replica-vs-vote disagreement words
  for (int idx = tid; idx < nT * O; idx += bd) {
    const int t = idx / O, o = idx - t * O;
    const uint32_t* Vt = vals + (size_t)t * n_tot;
    uint32_t got[3];
    for (int r = 0; r < R; ++r) {
      const int n = output_nets[(size_t)(c * R + r) * O + o];
      got[r] = Vt[n < in_seg ? n : n + r * LM];
    }
    uint32_t v = got[0];
    if (R == 3) {
      v = (got[0] & got[1]) | (got[0] & got[2]) | (got[1] & got[2]);
      if (got[1] ^ v) atomicOr(dis_s + T + t, got[1] ^ v);
      if (got[2] ^ v) atomicOr(dis_s + 2 * T + t, got[2] ^ v);
    }
    if (got[0] ^ v) atomicOr(dis_s + t, got[0] ^ v);
    voted[((size_t)c * W + w0 + t) * O + o] = v;
  }
  __syncthreads();
  for (int idx = tid; idx < R * nT; idx += bd) {
    const int r = idx / nT, t = idx - r * nT;
    dis[((size_t)c * R + r) * W + w0 + t] = dis_s[r * T + t];
  }
}

// Pass 3 of the split path: a thread per (chip, word) votes its outputs
// over the three replicas' words and ORs each replica's differences into
// its disagreement word.
__global__ void __launch_bounds__(kDescThreads)
vote_kernel(const uint32_t* __restrict__ rep,  // (C*3, W, O)
            uint32_t* __restrict__ voted,      // (C, W, O)
            uint32_t* __restrict__ dis,        // (C, 3, W)
            int C, int W, int O) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)C * W) return;
  const int c = (int)(k / W), t = (int)(k - (long long)c * W);
  const size_t plane = (size_t)W * O;
  const uint32_t* g0 = rep + (size_t)3 * c * plane + (size_t)t * O;
  const uint32_t* g1 = g0 + plane;
  const uint32_t* g2 = g1 + plane;
  uint32_t* v_out = voted + ((size_t)c * W + t) * O;
  uint32_t d0 = 0u, d1 = 0u, d2 = 0u;
  for (int o = 0; o < O; ++o) {
    const uint32_t a = g0[o], b = g1[o], e = g2[o];
    const uint32_t v = (a & b) | (a & e) | (b & e);
    v_out[o] = v;
    d0 |= a ^ v;
    d1 |= b ^ v;
    d2 |= e ^ v;
  }
  dis[((size_t)c * 3 + 0) * W + t] = d0;
  dis[((size_t)c * 3 + 1) * W + t] = d1;
  dis[((size_t)c * 3 + 2) * W + t] = d2;
}

// Copies of one level's descriptors and masks of a row (`dg`, `mg`: the
// row's, in the level_stride layout) into ring slot `slot`, 16 bytes a
// thread at a time.
__device__ __forceinline__ void stream_level(uint2* ring_d, uint16_t* ring_m,
                                             const uint2* dg,
                                             const uint16_t* mg, int ls,
                                             int slot, int l, int tid,
                                             int bd) {
  const char* ds = reinterpret_cast<const char*>(dg + (size_t)l * ls);
  char* dd = reinterpret_cast<char*>(ring_d + (size_t)slot * ls);
  for (int u = tid; u < ls / 2; u += bd) cp_async16(dd + 16 * u, ds + 16 * u);
  const char* ms = reinterpret_cast<const char*>(mg + (size_t)l * ls);
  char* md = reinterpret_cast<char*>(ring_m + (size_t)slot * ls);
  for (int u = tid; u < ls / 8; u += bd) cp_async16(md + 16 * u, ms + 16 * u);
}

// The streamed walk: one replica row and one tile of words a block, the
// net buffer [tile][in_seg + L*M] in shared memory, each level's
// descriptors streamed through a ring of kRing levels. Block row c reads
// the input words of chip c / split; its output words go to out
// (rows, W, O), and where dis is given its (zero) disagreement words to
// dis (rows, 1, W).
__global__ void __launch_bounds__(kThreads)
eval_words_streamed_kernel(const uint32_t* __restrict__ in_words,  // (rows/split, W, in_seg)
                           const uint2* __restrict__ desc,         // (rows, L, ls)
                           const uint16_t* __restrict__ masks,     // (rows, L, ls)
                           const int* __restrict__ output_nets,    // (rows, O)
                           uint32_t* __restrict__ out,             // (rows, W, O)
                           uint32_t* __restrict__ dis,             // (rows, 1, W) or null
                           int W, int in_seg, int L, int M, int O,
                           int tile, int split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.y;
  const int c_in = c / split;
  const int T = tile;
  const int w0 = blockIdx.x * T;
  const int nT = min(T, W - w0);
  const int ls = level_stride(M);
  const int n_tot = in_seg + L * M;
  uint2* ring_d = reinterpret_cast<uint2*>(smem);                   // [kRing][ls]
  uint16_t* ring_m = reinterpret_cast<uint16_t*>(ring_d + kRing * ls);  // [kRing][ls]
  uint32_t* vals = reinterpret_cast<uint32_t*>(ring_m + kRing * ls);    // [T][n_tot]
  const uint2* dg = desc + (size_t)c * L * ls;
  const uint16_t* mg = masks + (size_t)c * L * ls;
  const int tid = threadIdx.x, bd = blockDim.x;

  // the input segment while the descriptor pass may still run
  for (int idx = tid; idx < nT * in_seg; idx += bd) {
    const int t = idx / in_seg, net = idx - t * in_seg;
    vals[(size_t)t * n_tot + net] =
        in_words[((size_t)c_in * W + w0 + t) * in_seg + net];
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // levels 0 .. kRing-2 in flight, a group each (empty past L)
#pragma unroll
  for (int j = 0; j < kRing - 1; ++j) {
    if (j < L) stream_level(ring_d, ring_m, dg, mg, ls, j, j, tid, bd);
    cp_async_commit();
  }

  const int groups = min(T, max(1, bd / M));
  const int G = (T + groups - 1) / groups;
  const int n_slots = M * groups;
  for (int l = 0; l < L; ++l) {
    // level l has landed (its group and those before it), every thread's
    // copies are visible, and level l-1's slots are written and its ring
    // slot read
    cp_async_wait<kRing - 2>();
    __syncthreads();
    const int nl = l + kRing - 1;
    if (nl < L)
      stream_level(ring_d, ring_m, dg, mg, ls, nl % kRing, nl, tid, bd);
    cp_async_commit();
    const uint2* dl = ring_d + (size_t)(l % kRing) * ls;
    const uint16_t* ml = ring_m + (size_t)(l % kRing) * ls;
    for (int sl = tid; sl < n_slots; sl += bd) {
      const int g = sl / M, m = sl - g * M;
      walk_words(vals, n_tot, dl[m], ml[m], in_seg + l * M + m, g * G,
                 min(g * G + G, nT));
    }
  }
  __syncthreads();

  for (int idx = tid; idx < nT * O; idx += bd) {
    const int t = idx / O, o = idx - t * O;
    out[((size_t)c * W + w0 + t) * O + o] =
        vals[(size_t)t * n_tot + output_nets[(size_t)c * O + o]];
  }
  if (dis != nullptr)
    for (int t = tid; t < nT; t += bd) dis[(size_t)c * W + w0 + t] = 0u;
}

// Shared-memory bytes of a walk block for `tile` words: the row's
// descriptors and masks, the net buffer [tile][in_seg + R*L*M] and the
// dis words.
long long block_smem(int R, int in_seg, int L, int M, int tile) {
  return desc_stride(R, L, M) * 8 + mask_stride(R, L, M) * 2 +
         (long long)tile * (in_seg + (long long)R * L * M) * 4 +
         (long long)R * tile * 4;
}

// The descriptor pass over `rows` rows of R replicas each, then the walk
// as its programmatic dependent, `split` block rows to an input chip.
cudaError_t launch_walk(const void* in_words, const void* src,
                        const void* tables, const void* output_nets,
                        void* scratch, void* voted, void* dis, int rows,
                        int R, int W, int in_seg, int L, int M, int O,
                        int tile, int split, cudaStream_t s) {
  uint2* desc = (uint2*)scratch;
  uint16_t* masks =
      (uint16_t*)(desc + (long long)rows * desc_stride(R, L, M));
  const long long n = (long long)rows * R * L * M;
  desc_kernel<false><<<(unsigned)((n + kDescThreads - 1) / kDescThreads),
                       kDescThreads, 0, s>>>((const int4*)src,
                                             (const float4*)tables, desc,
                                             masks, rows, R, in_seg, L, M,
                                             M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long smem = block_smem(R, in_seg, L, M, tile);
  err = cudaFuncSetAttribute(eval_words_voted_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int RM = R * M;
  int groups = kThreads / RM;
  groups = groups < 1 ? 1 : (groups > tile ? tile : groups);
  long long threads = (long long)RM * groups;
  threads = (threads + 31) / 32 * 32;
  if (threads > kThreads) threads = kThreads;
  // programmatic dependent launch: the walk's blocks start (and copy
  // their input words) while the descriptor pass runs
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + tile - 1) / tile, rows);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, eval_words_voted_kernel,
                           (const uint32_t*)in_words, (const uint2*)desc,
                           (const uint16_t*)masks, (const int*)output_nets,
                           (uint32_t*)voted, (uint32_t*)dis, R, W, in_seg, L,
                           M, O, tile, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Shared-memory bytes of a streamed walk block for `tile` words: the
// ring of kRing levels' descriptors and masks and the net buffer
// [tile][in_seg + L*M].
long long streamed_smem(int in_seg, int L, int M, int tile) {
  return (long long)kRing * level_stride(M) * (8 + 2) +
         (long long)tile * (in_seg + (long long)L * M) * 4;
}

// The descriptor pass over `rows` rows of one replica each, in the
// level_stride layout, then the streamed walk as its programmatic
// dependent, `split` block rows to an input chip.
cudaError_t launch_streamed(const void* in_words, const void* src,
                            const void* tables, const void* output_nets,
                            void* scratch, void* out, void* dis, int rows,
                            int W, int in_seg, int L, int M, int O, int tile,
                            int split, cudaStream_t s) {
  const int ls = level_stride(M);
  uint2* desc = (uint2*)scratch;
  uint16_t* masks = (uint16_t*)(desc + (long long)rows * L * ls);
  const long long n = (long long)rows * L * M;
  desc_kernel<true><<<(unsigned)((n + kDescThreads - 1) / kDescThreads),
                      kDescThreads, 0, s>>>((const int4*)src,
                                            (const float4*)tables, desc,
                                            masks, rows, 1, in_seg, L, M,
                                            ls);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long smem = streamed_smem(in_seg, L, M, tile);
  err = cudaFuncSetAttribute(eval_words_streamed_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int groups = kThreads / M;
  groups = groups < 1 ? 1 : (groups > tile ? tile : groups);
  long long threads = (long long)M * groups;
  threads = (threads + 31) / 32 * 32;
  if (threads > kThreads) threads = kThreads;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + tile - 1) / tile, rows);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, eval_words_streamed_kernel,
                           (const uint32_t*)in_words, (const uint2*)desc,
                           (const uint16_t*)masks, (const int*)output_nets,
                           (uint32_t*)out, (uint32_t*)dis, W, in_seg, L, M,
                           O, tile, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// vote_kernel over C chips' three replica rows of output words, as the
// programmatic dependent of the walk before it.
cudaError_t launch_vote(const void* rep, void* voted, void* dis, int C,
                        int W, int O, cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  const long long n = (long long)C * W;
  cfg.gridDim = dim3((unsigned)((n + kDescThreads - 1) / kDescThreads));
  cfg.blockDim = dim3(kDescThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, vote_kernel, (const uint32_t*)rep,
                                       (uint32_t*)voted, (uint32_t*)dis, C,
                                       W, O);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch bytes for the descriptors of C chips (the wrapper allocates
// them): 8 bytes of source nets and 2 of mask a LUT, each chip padded.
long long eval_words_voted_scratch_bytes(int C, int R, int L, int M) {
  return (long long)C * (desc_stride(R, L, M) * 8 + mask_stride(R, L, M) * 2);
}

// Shared-memory bytes a block needs for `tile` words (the wrapper sizes
// the tile from this and the device limit): the chip's descriptors and
// masks, the net buffer [tile][in_seg + R*L*M] and the dis words.
long long eval_words_voted_smem_bytes(int R, int in_seg, int L, int M,
                                      int tile) {
  return block_smem(R, in_seg, L, M, tile);
}

// in_words (C, W, in_seg) i32; src (R*C, L, M, 4) i32; tables
// (R*C, L, M, 16) f32; output_nets (R*C, O) i32; scratch of
// eval_words_voted_scratch_bytes, 16-byte aligned -> voted (C, W, O) i32,
// dis (C, R, W) i32. R is 1 or 3; in_seg + R*L*M < 65536 (one word's
// buffer in shared memory already bounds it to about 58,000); src and
// tables 16-byte aligned. Launches both passes on `stream`; returns
// cudaGetLastError (or the cudaFuncSetAttribute error).
int eval_words_voted_launch(const void* in_words, const void* src,
                            const void* tables, const void* output_nets,
                            void* scratch, void* voted, void* dis, int C,
                            int R, int W, int in_seg, int L, int M, int O,
                            int tile, void* stream) {
  if (C <= 0 || W <= 0) return 0;
  if (tile <= 0 || L <= 0 || M <= 0 ||
      in_seg + (long long)R * L * M >= 65536)
    return (int)cudaErrorInvalidValue;
  return (int)launch_walk(in_words, src, tables, output_nets, scratch, voted,
                          dis, C, R, W, in_seg, L, M, O, tile, 1,
                          (cudaStream_t)stream);
}

// The split path for R = 3: the walk over the 3*C replica rows, one
// replica a block (shared memory of eval_words_voted_smem_bytes with
// R = 1), each row's output words into rep (3*C, W, O) and zero words
// into rep_dis (3*C, 1, W); then vote_kernel into voted (C, W, O) and
// dis (C, 3, W). scratch holds eval_words_voted_scratch_bytes(3*C, 1, L,
// M). Same contract otherwise as eval_words_voted_launch.
int eval_words_split_launch(const void* in_words, const void* src,
                            const void* tables, const void* output_nets,
                            void* scratch, void* rep, void* rep_dis,
                            void* voted, void* dis, int C, int R, int W,
                            int in_seg, int L, int M, int O, int tile,
                            void* stream) {
  if (C <= 0 || W <= 0) return 0;
  if (R != 3 || tile <= 0 || L <= 0 || M <= 0 ||
      in_seg + (long long)L * M >= 65536)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      launch_walk(in_words, src, tables, output_nets, scratch, rep, rep_dis,
                  C * R, 1, W, in_seg, L, M, O, tile, R, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_vote(rep, voted, dis, C, W, O, s);
}

// Shared-memory bytes a streamed walk block needs for `tile` words: the
// ring of descriptors and masks and the net buffer [tile][in_seg + L*M].
long long eval_words_streamed_smem_bytes(int in_seg, int L, int M,
                                         int tile) {
  return streamed_smem(in_seg, L, M, tile);
}

// Scratch bytes of the streamed path's descriptors: C*R rows of one
// replica, each level at level_stride(M) LUTs.
long long eval_words_streamed_scratch_bytes(int C, int R, int L, int M) {
  return (long long)C * R * L * level_stride(M) * (8 + 2);
}

// The streamed path: the descriptor pass over the R*C replica rows, then
// eval_words_streamed_kernel, a block per (row, tile). R = 1: its output
// words into voted (C, W, O) and zero words into dis (C, 1, W). R = 3:
// each row's output words into rep (3*C, W, O), then vote_kernel into
// voted (C, W, O) and dis (C, 3, W). scratch holds
// eval_words_streamed_scratch_bytes(C, R, L, M). Same contract otherwise
// as eval_words_voted_launch, with in_seg + L*M < 65536.
int eval_words_streamed_launch(const void* in_words, const void* src,
                               const void* tables, const void* output_nets,
                               void* scratch, void* rep, void* voted,
                               void* dis, int C, int R, int W, int in_seg,
                               int L, int M, int O, int tile, void* stream) {
  if (C <= 0 || W <= 0) return 0;
  if ((R != 1 && R != 3) || tile <= 0 || L <= 0 || M <= 0 ||
      in_seg + (long long)L * M >= 65536)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (R == 1)
    return (int)launch_streamed(in_words, src, tables, output_nets, scratch,
                                voted, dis, C, W, in_seg, L, M, O, tile, 1,
                                s);
  cudaError_t err =
      launch_streamed(in_words, src, tables, output_nets, scratch, rep,
                      nullptr, C * R, W, in_seg, L, M, O, tile, R, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_vote(rep, voted, dis, C, W, O, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
