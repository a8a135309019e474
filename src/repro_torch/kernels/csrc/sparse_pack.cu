// Sparse trigger egress and its dense twin (kernel B6): the word-domain
// keep cut, the SEU counters, and then either the popcount prefix-sum
// compaction of the kept events (sparse) or every event's score and keep
// flag written back in event order (dense).
//
// Replaces: repro/kernels/lut_eval/ops.py decode_keep_words_device
// (bitsliced.py mask_words, sign_extended_planes, keep_words,
// lane_scores, disagree_counts_words) followed by
// repro/parallel/compression.py sparse_trigger_pack_words (sparse), and
// repro/kernels/lut_eval/bitsliced.py unpack_words followed by ops.py
// decode_scores_device (dense), which the JAX package runs in one jit
// behind the fabric walk (ops.py _eval_stack_scored, frontend.py
// _score_frames_impl). Those are jnp, no Pallas; in torch ops they are
// some 200 launches (sparse: a 32-step word loop) or about 18 (dense),
// and torch.nonzero, boolean indexing and masked_select synchronise with
// the host and size their output by the data.
//
// Bound on the H100: device-memory bytes or integer operations at large
// shapes (every input word read once, every output slot written once; a
// few dozen operations an event). At the served shape (4 chips x 16
// words) the latency of one launch and of the dependent memory round
// trips inside it: so every entry is ONE launch, with no memset, nothing
// allocated here and no host synchronisation (the count stays on the
// device), and a call of at most kTileWords words is one block that
// touches no state shared between blocks.
//
// Design. A block of kWarps warps owns a tile of kTileWords words in
// chip-major flat order; word i of the tile goes to warp i % kWarps, and
// lane e of a word is event w*32+e. A warp's words are loaded together,
// so a block pays each dependent memory round trip once.
//   * decode: the sparse entries build the lane's score from the
//     sign-extended planes (plane j is output word min(j, sign
//     position), the first negative weight; a row with none reads word 0
//     for every plane, as the reference's argmax of an all-False row
//     does), the reference's word-domain decode: lane j loads plane j and
//     a 32x32 butterfly bit transpose (five shuffles) hands lane e its
//     score. The dense entry transposes the output words the same way
//     (lane e gets its output bits) and takes the general weighted sum
//     with int32 wrap (any int32 weights, as decode_scores_device) as a
//     sum over nibbles of per-chip tables of the nibble's weight sums,
//     built in the prologue. The cut is score <= threshold on valid
//     lanes; __ballot_sync gives the keep word.
//   * sparse compaction: word bases from a block scan of the keep words'
//     popcounts; across blocks a single-pass decoupled look-back scan (a
//     status word a tile). A kept lane writes its flat index and score
//     to prefix + word base + its rank.
//   * SEU counters: per (chip, replica) popcounts of the disagreement
//     words masked by the valid word, summed in shared memory; one block
//     writes them, more add them with integer atomics to accumulators in
//     the persistent state, which one block then reads out (order-free,
//     so exact).
//
// The persistent state (uint32, owned by the wrapper, one for each device
// and stream, zeroed once when it is allocated:
// kernels/sparse_pack/sparse_pack.py) is
//   [0]                       done: blocks finished (dense, >1 block)
//   [1, 1 + C*R)              dis accumulators (>1 block)
//   [1 + C*R, ... + n_tiles)  tile statuses (sparse, >1 block)
// and is all zero between launches: the one block that reads the
// accumulators out zeroes them, and the block that zeroes done or the
// statuses does so only when no other block will touch them again (it
// counted every other block done, or saw every other tile's inclusive
// prefix, which a tile publishes after its last status read). A block
// orders its writes before a status or a done count by __syncthreads and
// then one thread's release (st.release, atom.acq_rel), which is
// cumulative over the block's writes, as cooperative groups' grid sync
// relies on; a reader acquires, then __syncthreads. A later launch on the
// stream touches the state only after griddepcontrol.wait, which returns
// once every earlier grid on the stream has completed and its writes are
// visible. So back-to-back or overlapping (programmatic) launches and the
// replays of a captured graph all start from the zeroed state and never
// read a stale status. Launches that could run at once never share a
// state: the wrapper keeps one for each stream (a captured graph keeps
// its capture stream's).
//
// Hazards of the look-back without a memset, and how each is solved:
//   * status words: (flag << 30) | value, flag 0 = not yet published (the
//     reset value), 1 = the tile's aggregate, 2 = its inclusive prefix;
//     values stay below C*W*32 < 2**30 (checked here). Published with
//     st.release.gpu, polled with ld.acquire.gpu (one a lane: several
//     acquires in a row, or relaxed polls and a fence after them, measured
//     slower). Tile 0 publishes its
//     inclusive prefix at once; a look-back counts the tiles below 0 as
//     an inclusive prefix of 0. The last tile publishes nothing: no tile
//     reads its status.
//   * the -1 / 0 padding past `count`, which no block of several knows up
//     front: a kept lane's slot (its rank) is never past its own flat
//     index, so only this tile and later tiles write kept lanes into this
//     tile's slot range [t*kTileSlots, (t+1)*kTileSlots). A block pads
//     its whole range first and publishes its first status only after
//     that (see above). A later tile writes kept lanes only after its
//     look-back acquired this tile's status or, past it, an inclusive
//     prefix whose publisher had acquired it in turn (release and acquire
//     are cumulative; the look-back's lanes each acquire a status, and a
//     __syncwarp orders their acquires before lane 0's release of the
//     inclusive prefix): every padding write is ordered before every kept
//     write to the same slot. The tile's own kept lanes follow its
//     padding across __syncthreads. A single block knows `count` after
//     its scan and pads [count, n) after its kept lanes, each slot
//     written once.
//   * SEU counts across blocks: a tile adds them to the accumulators
//     before it publishes its first status; the last tile acquires every
//     other tile's inclusive prefix before it reads and zeroes the
//     accumulators.
//   * forward progress: a block waits only on lower-numbered tiles, which
//     were dispatched no later (blocks start in index order, as CUB's
//     single-pass scan assumes).
//   * count: the last tile writes its inclusive prefix.
//
// Every launch is a programmatic dependent of the kernel before it on the
// stream (the fabric walk on the serving path): its blocks may start
// while that kernel ends, and wait (griddepcontrol.wait) before their
// first access to global memory, so it is safe after any kernel (the
// kernel before may write any input, and an output may reuse memory it
// still reads). Before the wait a block only indexes its words and clears
// shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kWordsPerWarp = 2;
constexpr int kTileWords = kWarps * kWordsPerWarp;  // words a block
constexpr int kTileSlots = kTileWords * 32;         // events a block
constexpr int kMaxReplicas = 32;
constexpr int kNibbles = 8;                         // dense: 4 bits each
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kPrefix = 2u << 30;
constexpr unsigned kValue = kAggregate - 1u;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void wait_for_prior_grids() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A 32x32 bit transpose across the warp: lane r holds row r on entry and
// lane e returns the word whose bit r is bit e of row r. Five butterfly
// steps, each swapping bit k of the row and the column index.
__device__ __forceinline__ unsigned transpose32(unsigned x) {
  const int lane = threadIdx.x & 31;
  const unsigned masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int k = 16 >> i;
    const unsigned m = masks[i];
    const unsigned y = __shfl_xor_sync(kFull, x, k);
    x = (lane & k) ? ((x & ~m) | ((y >> k) & m)) : ((x & m) | ((y & m) << k));
  }
  return x;
}

// First o of the chip's weight row with a negative weight, else 0; the
// whole warp calls it with lane o holding weight o (o < 32) in `wl`.
__device__ __forceinline__ int sign_position(int wl,
                                             const int* __restrict__ w_row,
                                             int O) {
  const int lane = threadIdx.x & 31;
  unsigned neg = __ballot_sync(kFull, lane < O && wl < 0);
  for (int o0 = 32; !neg && o0 < O; o0 += 32) {  // rows wider than a warp
    const int o = o0 + lane;
    neg = __ballot_sync(kFull, o < O && w_row[o] < 0);
    if (neg) return o0 + __ffs(neg) - 1;
  }
  return neg ? __ffs(neg) - 1 : 0;
}

// Where a warp's k-th word of tile t lies: its flat index, chip and word
// within the chip (warp-uniform). Word and event indices fit in int (the
// launchers check), so the divisions are 32-bit.
struct WordAt {
  int gw, c, w;
  bool in;
};

__device__ __forceinline__ WordAt word_at(int t, int k, int W, int n_words) {
  WordAt a;
  a.gw = t * kTileWords + k * kWarps + (threadIdx.x >> 5);
  a.in = a.gw < n_words;
  a.c = a.in ? a.gw / W : 0;
  a.w = a.gw - a.c * W;
  return a;
}

// The prologue of a warp's words: valid words, the cut, and (sparse) the
// sign position. Loads first.
struct Prologue {
  unsigned vw;
  int thr, sp;
};

__device__ __forceinline__ void prologue(const WordAt* a,
                                         const int* __restrict__ out_weight,
                                         const int* __restrict__ threshold,
                                         const uint8_t* __restrict__ valid,
                                         int O, int B, bool signs,
                                         Prologue* p) {
  const int lane = threadIdx.x & 31;
  bool v[kWordsPerWarp];
  int wl[kWordsPerWarp];
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) {
    const int e = a[k].w * 32 + lane;
    v[k] = a[k].in && e < B && valid[a[k].c * B + e] != 0;
    wl[k] = signs && a[k].in && lane < O ? out_weight[a[k].c * O + lane] : 0;
    p[k].thr = a[k].in ? threshold[a[k].c] : 0;
  }
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) {
    p[k].vw = __ballot_sync(kFull, v[k]);
    p[k].sp = signs ? sign_position(wl[k], out_weight + a[k].c * O, O) : 0;
  }
}

// Chips [c0, c1] hold the tile's words (c1 < c0: the tile is empty).
__device__ __forceinline__ void tile_chips(int t, int W, int n_words,
                                           int* c0, int* c1) {
  const int first = t * kTileWords;
  const int last = min(first + kTileWords, n_words) - 1;
  *c0 = first / W;
  *c1 = last >= first ? last / W : *c0 - 1;
}

// The tile's SEU counts (s_dis, chips c0..c1) added to the accumulators;
// every thread calls it after s_dis is complete. The block's next
// release (after a __syncthreads) orders them before it.
__device__ __forceinline__ void add_counts(unsigned* __restrict__ acc,
                                           const int* s_dis, int c0, int c1,
                                           int R) {
  for (int i = threadIdx.x; i < (c1 - c0 + 1) * R; i += kThreads)
    if (s_dis[i]) atomicAdd(&acc[c0 * R + i], (unsigned)s_dis[i]);
}

// The accumulators read out into dis and zeroed (one block, after it
// acquired every other block's release that follows its add_counts).
__device__ __forceinline__ void take_counts(unsigned* __restrict__ acc,
                                            int n, int* __restrict__ dis) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dis[i] = (int)atomicExch(&acc[i], 0u);
}

// The sparse entries: decode-pack (voted != null) and keep-words
// (voted == null: keep_in and scores_in given, R == 0).
__global__ void __launch_bounds__(kThreads, 1)
pack_kernel(const int* __restrict__ voted,      // (C, W, O) or null
            const int* __restrict__ dis_w,      // (C, R, W)
            const int* __restrict__ out_weight, // (C, O)
            const int* __restrict__ threshold,  // (C,)
            const uint8_t* __restrict__ valid,  // (C, B)
            const int* __restrict__ keep_in,    // (C*W,) or null
            const int* __restrict__ scores_in,  // (C*W*32,) or null
            unsigned* __restrict__ state,
            int* __restrict__ count,            // ()
            int* __restrict__ idx,              // (C*W*32,)
            int* __restrict__ vals,             // (C*W*32,)
            int* __restrict__ dis,              // (C, R)
            int C, int W, int O, int R, int B) {
  __shared__ int s_base[kTileWords];
  __shared__ int s_dis[kTileWords * kMaxReplicas];
  __shared__ int s_prefix, s_count;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x;
  const bool single = gridDim.x == 1, last = t == (int)gridDim.x - 1;
  const int n_words = C * W, n = n_words * 32;
  const bool decode = voted != nullptr;
  unsigned* acc = state + 1;
  unsigned* status = acc + C * R;
  int c0, c1;
  tile_chips(t, W, n_words, &c0, &c1);
  WordAt a[kWordsPerWarp];
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) a[k] = word_at(t, k, W, n_words);
  for (int i = threadIdx.x; i < (c1 - c0 + 1) * R; i += kThreads)
    s_dis[i] = 0;
  // every access to global memory after this (see the head)
  wait_for_prior_grids();
  Prologue p[kWordsPerWarp] = {};
  if (decode) prologue(a, out_weight, threshold, valid, O, B, true, p);
  __syncthreads();

  // a block of several pads its slot range first (see the head)
  if (!single) {
    const int lo = t * kTileSlots, hi = min(lo + kTileSlots, n);
    for (int i = lo + 4 * threadIdx.x; i < hi; i += 4 * kThreads) {
      *reinterpret_cast<int4*>(idx + i) = make_int4(-1, -1, -1, -1);
      *reinterpret_cast<int4*>(vals + i) = make_int4(0, 0, 0, 0);
    }
  }
  // the words: every load first, then the decode. Plane j of a lane's
  // score is output word min(j, sign position); keep-words loads every
  // lane's score with the keep word, one round trip
  unsigned mine[kWordsPerWarp], dword[kWordsPerWarp];
  int s[kWordsPerWarp];
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) {
    mine[k] = 0u;
    dword[k] = 0u;
    s[k] = 0;
    if (!a[k].in) continue;
    if (decode) {
      if (O > 0)
        mine[k] = (unsigned)voted[(long long)a[k].gw * O + min(lane, p[k].sp)];
      if (lane < R) dword[k] = (unsigned)dis_w[(a[k].c * R + lane) * W + a[k].w];
    } else {
      mine[k] = (unsigned)keep_in[a[k].gw];
      s[k] = scores_in[a[k].gw * 32 + lane];
    }
  }
  unsigned kw[kWordsPerWarp];
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) {
    kw[k] = 0u;
    if (a[k].in) {
      if (decode) {
        s[k] = (int)transpose32(mine[k]);
        kw[k] = __ballot_sync(
            kFull, ((p[k].vw >> lane) & 1u) && s[k] <= p[k].thr);
        const int nd = lane < R ? __popc(dword[k] & p[k].vw) : 0;
        if (nd) atomicAdd(&s_dis[(a[k].c - c0) * R + lane], nd);
      } else {
        kw[k] = mine[k];
      }
    }
    if (lane == 0) s_base[k * kWarps + warp] = __popc(kw[k]);
  }
  __syncthreads();
  if (!single) add_counts(acc, s_dis, c0, c1, R);
  __syncthreads();             // padding and counts before the first status

  if (warp == 0) {
    // word bases in the tile: lane l scans words l and l + 32
    const int n0 = s_base[lane], n1 = s_base[lane + 32];
    int x0 = n0, x1 = n1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y0 = __shfl_up_sync(kFull, x0, off);
      const int y1 = __shfl_up_sync(kFull, x1, off);
      if (lane >= off) {
        x0 += y0;
        x1 += y1;
      }
    }
    const int half = __shfl_sync(kFull, x0, 31);
    s_base[lane] = x0 - n0;
    s_base[lane + 32] = half + x1 - n1;
    const int agg = half + __shfl_sync(kFull, x1, 31);
    int prefix = 0;
    if (!single && t == 0) {
      if (lane == 0) st_release(&status[0], kPrefix | (unsigned)agg);
    } else if (!single) {
      if (!last && lane == 0)
        st_release(&status[t], kAggregate | (unsigned)agg);
      // look back 32 tiles at a time: lane i polls tile j - i, until a
      // lane finds an inclusive prefix (tiles below 0: prefix 0)
      for (int j = t - 1;; j -= 32) {
        const int q = j - lane;
        unsigned st = kPrefix;
        if (q >= 0) {
          do {
            st = ld_acquire(&status[q]);
          } while ((st >> 30) == 0u);
        }
        const unsigned pm = __ballot_sync(kFull, (st >> 30) == 2u);
        const int stop = pm ? __ffs(pm) - 1 : 31;
        int v = lane <= stop ? (int)(st & kValue) : 0;
#pragma unroll
        for (int off = 16; off; off >>= 1)
          v += __shfl_xor_sync(kFull, v, off);
        prefix += v;
        if (pm) break;
      }
      __syncwarp();  // every lane's acquires before lane 0's release
      if (!last && lane == 0)
        st_release(&status[t], kPrefix | (unsigned)(prefix + agg));
    }
    if (lane == 0) {
      s_prefix = prefix;
      s_count = prefix + agg;
      if (last) *count = prefix + agg;
    }
  }
  __syncthreads();

  const int prefix = s_prefix;
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) {
    if (a[k].in && ((kw[k] >> lane) & 1u)) {
      const int pos = prefix + s_base[k * kWarps + warp] +
                      __popc(kw[k] & ((1u << lane) - 1u));
      idx[pos] = a[k].gw * 32 + lane;
      vals[pos] = s[k];
    }
  }
  if (single) {                               // the whole call, one block
    for (int i = s_count + threadIdx.x; i < n; i += kThreads) {
      idx[i] = -1;
      vals[i] = 0;
    }
    for (int i = threadIdx.x; i < C * R; i += kThreads) dis[i] = s_dis[i];
    return;
  }
  if (!last) return;
  // the last tile: once every other tile has published its inclusive
  // prefix (so added its counts and read its last status), take the
  // counts and zero the statuses
  for (int q = threadIdx.x; q < t; q += kThreads)
    while ((ld_acquire(&status[q]) >> 30) != 2u) {
    }
  __syncthreads();
  take_counts(acc, C * R, dis);
  for (int q = threadIdx.x; q < t; q += kThreads) status[q] = 0u;
}

// The dense entry: every event's score and keep flag, and dis. A score
// is the sum, over the nibbles of the lane's output bits, of a per-chip
// table of the nibble's weight sums (outputs past 32 add one by one).
__global__ void __launch_bounds__(kThreads, 1)
dense_kernel(const int* __restrict__ voted,      // (C, W, O)
             const int* __restrict__ dis_w,      // (C, R, W)
             const int* __restrict__ out_weight, // (C, O)
             const int* __restrict__ threshold,  // (C,)
             const uint8_t* __restrict__ valid,  // (C, B)
             unsigned* __restrict__ state,
             int* __restrict__ score,            // (C, B)
             uint8_t* __restrict__ keep,         // (C, B)
             int* __restrict__ dis,              // (C, R)
             int C, int W, int O, int R, int B) {
  __shared__ int s_dis[kTileWords * kMaxReplicas];
  __shared__ unsigned s_sum[kTileWords][kNibbles][16];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x;
  const int n_words = C * W;
  const int o32 = min(O, 32), n_nib = (o32 + 3) / 4;
  unsigned* acc = state + 1;
  int c0, c1;
  tile_chips(t, W, n_words, &c0, &c1);
  WordAt a[kWordsPerWarp];
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) a[k] = word_at(t, k, W, n_words);
  for (int i = threadIdx.x; i < (c1 - c0 + 1) * R; i += kThreads)
    s_dis[i] = 0;
  // every access to global memory after this (see the head)
  wait_for_prior_grids();
  Prologue p[kWordsPerWarp];
  prologue(a, out_weight, threshold, valid, O, B, false, p);
  // the nibble tables of the tile's chips (int32 sums wrap: unsigned)
  for (int i = threadIdx.x; i < (c1 - c0 + 1) * n_nib * 16; i += kThreads) {
    const int ch = i / (n_nib * 16), g = (i / 16) % n_nib, v = i % 16;
    const int* w_row = out_weight + (c0 + ch) * O + 4 * g;
    unsigned sum = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (((v >> b) & 1) && 4 * g + b < o32) sum += (unsigned)w_row[b];
    s_sum[ch][g][v] = sum;
  }
  __syncthreads();

  unsigned mine[kWordsPerWarp], dword[kWordsPerWarp];
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) {
    mine[k] = 0u;
    dword[k] = 0u;
    if (!a[k].in) continue;
    if (lane < o32) mine[k] = (unsigned)voted[(long long)a[k].gw * O + lane];
    if (lane < R) dword[k] = (unsigned)dis_w[(a[k].c * R + lane) * W + a[k].w];
  }
#pragma unroll
  for (int k = 0; k < kWordsPerWarp; ++k) {
    if (!a[k].in) continue;
    const unsigned bits = transpose32(mine[k]);   // bit o: output o
    const int ch = a[k].c - c0;
    unsigned s = 0u;
    for (int g = 0; g < n_nib; ++g) s += s_sum[ch][g][(bits >> (4 * g)) & 15u];
    for (int o0 = 32; o0 < O; o0 += 32) {         // rows wider than a warp
      const int o = o0 + lane;
      const int word = o < O ? voted[(long long)a[k].gw * O + o] : 0;
      const int weight = o < O ? out_weight[a[k].c * O + o] : 0;
      for (int i = 0; i < min(O - o0, 32); ++i) {
        const unsigned wo = (unsigned)__shfl_sync(kFull, word, i);
        const unsigned to = (unsigned)__shfl_sync(kFull, weight, i);
        s += (0u - ((wo >> lane) & 1u)) & to;
      }
    }
    const int e = a[k].w * 32 + lane;
    if (e < B) {
      const int at = a[k].c * B + e;
      score[at] = (int)s;
      keep[at] = ((p[k].vw >> lane) & 1u) && (int)s <= p[k].thr;
    }
    const int nd = lane < R ? __popc(dword[k] & p[k].vw) : 0;
    if (nd) atomicAdd(&s_dis[ch * R + lane], nd);
  }
  __syncthreads();
  if (gridDim.x == 1) {                       // the whole call, one block
    for (int i = threadIdx.x; i < C * R; i += kThreads) dis[i] = s_dis[i];
    return;
  }
  // several blocks: add the counts; the block counted done last takes
  // them and zeroes done
  add_counts(acc, s_dis, c0, c1, R);
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = add_acq_rel(&state[0], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  take_counts(acc, C * R, dis);
  if (threadIdx.x == 0) state[0] = 0u;
}

long long tiles(long long n_words) {
  const long long n = (n_words + kTileWords - 1) / kTileWords;
  return n > 0 ? n : 1;
}

// One block of kThreads a tile, a programmatic dependent launch.
cudaLaunchConfig_t config(long long blocks, cudaStream_t s,
                          cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// uint32 words of persistent state a launch needs (see the head).
long long sparse_pack_state_words(int C, int R, int W) {
  return 1 + (long long)C * R + tiles((long long)C * W);
}

// The sparse entries, one launch. Decode-pack (voted != null): voted
// (C, W, O), dis_w (C, R, W), out_weight (C, O), threshold (C,) int32 and
// valid (C, B) bool -> count (), idx (C*W*32,), vals (C*W*32,), dis
// (C, R) int32. Keep-words (voted == null): keep_in (C, W) and scores_in
// (C, W, 32) int32 -> count, idx, vals; dis_w, out_weight, threshold,
// valid and dis are unused and R is taken as 0. W == ceil(B/32) >= 1,
// R <= 32, idx and vals 16-byte aligned; `state` holds state_words
// uint32, zero. Launches on `stream`; returns the first CUDA error.
int sparse_pack_launch(const void* voted, const void* dis_w,
                       const void* out_weight, const void* threshold,
                       const void* valid, const void* keep_in,
                       const void* scores_in, void* state, void* count,
                       void* idx, void* vals, void* dis, int C, int W, int O,
                       int R, int B, long long state_words,
                       void* stream) {
  if (voted == nullptr) R = 0;
  const long long n_words = (long long)C * W;
  if (C < 0 || W <= 0 || R < 0 || R > kMaxReplicas ||
      n_words * 32 > (long long)kValue || (long long)C * B > kValue ||
      (long long)C * R * W > kValue ||
      state_words < sparse_pack_state_words(C, R, W))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)idx % 16 || (uintptr_t)vals % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(tiles(n_words), (cudaStream_t)stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pack_kernel, (const int*)voted, (const int*)dis_w,
      (const int*)out_weight, (const int*)threshold, (const uint8_t*)valid,
      (const int*)keep_in, (const int*)scores_in, (unsigned*)state,
      (int*)count, (int*)idx, (int*)vals, (int*)dis, C, W, O, R, B);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The dense entry, one launch: voted (C, W, O), dis_w (C, R, W),
// out_weight (C, O), threshold (C,) int32 and valid (C, B) bool -> score
// (C, B) int32, keep (C, B) bool, dis (C, R) int32. W == ceil(B/32) >= 1,
// R <= 32; `state` as above. Returns the first CUDA error.
int decode_dense_launch(const void* voted, const void* dis_w,
                        const void* out_weight, const void* threshold,
                        const void* valid, void* state, void* score,
                        void* keep, void* dis, int C, int W, int O, int R,
                        int B, long long state_words, void* stream) {
  const long long n_words = (long long)C * W;
  if (C < 0 || W <= 0 || R < 0 || R > kMaxReplicas ||
      n_words * 32 > (long long)kValue || (long long)C * B > kValue ||
      (long long)C * R * W > kValue ||
      state_words < sparse_pack_state_words(C, R, W))
    return (int)cudaErrorInvalidValue;
  if (n_words == 0) return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(tiles(n_words), (cudaStream_t)stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dense_kernel, (const int*)voted, (const int*)dis_w,
      (const int*)out_weight, (const int*)threshold, (const uint8_t*)valid,
      (unsigned*)state, (int*)score, (uint8_t*)keep, (int*)dis, C, W, O, R,
      B);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
