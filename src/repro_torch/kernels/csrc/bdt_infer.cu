// Quantized BDT inference as a per-event tree walk: feature select,
// compare, `depth` routing steps and the 14-bit hi/lo leaf readout, all
// 128 output columns, bit-identical to the reference's one-hot products.
//
// Replaces: repro/kernels/bdt_infer/bdt_infer.py bdt_infer_pallas (body
// _kernel, :68). Its arithmetic: fval = sum_f x[:, f] * featsel[f, :] in
// wrapping int32, cond = fval <= thr, h = root, then `depth` times
// h = (h*cond) @ left + (h - h*cond) @ right in float32, and
// out = (int(h @ value_hi) << 14) + int(h @ value_lo).
//
// Why not the products. The TPU kernel multiplies one-hot matrices
// because gathers are slow on its vector unit. The packing
// (ops.pack_ensemble) makes every row of left/right hold exactly one 1
// (the child, or a self-loop), every featsel column at most one 1 and
// root one 1 per tree, so a (P x P) product does P multiply-adds for
// each one that matters (about 397k flops per event at P=128, depth 5).
// Here each event follows the pointers instead:
//   p = root_k; depth times p = (x[feat[p]] <= thr[p]) ? lc[p] : rc[p]
// (a node with no feature compares 0, as the MAC gives), and the
// readout adds value_hi/value_lo of each tree's reached node in
// ascending node order. That is the reference's float32 chain
// acc = fmaf(h[p], w, acc) over ascending p with the zero terms left
// out, which are exact no-ops: so the walk reproduces this kernel's
// literal chain for any finite values, and the plain twin's matmul
// wherever its sums are integers below 2^24 (any order agrees there).
//
// Bound on the H100: by bytes. An event reads F * 4 bytes of features
// and writes its 512-byte output row; the walk is depth compare/selects
// per tree. At the §5 chunk (65,536 events) the output writes are 33.5
// of the 37.2 MB, 0.011 ms at 3.35 TB/s.
//
// Two passes on one stream:
//  1. bdt_table_kernel, a warp per node p: the column of the single 1 in
//     row p of left and of right, the feature of featsel column p (or
//     -1), thr[p], and meta[p] = root bit | flag << 1, the flag set when
//     the arrays leave the one-hot form at p (a left/right row that is
//     not exactly one 1.0 and zeros, a featsel column with more than one
//     nonzero or an entry other than 0/1, a root entry other than 0/1, a
//     non-finite leaf value). It issues all of a node's reads before its
//     first warp reduction. Rebuilt every launch into a scratch buffer
//     the wrapper passes: the kernel takes raw arrays, and a cache keyed
//     on them would have to notice every write to them.
//  2. bdt_walk_kernel, launched as a programmatic dependent of pass 1: a
//     block owns `tile` events and copies their features into shared
//     memory while pass 1 runs, then waits for it (griddepcontrol.wait),
//     stages the node table (16 B a node) and numbers the roots; node p
//     belongs to the segment of the last root at or before it. Each walk
//     must stay in its root's segment (every child of a node in segment
//     k lies in segment k), so that no node is reached twice and the
//     reached nodes ascend with the roots. If that holds and no node is
//     flagged, each half-warp walks one event (two a warp, so that their
//     dependent shared-memory reads overlap): lane l of the half owns
//     output columns 4l..4l+3 and 64+4l..64+4l+3, reads the reached rows
//     of value_hi/value_lo as float4 (L1) and writes 2 x 16 bytes of the
//     512-byte row, 256 contiguous bytes a store. Otherwise the block
//     runs the literal node-parallel body (`literal_tile`, 8 events at a
//     time, the arrays read as given), so the result is the reference's
//     for any input. Every block decides alike.
// Integer steps run in uint32 so that wrapping is defined; float-to-int
// conversions truncate, as the reference's casts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTableThreads = 256;
constexpr int kEv = 8;          // events per literal sub-tile and thread
constexpr int kOut = 128;       // output columns (column 0 holds the score)
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void load8(const float* p, float v[kEv]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Row scan of pass 1: lane `lane`'s share of a row of P floats (float4
// reads when P % 4 == 0), the count of its 1.0 entries, the column of its
// last one, and whether it holds an entry other than 0 or 1.
struct RowPart {
  int ones, col;
  bool odd;
};

__device__ __forceinline__ void scan(float v, int j, RowPart& r) {
  r.odd |= v != 0.f && v != 1.f;
  if (v == 1.f) {
    ++r.ones;
    r.col = j;
  }
}

__device__ __forceinline__ RowPart scan_row(const float* __restrict__ row,
                                            int P, int lane) {
  RowPart r = {0, -1, false};
  if ((P & 3) == 0) {
    for (int j = 4 * lane; j < P; j += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + j));
      scan(v.x, j, r); scan(v.y, j + 1, r);
      scan(v.z, j + 2, r); scan(v.w, j + 3, r);
    }
  } else {
    for (int j = lane; j < P; j += 32) scan(__ldg(row + j), j, r);
  }
  return r;
}

// The row's single 1.0 (its column), or -1 with `bad` set.
__device__ __forceinline__ int one_hot_col(const RowPart& r, bool& bad) {
  const int total = __reduce_add_sync(kFull, r.ones);
  bad |= __any_sync(kFull, r.odd) || total != 1;
  const unsigned who = __ballot_sync(kFull, r.ones > 0);
  return who ? __shfl_sync(kFull, r.col, __ffs(who) - 1) : -1;
}

// Pass 1: node p's table entry and meta word, one warp per node. Every
// read is issued before the first warp reduction, so the pass waits on
// device memory about once.
__global__ void __launch_bounds__(kTableThreads)
bdt_table_kernel(const int* __restrict__ featsel,    // (F, P)
                 const int* __restrict__ thr,        // (P,)
                 const float* __restrict__ root,     // (P,)
                 const float* __restrict__ left,     // (P, P)
                 const float* __restrict__ right,    // (P, P)
                 const float* __restrict__ vhi,      // (P, 128)
                 const float* __restrict__ vlo,      // (P, 128)
                 int4* __restrict__ node,            // (P,) feat, thr, lc, rc
                 int* __restrict__ meta,             // (P,)
                 int F, int P) {
  // the walk may launch now: it waits for this grid before it reads
  // the table
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (kTableThreads / 32) + (threadIdx.x >> 5);
  if (p >= P) return;                                // warp-uniform
  const RowPart lrow = scan_row(left + (size_t)p * P, P, lane);
  const RowPart rrow = scan_row(right + (size_t)p * P, P, lane);
  RowPart fcol = {0, -1, false};
  for (int f = lane; f < F; f += 32) {
    const int v = __ldg(featsel + (size_t)f * P + p);
    fcol.odd |= v != 0 && v != 1;
    if (v == 1) {
      ++fcol.ones;
      fcol.col = f;
    }
  }
  const float4 h = __ldg(reinterpret_cast<const float4*>(vhi) + p * 32 + lane);
  const float4 l = __ldg(reinterpret_cast<const float4*>(vlo) + p * 32 + lane);
  const float r = __ldg(root + p);
  const int t = __ldg(thr + p);

  bool bad = false;
  const int lc = one_hot_col(lrow, bad);
  const int rc = one_hot_col(rrow, bad);
  // a featsel column holds at most one 1 and no other nonzero
  const int n_feat = __reduce_add_sync(kFull, fcol.ones);
  bad |= __any_sync(kFull, fcol.odd) || n_feat > 1;
  const unsigned who = __ballot_sync(kFull, fcol.ones > 0);
  const int feat = who ? __shfl_sync(kFull, fcol.col, __ffs(who) - 1) : -1;
  bad |= !(r == 0.f || r == 1.f);
  bad |= !__all_sync(kFull, isfinite(h.x) && isfinite(h.y) &&
                                isfinite(h.z) && isfinite(h.w) &&
                                isfinite(l.x) && isfinite(l.y) &&
                                isfinite(l.z) && isfinite(l.w));
  if (lane == 0) {
    // a flagged node points at itself, so that every index stays in range
    node[p] = make_int4(feat, t, bad ? p : lc, bad ? p : rc);
    meta[p] = (r == 1.f ? 1 : 0) | (bad ? 2 : 0);
  }
}

// The reference's node-parallel body for events [b0, b0 + n_ev), n_ev <=
// kEv, in `smem` (4 x P x kEv f32, event fastest): feature MAC, compare,
// the routing products and the readout products, literally.
__device__ void literal_tile(const int* __restrict__ x,
                             const int* __restrict__ featsel,
                             const int* __restrict__ thr,
                             const float* __restrict__ root,
                             const float* __restrict__ left,
                             const float* __restrict__ right,
                             const float* __restrict__ vhi,
                             const float* __restrict__ vlo,
                             int* __restrict__ out, float* smem, int b0,
                             int n_ev, int F, int P, int depth) {
  constexpr int T = kEv;
  const size_t PT = (size_t)P * T;
  float* cond = smem;               // [P][T]
  float* h = smem + PT;             // [P][T]
  float* gl = smem + 2 * PT;        // [P][T]  h * cond
  float* gr = smem + 3 * PT;        // [P][T]  h - h * cond

  for (int i = threadIdx.x; i < P * T; i += blockDim.x) {
    const int p = i / T, t = i - p * T;
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

  for (int d = 0; d < depth; ++d) {
    for (int i = threadIdx.x; i < P * T; i += blockDim.x) {
      const float g = h[i] * cond[i];
      gl[i] = g;
      gr[i] = h[i] - g;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < P; q += blockDim.x) {
      float al[T], ar[T];
#pragma unroll
      for (int e = 0; e < T; ++e) al[e] = ar[e] = 0.f;
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        const float wl = __ldg(left + (size_t)p * P + q);
        const float wr = __ldg(right + (size_t)p * P + q);
        float a[T], b[T];
        load8(gl + (size_t)p * T, a);
        load8(gr + (size_t)p * T, b);
#pragma unroll
        for (int e = 0; e < T; ++e) {
          al[e] = fmaf(a[e], wl, al[e]);
          ar[e] = fmaf(b[e], wr, ar[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < T; ++e)
        h[(size_t)q * T + e] = __fadd_rn(al[e], ar[e]);
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < kOut; j += blockDim.x) {
    float hi[T], lo[T];
#pragma unroll
    for (int e = 0; e < T; ++e) hi[e] = lo[e] = 0.f;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float wh = __ldg(vhi + (size_t)p * kOut + j);
      const float wl = __ldg(vlo + (size_t)p * kOut + j);
      float a[T];
      load8(h + (size_t)p * T, a);
#pragma unroll
      for (int e = 0; e < T; ++e) {
        hi[e] = fmaf(a[e], wh, hi[e]);
        lo[e] = fmaf(a[e], wl, lo[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < T; ++e) {
      if (e < n_ev) {
        const uint32_t v = ((uint32_t)__float2int_rz(hi[e]) << 14) +
                           (uint32_t)__float2int_rz(lo[e]);
        out[(size_t)(b0 + e) * kOut + j] = (int)v;
      }
    }
  }
  __syncthreads();                  // smem is reused by the next sub-tile
}

__device__ __forceinline__ uint32_t halves(float hi, float lo) {
  return ((uint32_t)__float2int_rz(hi) << 14) + (uint32_t)__float2int_rz(lo);
}

__device__ __forceinline__ int4 halves4(float4 hi, float4 lo) {
  return make_int4((int)halves(hi.x, lo.x), (int)halves(hi.y, lo.y),
                   (int)halves(hi.z, lo.z), (int)halves(hi.w, lo.w));
}

// acc += v per lane, rounded as fmaf(1, v, acc) rounds
__device__ __forceinline__ void add4(float4& acc, float4 v) {
  acc.x = __fadd_rn(acc.x, v.x); acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z); acc.w = __fadd_rn(acc.w, v.w);
}

// Pass 2: the walk (one-hot form) or the literal body, per block.
__global__ void __launch_bounds__(kThreads)
bdt_walk_kernel(const int* __restrict__ x,          // (B, F)
                const int* __restrict__ featsel,    // (F, P)
                const int* __restrict__ thr,        // (P,)
                const float* __restrict__ root,     // (P,)
                const float* __restrict__ left,     // (P, P)
                const float* __restrict__ right,    // (P, P)
                const float* __restrict__ vhi,      // (P, 128)
                const float* __restrict__ vlo,      // (P, 128)
                const int4* __restrict__ node,      // (P,) from pass 1
                const int* __restrict__ meta,       // (P,) from pass 1
                int* __restrict__ out,              // (B, 128)
                int B, int F, int P, int depth, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* node_s = reinterpret_cast<int4*>(smem);              // [P]
  int* seg_s = reinterpret_cast<int*>(smem + 16 * (size_t)P);  // [P]
  int* roots_s = seg_s + P;                                   // [P]
  const int n_words = (P + 31) / 32;
  unsigned* words = reinterpret_cast<unsigned*>(roots_s + P);  // [n_words]
  int* x_s = reinterpret_cast<int*>(words + n_words);          // [tile][F]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * tile;
  const int n_ev = min(tile, B - b0);

  // the tile's features (coalesced), while the table pass may still run;
  // then the node table, the root bits as ballot words, any flagged node
  for (int i = threadIdx.x; i < n_ev * F; i += blockDim.x)
    x_s[i] = x[(size_t)b0 * F + i];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  int bad = 0;
  for (int base = 0; base < P; base += blockDim.x) {
    const int p = base + threadIdx.x;
    const int m = p < P ? meta[p] : 0;
    if (p < P) node_s[p] = node[p];
    bad |= m >> 1;
    const unsigned bits = __ballot_sync(kFull, m & 1);
    if (lane == 0 && base + warp * 32 < P) words[(base >> 5) + warp] = bits;
  }
  __syncthreads();
  // segment = roots at or before p, less one; the k-th root's index
  int n_roots = 0;
  for (int k = 0; k < n_words; ++k) n_roots += __popc(words[k]);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int w = p >> 5, b = p & 31;
    int c = __popc(words[w] & (kFull >> (31 - b)));
    for (int k = 0; k < w; ++k) c += __popc(words[k]);
    seg_s[p] = c - 1;
    if ((words[w] >> b) & 1u) roots_s[c - 1] = p;
  }
  __syncthreads();
  // every child of a node in segment k lies in segment k
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int s = seg_s[p];
    if (s >= 0) {
      const int4 nd = node_s[p];
      bad |= seg_s[nd.z] != s || seg_s[nd.w] != s;
    }
  }
  if (__syncthreads_or(bad)) {
    float* f = reinterpret_cast<float*>(smem);
    for (int s0 = 0; s0 < n_ev; s0 += kEv)
      literal_tile(x, featsel, thr, root, left, right, vhi, vlo, out, f,
                   b0 + s0, min(kEv, n_ev - s0), F, P, depth);
    return;
  }

  // two events a warp at a time, one a half-warp: lane l of a half owns
  // output columns 4l..4l+3 and 64+4l..64+4l+3, so that the two walks'
  // dependent reads overlap and every store writes 256 contiguous bytes
  const int half = lane >> 4, hl = lane & 15;
  const int n_warps = blockDim.x >> 5;
  const float4* vhi4 = reinterpret_cast<const float4*>(vhi);
  const float4* vlo4 = reinterpret_cast<const float4*>(vlo);
  for (int e = 2 * warp + half; e - half < n_ev; e += 2 * n_warps) {
    if (e >= n_ev) continue;
    const size_t ev = (size_t)b0 + e;
    const int* xe = x_s + e * F;
    float4 hi0 = make_float4(0.f, 0.f, 0.f, 0.f), hi1 = hi0, lo0 = hi0,
           lo1 = hi0;
    for (int k = 0; k < n_roots; ++k) {
      int p = roots_s[k];
      for (int d = 0; d < depth; ++d) {
        const int4 nd = node_s[p];
        p = ((nd.x < 0 ? 0 : xe[nd.x]) <= nd.y) ? nd.z : nd.w;
      }
      const float4* vh = vhi4 + (size_t)p * (kOut / 4) + hl;
      const float4* vl = vlo4 + (size_t)p * (kOut / 4) + hl;
      add4(hi0, __ldg(vh)); add4(hi1, __ldg(vh + 16));
      add4(lo0, __ldg(vl)); add4(lo1, __ldg(vl + 16));
    }
    int4* o = reinterpret_cast<int4*>(out + ev * kOut) + hl;
    o[0] = halves4(hi0, lo0);
    o[16] = halves4(hi1, lo1);
  }
}

}  // namespace

extern "C" {

// Scratch the wrapper passes: the node table (16 B a node) and the meta
// words (4 B a node).
long long bdt_infer_scratch_bytes(int P) { return 20LL * P; }

// Dynamic shared memory of a walk block of `tile` events: the larger of
// the literal body's 4 x P x 8 f32 and the walk's node table, segments,
// roots, root bits and the tile's features.
long long bdt_infer_smem_bytes(int P, int F, int tile) {
  const long long walk =
      24LL * P + 4LL * ((P + 31) / 32) + 4LL * tile * F;
  const long long literal = 4LL * P * kEv * 4;
  return walk > literal ? walk : literal;
}

// x (B, F) i32; featsel (F, P) i32; thr (P,) i32; root (P,) f32; left,
// right (P, P) f32; value_hi, value_lo (P, 128) f32; scratch of
// bdt_infer_scratch_bytes(P), 16-byte aligned -> out (B, 128) i32.
// `tile` (events per block) is a multiple of 8. Launches both passes on
// `stream`; returns cudaGetLastError (or the cudaFuncSetAttribute error).
int bdt_infer_launch(const void* x, const void* featsel, const void* thr,
                     const void* root, const void* left, const void* right,
                     const void* value_hi, const void* value_lo,
                     void* scratch, void* out, int B, int F, int P,
                     int depth, int tile, void* stream) {
  if (B <= 0) return 0;
  if (P <= 0 || tile <= 0 || tile % kEv) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int4* node = (int4*)scratch;
  int* meta = (int*)(node + P);
  const int per_block = kTableThreads / 32;
  bdt_table_kernel<<<(P + per_block - 1) / per_block, kTableThreads, 0, s>>>(
      (const int*)featsel, (const int*)thr, (const float*)root,
      (const float*)left, (const float*)right, (const float*)value_hi,
      (const float*)value_lo, node, meta, F, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long smem = bdt_infer_smem_bytes(P, F, tile);
  err = cudaFuncSetAttribute(bdt_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // programmatic dependent launch: the walk's blocks start (and copy
  // their features) while the table pass runs
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + tile - 1) / tile);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, bdt_walk_kernel, (const int*)x, (const int*)featsel,
      (const int*)thr, (const float*)root, (const float*)left,
      (const float*)right, (const float*)value_hi, (const float*)value_lo,
      (const int4*)node, (const int*)meta, (int*)out, B, F, P, depth, tile);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
