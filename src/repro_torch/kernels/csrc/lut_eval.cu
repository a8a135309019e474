// Selection-matmul fabric evaluation, dense and banded, as a gather over
// the ones of `sel`: every level's routing, 4-bit LUT index and
// truth-table read for a tile of events, the whole net buffer kept in
// shared memory.
//
// Replaces: repro/kernels/lut_eval/lut_eval.py lut_eval_pallas_stacked
// (body _kernel) and lut_eval_pallas_banded_stacked (body
// _banded_kernel), and their C=1 forms lut_eval_pallas /
// lut_eval_pallas_banded. A null `win_base` selects the dense row view
// (all N rows of the buffer); otherwise level l routes from the input
// segment [0, in_seg) followed by the window [win_base[l],
// win_base[l] + rows - in_seg) of the buffer. A window row whose buffer
// row falls outside [0, N) reads 0.
//
// The TPU kernel writes the routing as a dense (B, rows) x (rows, 4M)
// product because gathers are slow on its vector unit. `sel` is a
// one-hot selection: the packing puts exactly one 1 in each column of a
// real LUT input and none in a padded slot (216 LUTs give 864 ones in
// the 7.67 M entries of the paper chip's banded `sel`). So here each of
// the 4M columns sums the buffer values at the rows where its `sel` is
// 1, read from shared memory.
//
// Bound on the H100: by bytes. The work is the ones of `sel` times the
// events plus 4M index/table steps per level and event, far below the
// bytes: `sel` read once, bits_ext read once and the (C, B, N) f32
// buffer written once, which dominates at the §5 chunk (0.175 ms for
// 65,536 events, banded); at the 12-row served shape reading `sel`
// dominates.
//
// Two passes, both launched by lut_eval_launch on one stream:
//  1. sel_lists_kernel reads `sel` once (16 bytes, 8 columns, a thread)
//     and writes for each (c, l, column) the rows holding a 1 (an ELL
//     list of kCap rows) and their count. A column with more than kCap
//     ones, or any entry that is neither 0 nor 1, gets a count above
//     kCap: the main pass then walks that column of `sel` itself, so
//     the result is the product for any `sel`. The counts are zeroed by
//     cudaMemsetAsync first; rows enter a list in no fixed order.
//  2. lut_eval_kernel: a block owns one chip row and a tile of `tile`
//     events, and keeps the tile's net buffer (N x tile f32, event
//     fastest) and a result staging area (M x tile) in dynamic shared
//     memory. The input segment is copied in with cp.async; each
//     level's tables (M x 16 f32), lists and counts are staged with
//     cp.async into one of two buffers: a level issues the next one's
//     copies (and loads its level_base / win_base) before it computes,
//     so they are in flight while it works. In a level a thread owns
//     one LUT slot m and 4 events: for k = 0..3 it sums the buffer rows
//     listed for column k*M + m (float4 reads), forms the index with
//     the reference's rounding order ((i0 + 2 i1) + 4 i2) + 8 i3, reads
//     the table (0 outside [0, 16)) and writes the staging area. Every
//     slot is written, padded ones too (an empty column gives index 0).
//     After a barrier the staging area is copied to the level's slots
//     at level_base[l], so no thread reads a slot while another writes
//     it. Finally the buffer goes out with 16-byte stores.
//
// Exactness: with 0/1 buffer values (bits_ext and tables 0/1, as the
// packing makes them) every column sum is a small integer, exact in f32
// in any order, so the buffer equals the plain twin's bit for bit for
// any 0/1 `sel`: empty, one-hot or several-ones columns.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCap = 4;          // list rows per column
constexpr int kMaxThreads = 512;
constexpr int kListThreads = 256;
constexpr int kListBlocks = 2048;
constexpr uint16_t kBf16One = 0x3F80;

__device__ __forceinline__ float bf16_to_f32(uint16_t u) {
  return __uint_as_float((uint32_t)u << 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Pass 1: the rows of each (c, l, column) where sel is 1. One unit is
// 8 columns (16 bytes) of one row; almost every unit is all zero.
__global__ void __launch_bounds__(kListThreads)
sel_lists_kernel(const uint16_t* __restrict__ sel,  // (C*L, rows, 4M)
                 int* __restrict__ lists,           // (C*L, 4M, kCap)
                 int* __restrict__ counts,          // (C*L, 4M), zeroed
                 long long units, int rows, int M4) {
  const int G = M4 / 8;
  for (long long u = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       u < units; u += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(u % G);
    const long long cr = u / G;                  // (c*L + l) * rows + r
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(sel) + u);
    if ((w.x | w.y | w.z | w.w) == 0u) continue;
    const int r = (int)(cr % rows);
    const long long col0 = (cr / rows) * M4 + (long long)g * 8;
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint16_t h = (uint16_t)(ws[e >> 1] >> (16 * (e & 1)));
      if ((h & 0x7FFF) == 0) continue;           // +0 or -0
      const long long j = col0 + e;
      if (h == kBf16One) {
        const int p = atomicAdd(counts + j, 1);
        if (p < kCap) lists[j * kCap + p] = r;
      } else {
        atomicAdd(counts + j, kCap + 1);         // walk this column
      }
    }
  }
}

// cp.async of level cl's tables, lists and counts into one stage buffer
__device__ __forceinline__ void stage_level(float* tb_s, int* ls_s,
                                            int* cn_s,
                                            const float* __restrict__ tables,
                                            const int* __restrict__ lists,
                                            const int* __restrict__ counts,
                                            size_t cl, int M) {
  const int M4 = 4 * M;
  const float* tg = tables + cl * M * 16;
  for (int i = threadIdx.x; i < M * 4; i += blockDim.x)
    cp_async16(tb_s + 4 * i, tg + 4 * i);
  const int* lg = lists + cl * M4 * kCap;
  for (int i = threadIdx.x; i < M4 * kCap / 4; i += blockDim.x)
    cp_async16(ls_s + 4 * i, lg + 4 * i);
  const int* cg = counts + cl * M4;
  for (int i = threadIdx.x; i < M4 / 4; i += blockDim.x)
    cp_async16(cn_s + 4 * i, cg + 4 * i);
}

__device__ __forceinline__ void add4(float4& a, const float4 v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}

__global__ void __launch_bounds__(kMaxThreads)
lut_eval_kernel(const float* __restrict__ bits_ext,   // (C, B, in_seg)
                const uint16_t* __restrict__ sel,     // (C, L, rows, 4M)
                const float* __restrict__ tables,     // (C, L, M, 16)
                const int* __restrict__ level_base,   // (L,)
                const int* __restrict__ win_base,     // (L,) or null
                const int* __restrict__ lists,        // (C, L, 4M, kCap)
                const int* __restrict__ counts,       // (C, L, 4M)
                float* __restrict__ out,              // (C, B, N)
                int B, int in_seg, int L, int rows, int M, int N,
                int tile) {
  extern __shared__ __align__(16) float smem[];
  const int M4 = 4 * M;
  const int stage = 16 * M + M4 * kCap + M4;     // 4-byte words per stage
  float* vals = smem;                            // [N][tile]
  float* res = vals + (size_t)N * tile;          // [M][tile]
  float* st = res + (size_t)M * tile;            // 2 x stage
  const int c = blockIdx.y;
  const int b0 = blockIdx.x * tile;
  const int n_ev = min(tile, B - b0);
  const int n_in = min(in_seg, N);

  // the input segment (const0 | const1 | inputs | pad) into rows
  // [0, in_seg) and level 0's stage; events past B read zero and are
  // never stored
  for (int i = threadIdx.x; i < n_in * tile; i += blockDim.x) {
    const int n = i / tile, t = i - n * tile;
    if (t < n_ev)
      cp_async4(vals + i, bits_ext + ((size_t)c * B + b0 + t) * in_seg + n);
    else
      vals[i] = 0.f;
  }
  stage_level(st, (int*)st + 16 * M, (int*)st + 16 * M + M4 * kCap, tables,
              lists, counts, (size_t)c * L, M);
  cp_async_commit();
  float4* v4 = reinterpret_cast<float4*>(vals);
  for (int i = n_in * tile / 4 + threadIdx.x; i < N * tile / 4;
       i += blockDim.x)
    v4[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int Q = tile / 4;                        // event quads per slot
  const int items = M * Q;
  const float4* V4 = reinterpret_cast<const float4*>(vals);
  float4* res4 = reinterpret_cast<float4*>(res);
  // window rows r >= in_seg read buffer row r + shift; level l writes
  // its slots from base. Each level loads the next one's, so no global
  // load waits inside a level.
  int shift = (win_base ? __ldg(win_base) : in_seg) - in_seg;
  int base = __ldg(level_base);
  for (int l = 0; l < L; ++l) {
    // level l's stage (issued a level ahead) has landed everywhere, and
    // level l-1 is done with the other stage buffer: level l+1 goes there
    cp_async_wait_all();
    __syncthreads();
    int shift_next = 0, base_next = 0;
    if (l + 1 < L) {
      shift_next = (win_base ? __ldg(win_base + l + 1) : in_seg) - in_seg;
      base_next = __ldg(level_base + l + 1);
      float* nb = st + ((l + 1) & 1) * stage;
      stage_level(nb, (int*)nb + 16 * M, (int*)nb + 16 * M + M4 * kCap,
                  tables, lists, counts, (size_t)c * L + l + 1, M);
      cp_async_commit();
    }
    const float* tb = st + (l & 1) * stage;
    const int4* ls = reinterpret_cast<const int4*>(tb + 16 * M);
    const int* cn = reinterpret_cast<const int*>(tb + 16 * M + M4 * kCap);
    const uint16_t* S = sel + ((size_t)c * L + l) * rows * M4;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int m = it / Q;
      const int q = it - m * Q;
      float4 a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        const int j = k * M + m;
        const int cnt = cn[j];
        if (cnt <= kCap) {
          const int4 lr = ls[j];
          const int rr[kCap] = {lr.x, lr.y, lr.z, lr.w};
#pragma unroll
          for (int p = 0; p < kCap; ++p) {
            if (p >= cnt) break;
            const int r = rr[p];
            const int n = r < in_seg ? r : r + shift;
            if ((unsigned)n < (unsigned)N) add4(a[k], V4[n * Q + q]);
          }
        } else {
          // more ones than the list holds, or a value other than 0/1:
          // the column's product, row by row
          for (int r = 0; r < rows; ++r) {
            const uint16_t h = __ldg(S + (size_t)r * M4 + j);
            if ((h & 0x7FFF) == 0) continue;
            const int n = r < in_seg ? r : r + shift;
            if ((unsigned)n >= (unsigned)N) continue;
            const float s = bf16_to_f32(h);
            const float4 v = V4[n * Q + q];
            a[k].x = fmaf(v.x, s, a[k].x);
            a[k].y = fmaf(v.y, s, a[k].y);
            a[k].z = fmaf(v.z, s, a[k].z);
            a[k].w = fmaf(v.w, s, a[k].w);
          }
        }
      }
      const float i0[4] = {a[0].x, a[0].y, a[0].z, a[0].w};
      const float i1[4] = {a[1].x, a[1].y, a[1].z, a[1].w};
      const float i2[4] = {a[2].x, a[2].y, a[2].z, a[2].w};
      const float i3[4] = {a[3].x, a[3].y, a[3].z, a[3].w};
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // ((ins0 + 2 ins1) + 4 ins2) + 8 ins3, rounded step by step
        const float f = __fadd_rn(
            __fadd_rn(__fadd_rn(i0[e], __fmul_rn(2.f, i1[e])),
                      __fmul_rn(4.f, i2[e])),
            __fmul_rn(8.f, i3[e]));
        const int idx = __float2int_rz(f);
        o[e] = (idx >= 0 && idx < 16) ? tb[m * 16 + idx] : 0.f;
      }
      res4[it] = make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(vals);
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int n = base + i / Q;
      if ((unsigned)n < (unsigned)N) dst[n * Q + (i % Q)] = res4[i];
    }
    shift = shift_next;
    base = base_next;
  }
  __syncthreads();

  // out[c][b0 + t][n]: a thread gathers 4 nets of one event, one
  // 16-byte store
  for (int i = threadIdx.x; i < N / 4 * tile; i += blockDim.x) {
    const int nq = i / tile, t = i - nq * tile;
    if (t >= n_ev) continue;
    const float* v = vals + (size_t)4 * nq * tile + t;
    *reinterpret_cast<float4*>(out + ((size_t)c * B + b0 + t) * N + 4 * nq) =
        make_float4(v[0], v[tile], v[2 * tile], v[3 * tile]);
  }
}

}  // namespace

extern "C" {

// bits_ext (C, B, in_seg) f32; sel (C, L, rows, 4M) bf16 with M even;
// tables (C, L, M, 16) f32; level_base (L,) i32; win_base (L,) i32 or
// null (dense); lists (C, L, 4M, cap) i32 and counts (C, L, 4M) i32
// scratch -> out (C, B, N) f32 with N a multiple of 4. `cap` must equal
// the kernel's list capacity; `tile` is a multiple of 4 whose
// (N + M) x tile x 4 B plus two level stages fit in shared memory. All
// pointers 16-byte aligned.
// Launches both passes on `stream`; returns cudaGetLastError (or the
// first error of the set-up calls).
int lut_eval_launch(const void* bits_ext, const void* sel,
                    const void* tables, const void* level_base,
                    const void* win_base, void* lists, void* counts,
                    void* out, int C, int B, int in_seg, int L, int rows,
                    int M, int N, int tile, int cap, void* stream) {
  if (C <= 0 || B <= 0 || L <= 0) return 0;
  if (cap != kCap || tile <= 0 || tile % 4 || M <= 0 || M % 2 || N % 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int M4 = 4 * M;
  cudaError_t err =
      cudaMemsetAsync(counts, 0, (size_t)C * L * M4 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)C * L * rows * (M4 / 8);
  long long blocks = (units + kListThreads - 1) / kListThreads;
  if (blocks > kListBlocks) blocks = kListBlocks;
  if (blocks > 0)
    sel_lists_kernel<<<(int)blocks, kListThreads, 0, s>>>(
        (const uint16_t*)sel, (int*)lists, (int*)counts, units, rows, M4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = ((size_t)(N + M) * tile +
                       2 * (size_t)(16 * M + M4 * kCap + M4)) *
                      sizeof(float);
  err = cudaFuncSetAttribute(lut_eval_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int items = M * (tile / 4);
  int threads = items < kMaxThreads ? items : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid((B + tile - 1) / tile, C);
  lut_eval_kernel<<<grid, threads, smem, s>>>(
      (const float*)bits_ext, (const uint16_t*)sel, (const float*)tables,
      (const int*)level_base, (const int*)win_base, (const int*)lists,
      (const int*)counts, (float*)out, B, in_seg, L, rows, M, N, tile);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
