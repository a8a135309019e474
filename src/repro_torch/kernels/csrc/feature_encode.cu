// Section 5 check, on the card: float feature rows -> the fabric's
// offset-binary input bits, one (B, n_used * W) int32 row of 0/1 an event.
//
// Replaces no TPU kernel. The JAX package quantizes and encodes the
// check's rows on the host (numpy: QuantizedEnsemble.quantize_features,
// then SynthResult.encode_inputs) and hands the bits to the fabric. The
// port did the same, and its check spent ~90% of its window there on the
// H100 (65,536-row chunks: the host encode, then a pageable copy of 51 MB
// of int32 bits a chunk). This kernel takes the rows as they are (3.7 MB a
// chunk in float32) and writes the bits on the card.
//
// Arithmetic: exactly quantize_raw, then to_unsigned_bits
// (core/quantize.py). Each used feature is widened to float64 (a float64
// row is taken as it is); s = x * scale and, for AP_RND, s + 0.5, as two
// separate roundings (__dmul_rn, __dadd_rn: nvcc would contract them into
// one FMA); floor; int64 as numpy casts on x86_64 (cvttsd2si): exact in
// [-2^63, 2^63), and INT64_MIN, the "integer indefinite", for NaN, +-inf
// and every value past that range (a plain C cast on the card saturates
// instead); wrap by the floored modulo 2^W (the low W bits: INT64_MIN
// wraps to 0), or clip for AP_SAT (INT64_MIN clips to raw_min); then the
// sign bit of the W-bit pattern flipped. Any W up to 62 works, and every
// row gives the host's bits.
//
// Bound on the H100: device-memory bytes. Each row is read once (n_cols
// floats: the unused features share its sectors) and n_used * W int32
// written once; at the section 5 chunk (65,536 rows of 14 float32, 7 used
// features x 28 bits) 3.7 MB in and 51.4 MB out, 16.4 us at 3.35 TB/s.
// Design for that: a block takes kRows rows; its threads first quantize
// each (row, used feature) once into shared memory, then write the
// block's bits as one contiguous run of int32, neighbouring threads on
// neighbouring words.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                       // rows a block
constexpr double kTwo63 = 9223372036854775808.0;      // 2^63

template <typename T>
__global__ void __launch_bounds__(kThreads)
feature_encode_kernel(const T* __restrict__ x, long long n_rows, int n_cols,
                      const int* __restrict__ used, int n_used, int width,
                      int frac_bits, int rnd, int sat,
                      int* __restrict__ bits) {
  extern __shared__ long long patterns[];       // kRows * n_used
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, n_rows - row0);
  const long long mask = (1LL << width) - 1;    // 2^W - 1
  const long long half = 1LL << (width - 1);    // 2^(W-1): the sign bit
  const double scale = ldexp(1.0, frac_bits);   // FixedSpec.scale, exact

  const int pairs = rows * n_used;
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int r = p / n_used, f = p - r * n_used;
    double s = __dmul_rn((double)x[(row0 + r) * n_cols + used[f]], scale);
    if (rnd) s = __dadd_rn(s, 0.5);
    s = floor(s);
    // numpy's x86_64 cast (the test is false for NaN)
    long long raw = (s >= -kTwo63 && s < kTwo63) ? (long long)s : LLONG_MIN;
    // AP_WRAP keeps the low W bits, which the mask takes below
    if (sat) raw = max(min(raw, half - 1), -half);
    patterns[p] = (raw & mask) ^ half;
  }
  __syncthreads();

  const int cols = n_used * width;
  int* out = bits + row0 * cols;
  const int n = rows * cols;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    const int f = c / width;
    out[i] = (int)((patterns[r * n_used + f] >> (c - f * width)) & 1);
  }
}

}  // namespace

extern "C" {

// x: (n_rows, n_cols) float32 (x_f64 == 0) or float64, contiguous;
// used: (n_used,) int32 column indices; the scale is 2^frac_bits; bits:
// (n_rows, n_used * width) int32. n_used * kRows * 8 bytes of
// shared memory: the caller keeps n_used <= 192. Launches on `stream`;
// returns cudaGetLastError.
int feature_encode_launch(const void* x, int x_f64, long long n_rows,
                          int n_cols, const void* used, int n_used,
                          int width, int frac_bits, int rnd, int sat,
                          void* bits, void* stream) {
  if (n_rows <= 0) return 0;
  const unsigned blocks = (unsigned)((n_rows + kRows - 1) / kRows);
  const size_t smem = (size_t)kRows * n_used * sizeof(long long);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_f64)
    feature_encode_kernel<double><<<blocks, kThreads, smem, s>>>(
        (const double*)x, n_rows, n_cols, (const int*)used, n_used, width,
        frac_bits, rnd, sat, (int*)bits);
  else
    feature_encode_kernel<float><<<blocks, kThreads, smem, s>>>(
        (const float*)x, n_rows, n_cols, (const int*)used, n_used, width,
        frac_bits, rnd, sat, (int*)bits);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
