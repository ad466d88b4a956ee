// Banded SpMV for Hopper: a gather of x straight from device memory.
//
// Replaces the Pallas kernel _banded_spmv of pflare_tpu/sparse/banded.py
// (pallas_call at banded.py:238, body _spmv_kernel).  Rows go in tiles of
// 128; slot k of row i holds data[k, i] and a column lcols[k, i] local to
// its tile's window, so that
//
//   y[i] = sum_k data[k, i] * x[c_k(i)],
//   c_k(i) = (row0 / W) * W - w + lcols[k, i],  row0 = i - i % 128,
//
// with x read as 0 outside [0, n_cols).  The TPU has no gather, so there
// each slot became a one-hot [W, 128] matrix product on the MXU, with x
// split into bf16 hi/lo parts.  A GPU gathers, so none of that carries
// over.  Nor does a window of x staged in shared memory: a tile's rows
// hold a few slots each, most of them pads on the masked full-space
// operators, so staging all 2W window entries of every tile would move
// 10-15x the product's bytes through L2 at 2048^2 (W ~ 4-6k) and cap the
// blocks an SM can hold.
//
// Here each thread owns four consecutive rows, which lie in one tile (4
// divides 128) and so share one window base.  For each slot k, in
// ascending order as banded_spmv_plain sums them, it reads the four rows'
// data and lcols with one 16-byte streaming load each (__ldcs: read once,
// so they do not evict x), forms the absolute columns in registers and
// reads x[c] through the read-only path (__ldg), masked to [0, n_cols):
// pad slots hold lcols 0, so the first tile's window and the last tile's
// reach past x.  Only FMA contraction differs from the plain version.  A
// slot whose data is 0 skips its read of x: that removes most of the
// random reads on the masked operators and, for finite x, changes no bit
// of the result; a pad slot then contributes 0 even where x is not
// finite, as scipy's product (which stores no pads) does.
//
// Bound: bytes, not FLOPs.  A call moves K * n_pad * (sizeof(T) + 4)
// bytes of operator, x once and y once, for 2 FLOPs a slot.  TMA and
// wgmma do not apply: this is a gather with no reuse of any tile, so
// there is nothing to stage and no matrix product.  The kernel uses no
// shared memory, so an SM holds its full 2,048 threads to hide the
// latency of the gathers; x (10.6 MB in f32 at the 2048^2 level 1) stays
// in the 50 MB L2 and neighbouring rows share its lines in L1.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;
constexpr int kRowsPerThread = 4;
constexpr int kThreads = 256;

// four consecutive values of one slot row, in 16-byte streaming loads
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_spmv_kernel(const T* __restrict__ data, const int* __restrict__ lcols,
                   const T* __restrict__ x, T* __restrict__ y, long long n,
                   long long n_pad, long long n_cols, int k_slots,
                   long long w, long long W) {
  const long long r0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kRowsPerThread;
  if (r0 >= n) return;
  // x index of window slot 0 for the tile that holds rows r0 .. r0 + 3
  const long long base = (r0 - r0 % kTileRows) / W * W - w;
  T acc[kRowsPerThread] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
  for (int k = 0; k < k_slots; ++k) {
    const long long p = (long long)k * n_pad + r0;
    T d[kRowsPerThread];
    load4(data + p, d);
    const int4 lc = __ldcs(reinterpret_cast<const int4*>(lcols + p));
    const int l[kRowsPerThread] = {lc.x, lc.y, lc.z, lc.w};
#pragma unroll
    for (int v = 0; v < kRowsPerThread; ++v) {
      const long long c = base + l[v];
      if (d[v] != T(0) && c >= 0 && c < n_cols) acc[v] += d[v] * __ldg(x + c);
    }
  }
  if (r0 + kRowsPerThread <= n) {
    store4(y + r0, acc);
  } else {
#pragma unroll
    for (int v = 0; v < kRowsPerThread; ++v) {
      if (r0 + v < n) y[r0 + v] = acc[v];
    }
  }
}

template <typename T>
int launch(const void* data, const void* lcols, const void* x, void* y,
           long long n, long long n_pad, long long n_cols, int k_slots,
           long long w, long long W, void* stream) {
  // rows r0 .. r0 + 3 of every slot are read as one 16-byte piece, and
  // y (allocated by the caller) is written so
  const bool aligned = reinterpret_cast<std::uintptr_t>(data) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(lcols) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
  if (k_slots < 1 || W < 1 || w < 0 || n < 0 || n_pad < n ||
      n_pad % kTileRows != 0 || !aligned) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const long long threads = (n + kRowsPerThread - 1) / kRowsPerThread;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  banded_spmv_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(lcols),
      static_cast<const T*>(x), static_cast<T*>(y), n, n_pad, n_cols,
      k_slots, w, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// data: [K, n_pad] values; lcols: [K, n_pad] int32 window-local columns;
// x: [n_cols]; y: [n].  All device pointers; data, lcols and y 16-byte
// aligned.
int banded_spmv_f32(const void* data, const void* lcols, const void* x,
                    void* y, long long n, long long n_pad, long long n_cols,
                    int k_slots, long long w, long long W, void* stream) {
  return launch<float>(data, lcols, x, y, n, n_pad, n_cols, k_slots, w, W,
                       stream);
}

int banded_spmv_f64(const void* data, const void* lcols, const void* x,
                    void* y, long long n, long long n_pad, long long n_cols,
                    int k_slots, long long w, long long W, void* stream) {
  return launch<double>(data, lcols, x, y, n, n_pad, n_cols, k_slots, w, W,
                        stream);
}

const char* banded_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
