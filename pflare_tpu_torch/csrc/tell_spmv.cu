// TELL SpMV for Hopper: the gather product of the [K, n] padded ELL
// layout in one launch.
//
// Not a Pallas site.  It replaces XLA's fusion of the slot loop of
// pflare_tpu/sparse/ell.py:217-223 (TELL.matvec), which the reference's
// jitted solve program fuses into one loop; eager PyTorch ran that loop as
// one gather, one multiply and one add a slot, 3K launches that read and
// wrote about three full vectors more a slot than the product needs.
// Slot k of every row is one contiguous row of data and cols, so
//
//   y[i] = sum_{k < K} data[k, i] * x[cols[k, i]]
//
// with pad slots holding value 0 and column 0.
//
// One thread owns one row.  For each slot k, in ascending order, it reads
// data[k, i] and cols[k, i], which neighbouring threads read from
// neighbouring addresses (the layout's point: each slot row is one
// coalesced stream), with streaming loads (__ldcs: read once, so they do
// not evict x), and x[cols[k, i]] through the read-only path (__ldg).  The
// sum runs in slot order with the product and the sum rounded apart
// (__fmul_rn/__fadd_rn, __dmul_rn/__dadd_rn): nvcc would otherwise
// contract them into an FMA, and the plain version (tell_spmv_plain in
// sparse/ell.py, K separate multiplies and adds) would then differ in the
// last bit.  So the kernel gives the plain version's bits, pads included:
// a pad slot multiplies 0 by x[0], as the plain version does.
//
// Bound: bytes, not FLOPs.  A call moves K * n * (sizeof(T) + 4) bytes of
// operator, reads x (n_cols entries) and writes y (n entries), for 2
// FLOPs a slot.  Nothing is reused within a block, so there is nothing to
// stage in shared memory and no matrix product for TMA or wgmma.  The
// kernel uses no shared memory, so an SM holds its full 2,048 threads to
// hide the latency of the gathers; the loop is unrolled so that a thread
// has several slots' loads in flight before their sums.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tell_spmv_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                 const T* __restrict__ x, T* __restrict__ y, long long n,
                 int k_slots) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // slot 0 starts the sum, as the plain version's first term does
  T acc = mul_rn(__ldcs(data + i), __ldg(x + __ldcs(cols + i)));
#pragma unroll 4
  for (int k = 1; k < k_slots; ++k) {
    const long long p = (long long)k * n + i;
    acc = add_rn(acc, mul_rn(__ldcs(data + p), __ldg(x + __ldcs(cols + p))));
  }
  y[i] = acc;
}

template <typename T>
int launch(const void* data, const void* cols, const void* x, void* y,
           long long n, int k_slots, void* stream) {
  if (k_slots < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  tell_spmv_kernel<T><<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(cols),
      static_cast<const T*>(x), static_cast<T*>(y), n, k_slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// data: [K, n] values; cols: [K, n] int32 columns of x; x: [n_cols];
// y: [n].  All device pointers, every column inside [0, n_cols).
int tell_spmv_f32(const void* data, const void* cols, const void* x,
                  void* y, long long n, int k_slots, void* stream) {
  return launch<float>(data, cols, x, y, n, k_slots, stream);
}

int tell_spmv_f64(const void* data, const void* cols, const void* x,
                  void* y, long long n, int k_slots, void* stream) {
  return launch<double>(data, cols, x, y, n, k_slots, stream);
}

const char* tell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
