// Gather SpMV for Hopper over sorted row slices (SELL-C-sigma, sigma = n):
// the product of both padded-ELL containers, TELL ([K, n]) and ELL
// ([n, K]), in one launch.
//
// Not a Pallas site.  It replaces XLA's fusions of the TELL slot loop,
// pflare_tpu/sparse/ell.py:217-223 (TELL.matvec: K gathers and FMAs), and
// of the ELL gather and row sum, pflare_tpu/sparse/ell.py:98-101
// (ELL.matvec, the coarse inverse's operator).  Both compute
//
//   y[i] = sum_k data[k, i] * x[cols[k, i]]
//
// over a layout padded to the widest row, which is 1.1-4.4 slots a
// nonzero on the main path: the level operators are full-space, so every
// F row of R and every C row of A_ff and A_fc is empty, and the other
// rows are short beside the widest.
//
// Bound: bytes, not FLOPs.  A product needs each nonzero's value and
// column once (sizeof(T) + 4 bytes), the x entries its columns name, and y
// (n entries), for 2 FLOPs a nonzero; nothing is reused within a block,
// so there is nothing to stage in shared memory and no matrix product for
// TMA or wgmma.  Reading the padded slots, as a one-thread-a-row kernel
// over [K, n] does, spends most of the bytes on zeros.
//
// What the layout does about that (sparse/ell.py::sell_index builds it
// once per pattern on the host; the containers keep a packed copy beside
// their own tensors).  The rows are sorted stably by length, longest
// first, and cut into slices of 32 / L rows, where L in {1, 2, 4, 8, 16,
// 32} is the number of lanes a row gets (chosen per operator from its
// mean row length: short rows take one lane, the coarse inverse's long
// rows several, so that its few thousand rows still make enough warps).
// A slice is padded only to its own longest row, rounded up to a
// multiple of L: within 0.3% of the nonzeros on the main path.  Empty
// rows come last, in slices of width 0, so one launch writes all of y.
// Each slice is stored step-major: step t holds slots t*L .. t*L + L - 1
// of its rows as 32 consecutive values, lane l of row r at l * (32 / L)
// + r.  So
//
// * one warp owns one slice, and at every step its 32 threads read 32
//   neighbouring values and columns: one 128-byte line of each (two for
//   f64 values), by streaming loads (__ldcs: read once, so they do not
//   evict x), and x[col] through the read-only path (__ldg);
// * thread l * (32 / L) + r sums its slots of row r in slot order, with
//   the product and the sum rounded apart (__fmul_rn/__fadd_rn,
//   __dmul_rn/__dadd_rn: nvcc would otherwise contract them into an FMA);
// * the L lanes of a row then combine by a fixed __shfl_down_sync tree
//   (offsets 16, 8, ... down to 32 / L), and the slice's first 32 / L
//   threads write y[row_of[r]].
//
// An epilogue (a template parameter; one launch either way) does the
// vector work that the V-cycle (air/smooth.py) puts around a product, on
// the row's sum acc as it is written:
//
//   plain        y[row] = acc
//   residual     y[row] = u[row] - acc              t - A_ff x
//   masked       y[row] = m[row] * u[row] - acc     mask_f * b - A_fc x
//   correction   y[row] = u[row] + acc              x + inv(A_ff) r
//
// each multiply and add rounded on its own, in PyTorch's order, so a
// fused launch gives the bits of the product followed by PyTorch's
// elementwise op, and reads u and m where that op would have read them
// again.  The coarse maps of R and P need no code here: R's mapped copy
// names output rows by their position in the coarse list (row_of), and
// P's names columns by theirs (cols), so R writes, and P reads, the
// coarse vector itself (air/fullspace.py::coarse_maps).
//
// No shared memory, so an SM holds its full 2,048 threads to hide the
// gathers.  The order of every sum is fixed, so every call gives the same
// bits: a CUDA graph's replay equals the eager run, and the plain version
// (sell_spmv_plain in sparse/ell.py, which walks the same order) equals the
// kernel bit for bit.  Pad slots hold value 0 and column 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // eight slices a block
constexpr int kWarp = 32;

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
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// sparse/ell.py::EPILOGUES numbers them alike
enum Epilogue { kPlain = 0, kResidual = 1, kMasked = 2, kCorrection = 3 };

template <typename T, int kLanes, int kEpilogue>
__global__ void __launch_bounds__(kThreads)
sell_spmv_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                 const long long* __restrict__ slice_ptr,
                 const int* __restrict__ row_of, const T* __restrict__ x,
                 T* __restrict__ y, const T* __restrict__ u,
                 const T* __restrict__ m, long long n_slices) {
  constexpr int kRows = kWarp / kLanes;
  const long long slice =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / kWarp;
  if (slice >= n_slices) return;   // the whole warp: one slice a warp
  const int lane = threadIdx.x % kWarp;
  const long long end = __ldg(slice_ptr + slice + 1);
  T acc = T(0);
#pragma unroll 4
  for (long long p = __ldg(slice_ptr + slice) + lane; p < end; p += kWarp)
    acc = add_rn(acc, mul_rn(__ldcs(data + p), __ldg(x + __ldcs(cols + p))));
#pragma unroll
  for (int off = kWarp / 2; off >= kRows; off /= 2)
    acc = add_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if (lane < kRows) {
    const int row = __ldg(row_of + slice * kRows + lane);
    if (row >= 0) {
      if constexpr (kEpilogue == kResidual)
        acc = sub_rn(__ldg(u + row), acc);
      else if constexpr (kEpilogue == kMasked)
        acc = sub_rn(mul_rn(__ldg(m + row), __ldg(u + row)), acc);
      else if constexpr (kEpilogue == kCorrection)
        acc = add_rn(__ldg(u + row), acc);
      y[row] = acc;
    }
  }
}

struct Args {
  const void* data;
  const void* cols;
  const void* slice_ptr;
  const void* row_of;
  const void* x;
  void* y;
  const void* u;
  const void* m;
  long long n_slices;
};

template <typename T, int kLanes, int kEpilogue>
void go(unsigned blocks, cudaStream_t stream, const Args& a) {
  sell_spmv_kernel<T, kLanes, kEpilogue><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a.data), static_cast<const int*>(a.cols),
      static_cast<const long long*>(a.slice_ptr),
      static_cast<const int*>(a.row_of), static_cast<const T*>(a.x),
      static_cast<T*>(a.y), static_cast<const T*>(a.u),
      static_cast<const T*>(a.m), a.n_slices);
}

template <typename T, int kLanes>
bool go_epilogue(int epilogue, unsigned blocks, cudaStream_t stream,
                 const Args& a) {
  switch (epilogue) {
    case kPlain: go<T, kLanes, kPlain>(blocks, stream, a); return true;
    case kResidual: go<T, kLanes, kResidual>(blocks, stream, a); return true;
    case kMasked: go<T, kLanes, kMasked>(blocks, stream, a); return true;
    case kCorrection:
      go<T, kLanes, kCorrection>(blocks, stream, a);
      return true;
    default: return false;
  }
}

template <typename T>
int launch(const Args& a, int lanes, int epilogue, void* stream) {
  if (a.n_slices < 0) return (int)cudaErrorInvalidValue;
  if (epilogue != kPlain && a.u == nullptr) return (int)cudaErrorInvalidValue;
  if (epilogue == kMasked && a.m == nullptr) return (int)cudaErrorInvalidValue;
  if (a.n_slices == 0) return (int)cudaSuccess;
  const long long blocks = (a.n_slices * kWarp + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = (unsigned)blocks;
  bool ok;
  switch (lanes) {
    case 1: ok = go_epilogue<T, 1>(epilogue, b, s, a); break;
    case 2: ok = go_epilogue<T, 2>(epilogue, b, s, a); break;
    case 4: ok = go_epilogue<T, 4>(epilogue, b, s, a); break;
    case 8: ok = go_epilogue<T, 8>(epilogue, b, s, a); break;
    case 16: ok = go_epilogue<T, 16>(epilogue, b, s, a); break;
    case 32: ok = go_epilogue<T, 32>(epilogue, b, s, a); break;
    default: ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// data: [P] packed values; cols: [P] int32 columns of x; slice_ptr:
// [n_slices + 1] int64 offsets of the slices in data and cols (multiples
// of 32); row_of: [n_slices * 32 / lanes] int32 rows of y, -1 for none;
// x: [n_cols]; y: [n] (every row of y appears once in row_of); u, m: [n],
// the epilogue's vectors (null where it reads none; epilogue: 0 plain,
// 1 residual, 2 masked, 3 correction).  All device pointers, every column
// inside [0, n_cols).
int sell_spmv_f32(const void* data, const void* cols, const void* slice_ptr,
                  const void* row_of, const void* x, void* y, const void* u,
                  const void* m, long long n_slices, int lanes, int epilogue,
                  void* stream) {
  return launch<float>({data, cols, slice_ptr, row_of, x, y, u, m, n_slices},
                       lanes, epilogue, stream);
}

int sell_spmv_f64(const void* data, const void* cols, const void* slice_ptr,
                  const void* row_of, const void* x, void* y, const void* u,
                  const void* m, long long n_slices, int lanes, int epilogue,
                  void* stream) {
  return launch<double>({data, cols, slice_ptr, row_of, x, y, u, m, n_slices},
                        lanes, epilogue, stream);
}

const char* sell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
