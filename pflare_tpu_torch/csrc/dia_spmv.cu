// Multi-offset DIA SpMV for Hopper: y[i] = sum_k data[k, i] * x[i + off_k],
// with x read as 0 outside [0, n_cols).
//
// Replaces the two Pallas kernels of pflare_tpu/sparse/dia.py:
// _dia_fused_aligned (pallas_call at dia.py:311) and _dia_fused
// (dia.py:367).  One kernel covers both: the TPU needed two because its
// tiles are (8, 128)-shaped VMEM blocks, so every offset had to become a
// row shift plus a lane concatenation of whole blocks, and x either
// reshaped in place (aligned, when a tile width divides n) or was copied
// into a shifted, zero-padded buffer (padded).  A GPU thread reads any
// address, so here x is read where it lies.
//
// Bound: bytes.  A call reads the K data rows once, x once and writes y
// once, (K + 2) * n * sizeof(T) bytes for 2K FLOPs a row, far below the
// card's FLOP rate.  The design keeps enough bytes in flight to stream:
//
// - Each thread owns Chunk<T>::rows consecutive rows (4 in f32, 2 in
//   f64), so every data row is one 16-byte streaming load (__ldcs: read
//   once, it does not evict x) and y one 16-byte store.
// - The body is unrolled over the offsets for K = 1 .. kMaxUnrolled, so a
//   thread issues all its loads before its first FMA; larger K (up to
//   kMaxOffsets) run four slots at a time.
// - x goes through the read-only path (__ldg), one 16-byte load where
//   x + r0 + off_k is 16-byte aligned (r0 is a multiple of the rows a
//   thread owns, so that is a property of the offset, decided on the
//   host: 0 and -512 at 512^2 are, -1 is not), scalar loads otherwise.
//   Neighbouring offsets read the same lines, which L1 and L2 serve.
// - Masks only at the edges: a block whose rows all exist and whose x
//   range [b0 + off_min, b0 + B + off_max) lies inside [0, n_cols) runs
//   unmasked; the others mask each row and each x read.
// - 32-bit index arithmetic when every index fits, else a 64-bit
//   instantiation of the generic body.
//
// Any n_rows and any base: the vector instantiation needs data and y
// 16-byte aligned and n_rows a multiple of the rows a thread owns (so
// every data row k, which starts at k * n_rows, is aligned too);
// otherwise the launcher takes the scalar instantiation of the same
// design, which reads data and writes y one value at a time and masks
// the rows past n_rows.
//
// The sum runs over the offsets in their given (ascending) order, as
// dia_spmv_plain sums them; only FMA contraction differs from it.  Every
// slot reads x and does its FMA, zero or not: skipping zero slots made
// each x read wait for its data load and was no faster on any operator
// timed, the masked level-0 ones (50-64% zero slots) included
// (tools/torch_dia_variants.py times that variant, 128-thread blocks and
// four f64 rows a thread against this source).
// Offsets go by value in the parameter struct, so a launch captured in a
// CUDA graph keeps them.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOffsets = 16;
constexpr int kMaxUnrolled = 8;
constexpr int kThreads = 256;  // sparse/dia.py::BLOCK_THREADS

// 16 bytes of T, the unit of every vector load and store
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  using type = float4;
  static constexpr int n = 4;
  static constexpr int rows = 4;  // rows a thread owns
};
template <> struct Chunk<double> {
  using type = double2;
  static constexpr int n = 2;
  static constexpr int rows = 2;
};

__device__ __forceinline__ void unpack(const float4 c, float* v) {
  v[0] = c.x;
  v[1] = c.y;
  v[2] = c.z;
  v[3] = c.w;
}
__device__ __forceinline__ void unpack(const double2 c, double* v) {
  v[0] = c.x;
  v[1] = c.y;
}
__device__ __forceinline__ float4 pack(const float* v) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ double2 pack(const double* v) {
  return make_double2(v[0], v[1]);
}

// V values from a 16-byte aligned p: streaming (read once) or read-only
template <typename T, int V, bool kStream>
__device__ __forceinline__ void load_vec(const T* p, T* v) {
  static_assert(V % Chunk<T>::n == 0, "rows come in 16-byte chunks");
  using C = typename Chunk<T>::type;
  const C* q = reinterpret_cast<const C*>(p);
#pragma unroll
  for (int c = 0; c < V / Chunk<T>::n; ++c) {
    if constexpr (kStream) {
      unpack(__ldcs(q + c), v + c * Chunk<T>::n);
    } else {
      unpack(__ldg(q + c), v + c * Chunk<T>::n);
    }
  }
}

struct Params {
  long long off[kMaxOffsets];
  long long off_min, off_max;
  unsigned xvec;  // bit k: x + off_k is 16-byte aligned
  int k;
};

// Slots k0 .. k0 + KU - 1 of the rows r0 .. r0 + V - 1, added into acc in
// order.  kEdge masks rows past n_rows and x reads outside [0, n_cols).
template <typename T, int V, int KU, bool kVecData, bool kEdge, typename I>
__device__ __forceinline__ void slots(const T* __restrict__ data,
                                      const T* __restrict__ x, I n_rows,
                                      I n_cols, I r0, const Params& p,
                                      int k0, T* acc) {
  T d[KU][V];
  T xv[KU][V];
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    const T* row = data + (I)(k0 + u) * n_rows + r0;
    if (kVecData) {  // n_rows % V == 0: a thread's rows all exist
      load_vec<T, V, true>(row, d[u]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        d[u][v] = (!kEdge || r0 + v < n_rows) ? __ldcs(row + v) : T(0);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    const I j = r0 + (I)p.off[k0 + u];
    if (!kEdge && ((p.xvec >> (k0 + u)) & 1u)) {
      load_vec<T, V, false>(x + j, xv[u]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const I c = j + v;
        const bool read = !kEdge || (c >= 0 && c < n_cols);
        xv[u][v] = read ? __ldg(x + c) : T(0);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < KU; ++u) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += d[u][v] * xv[u][v];
  }
}

// All the offsets of one thread's rows: K slots unrolled, or (K == 0) the
// run-time count p.k four slots at a time.
template <typename T, int V, int K, bool kVecData, bool kEdge, typename I>
__device__ __forceinline__ void all_slots(const T* data, const T* x,
                                          I n_rows, I n_cols, I r0,
                                          const Params& p, T* acc) {
  if constexpr (K > 0) {
    slots<T, V, K, kVecData, kEdge>(data, x, n_rows, n_cols, r0, p, 0, acc);
  } else {
    int k0 = 0;
    for (; k0 + 4 <= p.k; k0 += 4) {
      slots<T, V, 4, kVecData, kEdge>(data, x, n_rows, n_cols, r0, p, k0,
                                      acc);
    }
    for (; k0 < p.k; ++k0) {
      slots<T, V, 1, kVecData, kEdge>(data, x, n_rows, n_cols, r0, p, k0,
                                      acc);
    }
  }
}

template <typename T, int K, bool kVecData, typename I>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, I n_rows, I n_cols, const Params p) {
  constexpr int V = Chunk<T>::rows;
  constexpr I kBlockRows = (I)kThreads * V;
  const I b0 = (I)blockIdx.x * kBlockRows;
  const I r0 = b0 + (I)threadIdx.x * V;
  if (r0 >= n_rows) return;
  // one test per block: do all its rows exist and all its x reads lie
  // inside [0, n_cols)?
  const bool edge = b0 + kBlockRows > n_rows || b0 + (I)p.off_min < 0 ||
                    b0 + kBlockRows + (I)p.off_max > n_cols;
  T acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = T(0);
  if (edge) {
    all_slots<T, V, K, kVecData, true>(data, x, n_rows, n_cols, r0, p, acc);
  } else {
    all_slots<T, V, K, kVecData, false>(data, x, n_rows, n_cols, r0, p, acc);
  }
  if (kVecData) {
    using C = typename Chunk<T>::type;
#pragma unroll
    for (int c = 0; c < V / Chunk<T>::n; ++c) {
      reinterpret_cast<C*>(y + r0)[c] = pack(acc + c * Chunk<T>::n);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (r0 + v < n_rows) y[r0 + v] = acc[v];
    }
  }
}

template <typename T, int K, bool kVecData, typename I>
void launch_k(unsigned blocks, cudaStream_t stream, const T* data,
              const T* x, T* y, long long n_rows, long long n_cols,
              const Params& p) {
  dia_spmv_kernel<T, K, kVecData, I><<<blocks, kThreads, 0, stream>>>(
      data, x, y, (I)n_rows, (I)n_cols, p);
}

template <typename T, bool kVecData>
void dispatch(bool idx32, unsigned blocks, cudaStream_t s, const T* data,
              const T* x, T* y, long long n_rows, long long n_cols,
              const Params& p) {
  if (!idx32) {
    launch_k<T, 0, kVecData, long long>(blocks, s, data, x, y, n_rows,
                                        n_cols, p);
    return;
  }
  static_assert(kMaxUnrolled == 8, "the switch unrolls K = 1 .. 8");
  switch (p.k) {
#define DIA_CASE(KK)                                                      \
  case KK:                                                                \
    launch_k<T, KK, kVecData, int>(blocks, s, data, x, y, n_rows, n_cols, \
                                   p);                                    \
    break;
    DIA_CASE(1)
    DIA_CASE(2)
    DIA_CASE(3)
    DIA_CASE(4)
    DIA_CASE(5)
    DIA_CASE(6)
    DIA_CASE(7)
    DIA_CASE(8)
#undef DIA_CASE
    default:
      launch_k<T, 0, kVecData, int>(blocks, s, data, x, y, n_rows, n_cols,
                                    p);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* data, const void* x, void* y, long long n_rows,
           long long n_cols, const void* offsets, int k, void* stream) {
  constexpr int V = Chunk<T>::rows;
  if (k < 1 || k > kMaxOffsets || n_rows < 0 || n_cols < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return (int)cudaSuccess;
  Params p = {};
  const long long* host_offsets = static_cast<const long long*>(offsets);
  p.k = k;
  p.off_min = p.off_max = host_offsets[0];
  long long off_abs = 0;
  for (int i = 0; i < k; ++i) {
    const long long o = host_offsets[i];
    p.off[i] = o;
    p.off_min = o < p.off_min ? o : p.off_min;
    p.off_max = o > p.off_max ? o : p.off_max;
    const long long a = o < 0 ? -o : o;
    off_abs = a > off_abs ? a : off_abs;
    // x + o, modulo 2^64: a negative o wraps, which keeps the alignment
    const std::uintptr_t xa = reinterpret_cast<std::uintptr_t>(x) +
                              (std::uintptr_t)o * sizeof(T);
    if (xa % 16 == 0) p.xvec |= 1u << i;
  }
  const long long block_rows = (long long)kThreads * V;
  // every index the kernel forms: k * n_rows + r0 + v, b0 + B + off,
  // r0 + off + v, n_cols
  const bool idx32 = (long long)k * n_rows + block_rows < INT_MAX &&
                     n_rows + block_rows + off_abs < INT_MAX &&
                     n_cols < INT_MAX;
  const bool vec = aligned16(data) && aligned16(y) && n_rows % V == 0;
  const unsigned blocks = (unsigned)((n_rows + block_rows - 1) / block_rows);
  const T* d = static_cast<const T*>(data);
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    dispatch<T, true>(idx32, blocks, s, d, xs, ys, n_rows, n_cols, p);
  } else {
    dispatch<T, false>(idx32, blocks, s, d, xs, ys, n_rows, n_cols, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// offsets: HOST pointer to k int64 offsets; data ([k, n_rows]), x
// ([n_cols]) and y ([n_rows]): device pointers, any alignment of T.
int dia_spmv_f32(const void* data, const void* x, void* y, long long n_rows,
                 long long n_cols, const void* offsets, int k,
                 void* stream) {
  return launch<float>(data, x, y, n_rows, n_cols, offsets, k, stream);
}

int dia_spmv_f64(const void* data, const void* x, void* y, long long n_rows,
                 long long n_cols, const void* offsets, int k,
                 void* stream) {
  return launch<double>(data, x, y, n_rows, n_cols, offsets, k, stream);
}

const char* dia_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
