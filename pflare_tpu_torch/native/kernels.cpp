// Native host kernels for the setup phase.
//
// The reference implements its numerical setup in Fortran with Kokkos C++
// device siblings (reference: src/*.F90 + src/*k.kokkos.cxx).  In this
// package the device compute path is PyTorch and the kernels of csrc/; the
// host setup runtime gets these C++ kernels for the tight loops that don't
// vectorise well in numpy: the Luby independent-set rounds, SpGEMM
// product-triple enumeration, and one-pass drop/lump.  This file is the
// port's own copy of the JAX package's host kernels: the two packages
// build the same functions from separate sources.
//
// Plain C ABI over raw pointers, loaded with ctypes (no pybind11 in this
// image).  Index arrays are int64 or int32 (scipy's default), values
// double or float: the value-streaming kernels are templated on the value
// type T so a single-precision setup (PCAIR(dtype=float32), the
// reference's single build, reference: tests/Makefile:34-48) streams half
// the bytes -- these kernels are memory-bound.  Accumulation stays double.

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ~~~~~~~~~~~~~~~~~~ Luby PMISR ~~~~~~~~~~~~~~~~~~
// One full PMISR Luby iteration set over a symmetric graph in CSR form
// (reference algorithm: src/PMISR_Module.F90:271-670).  cf: 0 undecided,
// -1 F (independent set), +1 C.  assigned: 0/1.  Runs until all assigned
// or max_steps rounds (max_steps <= 0 means unbounded).  Returns rounds.
// Templated on the index type (scipy hands int32 CSR; per-call int64
// conversion costs more than the rounds themselves on fine levels).
}  // extern "C"

template <typename I>
static int pmisr_luby_t(const I* indptr, const I* indices, int64_t n,
               const double* measure, int64_t* cf, uint8_t* assigned,
               int max_steps) {
    std::vector<uint8_t> in_set(n);
    int rounds = 0;
    while (true) {
        if (max_steps > 0 && rounds >= max_steps) break;
        int64_t undecided = 0;
        for (int64_t i = 0; i < n; ++i)
            if (!assigned[i]) ++undecided;
        if (undecided == 0) break;

        // candidates: unassigned nodes not beaten by any unassigned
        // neighbour (smaller measure wins; ties: smaller index wins)
        for (int64_t i = 0; i < n; ++i) {
            if (assigned[i]) { in_set[i] = 0; continue; }
            uint8_t win = 1;
            const double mi = measure[i];
            for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                const int64_t j = (int64_t)indices[p];
                if (assigned[j]) continue;
                const double mj = measure[j];
                if (mi > mj || (mi == mj && i > j)) { win = 0; break; }
            }
            in_set[i] = win;
        }
        // commit: new set members become F; they and their neighbours
        // are assigned (neighbours -> C at the end)
        for (int64_t i = 0; i < n; ++i) {
            if (!in_set[i]) continue;
            cf[i] = -1;
            assigned[i] = 1;
        }
        for (int64_t i = 0; i < n; ++i) {
            if (!in_set[i]) continue;
            for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
                assigned[indices[p]] = 1;
        }
        ++rounds;
    }
    for (int64_t i = 0; i < n; ++i)
        if (cf[i] == 0) cf[i] = 1;  // leftovers become C
    return rounds;
}


extern "C" {

int pmisr_luby(const int64_t* indptr, const int64_t* indices, int64_t n,
               const double* measure, int64_t* cf, uint8_t* assigned,
               int max_steps) {
    return pmisr_luby_t<int64_t>(indptr, indices, n, measure, cf,
                                 assigned, max_steps);
}

int pmisr_luby_i32(const int32_t* indptr, const int32_t* indices,
                   int64_t n, const double* measure, int64_t* cf,
                   uint8_t* assigned, int max_steps) {
    return pmisr_luby_t<int32_t>(indptr, indices, n, measure, cf,
                                 assigned, max_steps);
}

}  // extern "C"

// ~~~~~~~~~~~~~~~~ SpGEMM plan enumeration ~~~~~~~~~~~~~~~~
// Count and fill the product triples (i,k)(k,j) of C = A@B restricted to
// C's pattern (the symbolic half of the fixed-sparsity product plans,
// reference counterpart: PETSc MatMatMult symbolic).
template <typename I>
static int64_t plan_count_t(const I* a_indptr, const I* a_indices,
                            const I* b_indptr, int64_t n_rows) {
    int64_t total = 0;
    for (int64_t i = 0; i < n_rows; ++i)
        for (I p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
            const I k = a_indices[p];
            total += b_indptr[k + 1] - b_indptr[k];
        }
    return total;
}

// Fill a_pos/b_pos/c_pos with CSR entry positions; triples whose (i,j)
// is absent from C are skipped.  Returns the number of kept triples.
// Row-stamped O(1) membership lookup (dense coarse levels enumerate
// hundreds of millions of triples; the per-triple binary search this
// replaces dominated amount-3 plan construction).  Triples come out
// row-major in C (grouped by c row), positions as int64.
template <typename I>
static int64_t plan_fill_t(const I* a_indptr, const I* a_indices,
                           const I* b_indptr, const I* b_indices,
                           const I* c_indptr, const I* c_indices,
                           int64_t n_rows, int64_t n_cols,
                           int64_t* a_pos, int64_t* b_pos, int64_t* c_pos) {
    std::vector<int64_t> stamp(n_cols, -1);
    std::vector<int64_t> cpos(n_cols, 0);
    int64_t out = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        for (I c = c_indptr[i]; c < c_indptr[i + 1]; ++c) {
            stamp[c_indices[c]] = i;
            cpos[c_indices[c]] = c;
        }
        for (I p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
            const I k = a_indices[p];
            for (I q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
                const I j = b_indices[q];
                if (stamp[j] == i) {
                    a_pos[out] = p;
                    b_pos[out] = q;
                    c_pos[out] = cpos[j];
                    ++out;
                }
            }
        }
    }
    return out;
}

extern "C" {

int64_t plan_count(const int64_t* a_indptr, const int64_t* a_indices,
                   const int64_t* b_indptr, int64_t n_rows) {
    return plan_count_t(a_indptr, a_indices, b_indptr, n_rows);
}

int64_t plan_count_i32(const int32_t* a_indptr, const int32_t* a_indices,
                       const int32_t* b_indptr, int64_t n_rows) {
    return plan_count_t(a_indptr, a_indices, b_indptr, n_rows);
}

int64_t plan_fill(const int64_t* a_indptr, const int64_t* a_indices,
                  const int64_t* b_indptr, const int64_t* b_indices,
                  const int64_t* c_indptr, const int64_t* c_indices,
                  int64_t n_rows, int64_t n_cols,
                  int64_t* a_pos, int64_t* b_pos, int64_t* c_pos) {
    return plan_fill_t(a_indptr, a_indices, b_indptr, b_indices, c_indptr,
                       c_indices, n_rows, n_cols, a_pos, b_pos, c_pos);
}

int64_t plan_fill_i32(const int32_t* a_indptr, const int32_t* a_indices,
                      const int32_t* b_indptr, const int32_t* b_indices,
                      const int32_t* c_indptr, const int32_t* c_indices,
                      int64_t n_rows, int64_t n_cols,
                      int64_t* a_pos, int64_t* b_pos, int64_t* c_pos) {
    return plan_fill_t(a_indptr, a_indices, b_indptr, b_indices, c_indptr,
                       c_indices, n_rows, n_cols, a_pos, b_pos, c_pos);
}

// ~~~~~~~~~~~~~~~~ one-pass drop/lump ~~~~~~~~~~~~~~~~
// Drop |a_ij| < row_tol[i], never/always/allow dropping the diagonal,
// optionally lumping dropped values onto the diagonal (reference:
// src/PETSc_Helper.F90:207-412).  Writes a keep mask and the lump vector.
void drop_small(const int64_t* indptr, const int64_t* indices,
                const double* data, const double* row_tol, int64_t n_rows,
                int drop_diag_mode /*0 never,1 allow,-1 always*/,
                int lump, uint8_t* keep, double* lump_vec) {
    for (int64_t i = 0; i < n_rows; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int64_t j = indices[p];
            const double v = data[p];
            const bool is_diag = (j == i);
            bool k = std::fabs(v) >= row_tol[i];
            if (drop_diag_mode == -1 && is_diag) k = false;
            else if (drop_diag_mode == 0 && is_diag) k = k || true;
            if (v == 0.0) k = false;  // MAT_IGNORE_ZERO_ENTRIES
            keep[p] = k ? 1 : 0;
            if (!k && lump && v != 0.0) lump_vec[i] += v;
        }
    }
}

}  // extern "C"

// ~~~~~~~~~~~~~~~~ diagonal-dominance ratio ~~~~~~~~~~~~~~~~
// ratio[i] = sum_{j in F, j != i} |a_ij| / |a_ii| for F rows, else 0
// (reference: src/MatDiagDom.F90:98).  Templated on the index type: scipy
// hands int32 CSR indices, and converting them to int64 per call costs
// more than the kernel itself on large levels.
template <typename I, typename T>
static void dd_ratio_t(const I* indptr, const I* indices,
                       const T* data, const uint8_t* f_mask,
                       int64_t n_rows, double* ratio) {
    for (int64_t i = 0; i < n_rows; ++i) {
        ratio[i] = 0.0;
        if (!f_mask[i]) continue;
        double offsum = 0.0, diag = 0.0;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int64_t j = (int64_t)indices[p];
            if (!f_mask[j]) continue;
            if (j == i) diag = std::fabs((double)data[p]);
            else offsum += std::fabs((double)data[p]);
        }
        if (diag > 0.0) ratio[i] = offsum / diag;
        else if (offsum > 0.0) ratio[i] = INFINITY;
    }
}

extern "C" {

void dd_ratio(const int64_t* indptr, const int64_t* indices,
              const double* data, const uint8_t* f_mask, int64_t n_rows,
              double* ratio) {
    dd_ratio_t(indptr, indices, data, f_mask, n_rows, ratio);
}

void dd_ratio_i32(const int32_t* indptr, const int32_t* indices,
                  const double* data, const uint8_t* f_mask,
                  int64_t n_rows, double* ratio) {
    dd_ratio_t(indptr, indices, data, f_mask, n_rows, ratio);
}

void dd_ratio_f32(const int64_t* indptr, const int64_t* indices,
                  const float* data, const uint8_t* f_mask, int64_t n_rows,
                  double* ratio) {
    dd_ratio_t(indptr, indices, data, f_mask, n_rows, ratio);
}

void dd_ratio_i32f32(const int32_t* indptr, const int32_t* indices,
                     const float* data, const uint8_t* f_mask,
                     int64_t n_rows, double* ratio) {
    dd_ratio_t(indptr, indices, data, f_mask, n_rows, ratio);
}

}  // extern "C"

extern "C" {

// ~~~~~~~~~~~~~~~~ CSR SpGEMM (host setup path) ~~~~~~~~~~~~~~~~
// Row-wise sparse product with a stamped dense accumulator -- the host
// analogue of PETSc's MatMatMult, used for the RAP triple products which
// dominate first-time setup.  Symbolic pass fills c_indptr; numeric pass
// fills sorted (c_indices, c_data).

void spgemm_count(const int64_t* a_indptr, const int64_t* a_indices,
                  const int64_t* b_indptr, const int64_t* b_indices,
                  int64_t n_rows, int64_t n_cols, int64_t* c_indptr) {
    std::vector<int64_t> marker(n_cols, -1);
    c_indptr[0] = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t count = 0;
        for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
            const int64_t k = a_indices[p];
            for (int64_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
                const int64_t j = b_indices[q];
                if (marker[j] != i) { marker[j] = i; ++count; }
            }
        }
        c_indptr[i + 1] = c_indptr[i] + count;
    }
}

void spgemm_fill(const int64_t* a_indptr, const int64_t* a_indices,
                 const double* a_data,
                 const int64_t* b_indptr, const int64_t* b_indices,
                 const double* b_data,
                 int64_t n_rows, int64_t n_cols,
                 const int64_t* c_indptr, int64_t* c_indices,
                 double* c_data) {
    std::vector<int64_t> marker(n_cols, -1);
    std::vector<double> acc(n_cols, 0.0);
    std::vector<int64_t> cols;
    cols.reserve(256);
    for (int64_t i = 0; i < n_rows; ++i) {
        cols.clear();
        for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
            const int64_t k = a_indices[p];
            const double av = a_data[p];
            for (int64_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
                const int64_t j = b_indices[q];
                if (marker[j] != i) {
                    marker[j] = i;
                    acc[j] = av * b_data[q];
                    cols.push_back(j);
                } else {
                    acc[j] += av * b_data[q];
                }
            }
        }
        std::sort(cols.begin(), cols.end());
        int64_t out = c_indptr[i];
        for (const int64_t j : cols) {
            c_indices[out] = j;
            c_data[out] = acc[j];
            ++out;
        }
    }
}

}  // extern "C"

// ~~~~~~~~~~~~~~~~ SpGEMM restricted onto a stored pattern ~~~~~~~~~~~~~~
// C|_P = (A @ B) restricted onto pattern P, optionally lumping the
// product mass OUTSIDE the pattern onto P's diagonal -- the numeric-only
// re-setup product (the reference's MAT_REUSE_MATRIX MatMatMult +
// remove_small lump, src/AIR_Operators_Setup.F90:1038-1082) WITHOUT
// materialising the undropped product (whose allocation dominated
// re-setup wall time).  Gustavson accumulator; out_data written in P's
// CSR entry order.  Templated on the index type (scipy int32 default).
template <typename I, typename T>
static void spgemm_onto_pattern_t(
    const I* a_indptr, const I* a_indices, const T* a_data,
    const I* b_indptr, const I* b_indices, const T* b_data,
    const I* p_indptr, const I* p_indices,
    int64_t n_rows, int64_t n_cols, int lump, T* out_data) {
    std::vector<int64_t> marker(n_cols, -1);
    std::vector<double> acc(n_cols, 0.0);
    for (int64_t i = 0; i < n_rows; ++i) {
        double total = 0.0;
        for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
            const int64_t k = (int64_t)a_indices[p];
            const double av = a_data[p];
            for (int64_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
                const int64_t j = (int64_t)b_indices[q];
                const double v = av * b_data[q];
                if (marker[j] != i) {
                    marker[j] = i;
                    acc[j] = v;
                } else {
                    acc[j] += v;
                }
                total += v;
            }
        }
        double kept = 0.0;
        int64_t diag_pos = -1;
        for (int64_t t = p_indptr[i]; t < p_indptr[i + 1]; ++t) {
            const int64_t j = (int64_t)p_indices[t];
            const double v = (marker[j] == i) ? acc[j] : 0.0;
            out_data[t] = (T)v;
            kept += v;
            if (j == i) diag_pos = t;
        }
        if (lump && diag_pos >= 0)
            out_data[diag_pos] = (T)((double)out_data[diag_pos]
                                     + (total - kept));
    }
}

extern "C" {

void spgemm_onto_pattern(
    const int64_t* a_indptr, const int64_t* a_indices, const double* a_data,
    const int64_t* b_indptr, const int64_t* b_indices, const double* b_data,
    const int64_t* p_indptr, const int64_t* p_indices,
    int64_t n_rows, int64_t n_cols, int lump, double* out_data) {
    spgemm_onto_pattern_t(a_indptr, a_indices, a_data, b_indptr,
                          b_indices, b_data, p_indptr, p_indices,
                          n_rows, n_cols, lump, out_data);
}

void spgemm_onto_pattern_i32(
    const int32_t* a_indptr, const int32_t* a_indices, const double* a_data,
    const int32_t* b_indptr, const int32_t* b_indices, const double* b_data,
    const int32_t* p_indptr, const int32_t* p_indices,
    int64_t n_rows, int64_t n_cols, int lump, double* out_data) {
    spgemm_onto_pattern_t(a_indptr, a_indices, a_data, b_indptr,
                          b_indices, b_data, p_indptr, p_indices,
                          n_rows, n_cols, lump, out_data);
}

void spgemm_onto_pattern_f32(
    const int64_t* a_indptr, const int64_t* a_indices, const float* a_data,
    const int64_t* b_indptr, const int64_t* b_indices, const float* b_data,
    const int64_t* p_indptr, const int64_t* p_indices,
    int64_t n_rows, int64_t n_cols, int lump, float* out_data) {
    spgemm_onto_pattern_t(a_indptr, a_indices, a_data, b_indptr,
                          b_indices, b_data, p_indptr, p_indices,
                          n_rows, n_cols, lump, out_data);
}

void spgemm_onto_pattern_i32f32(
    const int32_t* a_indptr, const int32_t* a_indices, const float* a_data,
    const int32_t* b_indptr, const int32_t* b_indices, const float* b_data,
    const int32_t* p_indptr, const int32_t* p_indices,
    int64_t n_rows, int64_t n_cols, int lump, float* out_data) {
    spgemm_onto_pattern_t(a_indptr, a_indices, a_data, b_indptr,
                          b_indices, b_data, p_indptr, p_indices,
                          n_rows, n_cols, lump, out_data);
}

}  // extern "C"

// ~~~~~~~~~~~~~~~~ one-pass drop + compact + lump ~~~~~~~~~~~~~~~~
// Threshold-and-compact in CSR order (reference: src/PETSc_Helper.F90:
// 207-412) without materialising any nnz-sized temporaries on the Python
// side.  Two passes (count, then fill) so the output arrays are allocated
// exactly once at their final size -- page-touch economy matters more than
// the extra read pass on this host.
//   rel_mode: 0 = absolute tol, 1 = relative to max|row| incl. diagonal,
//             -1 = relative excluding the diagonal.
//   diag_strength: tol measured against |a_ii| (active when rel_mode != 0).
//   drop_diag_mode: 0 never drop the diagonal, 1 allow, -1 always drop.
//   lump: dropped values accumulate onto the kept diagonal entry.

// Templated over the CSR index type so scipy's int32 matrices avoid a
// full int64 conversion copy on every call.

template <typename I, typename T>
static double row_drop_tol(const I* indptr, const I* indices,
                           const T* data, int64_t i, double tol,
                           int rel_mode, int diag_strength) {
    if (rel_mode == 0) return tol;
    double m = 0.0;
    if (diag_strength) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
            if (indices[p] == (I)i) { m = std::fabs((double)data[p]); break; }
    } else {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            if (rel_mode == -1 && indices[p] == (I)i) continue;
            m = std::max(m, std::fabs((double)data[p]));
        }
    }
    return tol * m;
}

static inline bool keep_entry(int64_t i, int64_t j, double v, double row_tol,
                              int drop_diag_mode) {
    bool k = std::fabs(v) >= row_tol;
    if (j == i) {
        if (drop_diag_mode == -1) k = false;
        else if (drop_diag_mode == 0) k = true;
    }
    if (v == 0.0) k = false;  // MAT_IGNORE_ZERO_ENTRIES
    return k;
}

// Counts kept entries per row into out_indptr (cumulative).  Returns the
// output nnz, or -1 when lumping needs a diagonal a row doesn't keep
// (caller falls back to the COO insertion path).
template <typename I, typename T>
static int64_t drop_count_t(const I* indptr, const I* indices,
                            const T* data, int64_t n_rows, double tol,
                            int rel_mode, int diag_strength,
                            int drop_diag_mode, int lump, I* out_indptr) {
    int64_t out = 0;
    out_indptr[0] = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        const double rt =
            row_drop_tol(indptr, indices, data, i, tol, rel_mode, diag_strength);
        bool diag_kept = false, dropped_any = false;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            if (keep_entry(i, indices[p], data[p], rt, drop_diag_mode)) {
                if (indices[p] == (I)i) diag_kept = true;
                ++out;
            } else if (data[p] != 0.0) {
                dropped_any = true;
            }
        }
        if (lump && dropped_any && !diag_kept) return -1;
        out_indptr[i + 1] = (I)out;
    }
    return out;
}

template <typename I, typename T>
static void drop_fill_t(const I* indptr, const I* indices,
                        const T* data, int64_t n_rows, double tol,
                        int rel_mode, int diag_strength, int drop_diag_mode,
                        int lump, I* out_cols, T* out_data) {
    int64_t out = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        const double rt =
            row_drop_tol(indptr, indices, data, i, tol, rel_mode, diag_strength);
        int64_t diag_out = -1;
        double lump_acc = 0.0;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int64_t j = indices[p];
            const double v = (double)data[p];
            if (keep_entry(i, j, v, rt, drop_diag_mode)) {
                if (j == i) diag_out = out;
                out_cols[out] = (I)j;
                out_data[out] = data[p];
                ++out;
            } else if (lump && v != 0.0) {
                lump_acc += v;
            }
        }
        if (lump && lump_acc != 0.0 && diag_out >= 0)
            out_data[diag_out] = (T)((double)out_data[diag_out] + lump_acc);
    }
}

extern "C" {

int64_t drop_small_count(const int64_t* indptr, const int64_t* indices,
                         const double* data, int64_t n_rows, double tol,
                         int rel_mode, int diag_strength, int drop_diag_mode,
                         int lump, int64_t* out_indptr) {
    return drop_count_t(indptr, indices, data, n_rows, tol, rel_mode,
                        diag_strength, drop_diag_mode, lump, out_indptr);
}

void drop_small_fill(const int64_t* indptr, const int64_t* indices,
                     const double* data, int64_t n_rows, double tol,
                     int rel_mode, int diag_strength, int drop_diag_mode,
                     int lump, int64_t* out_cols, double* out_data) {
    drop_fill_t(indptr, indices, data, n_rows, tol, rel_mode, diag_strength,
                drop_diag_mode, lump, out_cols, out_data);
}

int64_t drop_small_count_i32(const int32_t* indptr, const int32_t* indices,
                             const double* data, int64_t n_rows, double tol,
                             int rel_mode, int diag_strength,
                             int drop_diag_mode, int lump,
                             int32_t* out_indptr) {
    return drop_count_t(indptr, indices, data, n_rows, tol, rel_mode,
                        diag_strength, drop_diag_mode, lump, out_indptr);
}

void drop_small_fill_i32(const int32_t* indptr, const int32_t* indices,
                         const double* data, int64_t n_rows, double tol,
                         int rel_mode, int diag_strength, int drop_diag_mode,
                         int lump, int32_t* out_cols, double* out_data) {
    drop_fill_t(indptr, indices, data, n_rows, tol, rel_mode, diag_strength,
                drop_diag_mode, lump, out_cols, out_data);
}

int64_t drop_small_count_f32(const int64_t* indptr, const int64_t* indices,
                             const float* data, int64_t n_rows, double tol,
                             int rel_mode, int diag_strength,
                             int drop_diag_mode, int lump,
                             int64_t* out_indptr) {
    return drop_count_t(indptr, indices, data, n_rows, tol, rel_mode,
                        diag_strength, drop_diag_mode, lump, out_indptr);
}

void drop_small_fill_f32(const int64_t* indptr, const int64_t* indices,
                         const float* data, int64_t n_rows, double tol,
                         int rel_mode, int diag_strength, int drop_diag_mode,
                         int lump, int64_t* out_cols, float* out_data) {
    drop_fill_t(indptr, indices, data, n_rows, tol, rel_mode, diag_strength,
                drop_diag_mode, lump, out_cols, out_data);
}

int64_t drop_small_count_i32f32(const int32_t* indptr,
                                const int32_t* indices, const float* data,
                                int64_t n_rows, double tol, int rel_mode,
                                int diag_strength, int drop_diag_mode,
                                int lump, int32_t* out_indptr) {
    return drop_count_t(indptr, indices, data, n_rows, tol, rel_mode,
                        diag_strength, drop_diag_mode, lump, out_indptr);
}

void drop_small_fill_i32f32(const int32_t* indptr, const int32_t* indices,
                            const float* data, int64_t n_rows, double tol,
                            int rel_mode, int diag_strength,
                            int drop_diag_mode, int lump, int32_t* out_cols,
                            float* out_data) {
    drop_fill_t(indptr, indices, data, n_rows, tol, rel_mode, diag_strength,
                drop_diag_mode, lump, out_cols, out_data);
}

}  // extern "C"

// ~~~~~~~~~~~~ fused R@(AP) product + relative drop + lump ~~~~~~~~~~~~
// The coarse-matrix step RAP -> remove_small(RAP, a_drop, rel=1, lump)
// (reference: src/AIR_Operators_Setup.F90:960-1082 + PETSc_Helper drop)
// in ONE dense-accumulator sweep: the row is accumulated, its max taken,
// small entries lumped onto the diagonal, and only the kept entries are
// sorted and written.  Never materialises the un-dropped product.
// Caller allocates outputs at the triple-count upper bound; untouched
// pages are never committed.  Returns kept nnz, or -1 when a row needs
// lumping but keeps no diagonal (caller falls back to the two-step path).

// Accumulation strategy note: a per-row L1-resident hash accumulator
// (the Kokkos-GPU SpGEMM trick) was implemented and benchmarked against
// this stamped dense accumulator on the 512^2 bench's RAP products --
// the dense form won at every level (hash 0.79-0.93x), because warm
// per-triple cost here is ~10 ns (cache-resident already); the apparent
// 30-90 ns/triple in fresh processes is first-touch page-fault overhead
// on newly-allocated matrices, addressed by malloc tuning in bench.py,
// not by the kernel.  Keeping the simpler dense accumulator.
template <typename I, typename T>
static int64_t spgemm_drop_t(const I* r_indptr, const I* r_indices,
                             const T* r_data, const I* b_indptr,
                             const I* b_indices, const T* b_data,
                             int64_t n_rows, int64_t n_cols, double tol,
                             int relative, int lump, I* out_indptr,
                             I* out_cols, T* out_data) {
    std::vector<double> vacc(n_cols, 0.0);
    std::vector<int64_t> stamp(n_cols, -1);
    std::vector<I> cols, kept;
    cols.reserve(512);
    kept.reserve(512);
    int64_t out = 0;
    out_indptr[0] = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        cols.clear();
        for (int64_t p = r_indptr[i]; p < r_indptr[i + 1]; ++p) {
            const I k = r_indices[p];
            const double rv = r_data[p];
            for (int64_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
                const I j = b_indices[q];
                if (stamp[j] != i) {
                    stamp[j] = i;
                    vacc[j] = 0.0;
                    cols.push_back(j);
                }
                vacc[j] += rv * b_data[q];
            }
        }
        double rt = tol;
        if (relative) {
            double m = 0.0;
            for (size_t c = 0; c < cols.size(); ++c)
                m = std::max(m, std::fabs(vacc[cols[c]]));
            rt = tol * m;
        }
        kept.clear();
        double lacc = 0.0;
        bool diag_kept = false;
        for (size_t c = 0; c < cols.size(); ++c) {
            const I j = cols[c];
            const double v = vacc[j];
            const bool is_diag = ((int64_t)j == i);
            bool keep = std::fabs(v) >= rt;
            if (is_diag) keep = true;
            if (v == 0.0) keep = false;
            if (keep) {
                if (is_diag) diag_kept = true;
                kept.push_back(j);
            } else if (lump && v != 0.0) {
                lacc += v;
            }
        }
        if (lump && lacc != 0.0) {
            if (!diag_kept) return -1;
            vacc[i] += lacc;   // the accumulator slot stays live until
        }                      // the sorted write-out below
        std::sort(kept.begin(), kept.end());
        for (size_t c = 0; c < kept.size(); ++c) {
            out_cols[out] = kept[c];
            out_data[out] = (T)vacc[kept[c]];
            ++out;
        }
        out_indptr[i + 1] = (I)out;
    }
    return out;
}

extern "C" {

int64_t spgemm_drop(const int64_t* r_indptr, const int64_t* r_indices,
                    const double* r_data, const int64_t* b_indptr,
                    const int64_t* b_indices, const double* b_data,
                    int64_t n_rows, int64_t n_cols, double tol,
                    int relative, int lump, int64_t* out_indptr,
                    int64_t* out_cols, double* out_data) {
    return spgemm_drop_t(r_indptr, r_indices, r_data, b_indptr, b_indices,
                         b_data, n_rows, n_cols, tol, relative, lump,
                         out_indptr, out_cols, out_data);
}

int64_t spgemm_drop_i32(const int32_t* r_indptr, const int32_t* r_indices,
                        const double* r_data, const int32_t* b_indptr,
                        const int32_t* b_indices, const double* b_data,
                        int64_t n_rows, int64_t n_cols, double tol,
                        int relative, int lump, int32_t* out_indptr,
                        int32_t* out_cols, double* out_data) {
    return spgemm_drop_t(r_indptr, r_indices, r_data, b_indptr, b_indices,
                         b_data, n_rows, n_cols, tol, relative, lump,
                         out_indptr, out_cols, out_data);
}

int64_t spgemm_drop_f32(const int64_t* r_indptr, const int64_t* r_indices,
                        const float* r_data, const int64_t* b_indptr,
                        const int64_t* b_indices, const float* b_data,
                        int64_t n_rows, int64_t n_cols, double tol,
                        int relative, int lump, int64_t* out_indptr,
                        int64_t* out_cols, float* out_data) {
    return spgemm_drop_t(r_indptr, r_indices, r_data, b_indptr, b_indices,
                         b_data, n_rows, n_cols, tol, relative, lump,
                         out_indptr, out_cols, out_data);
}

int64_t spgemm_drop_i32f32(const int32_t* r_indptr,
                           const int32_t* r_indices, const float* r_data,
                           const int32_t* b_indptr, const int32_t* b_indices,
                           const float* b_data, int64_t n_rows,
                           int64_t n_cols, double tol, int relative,
                           int lump, int32_t* out_indptr, int32_t* out_cols,
                           float* out_data) {
    return spgemm_drop_t(r_indptr, r_indices, r_data, b_indptr, b_indices,
                         b_data, n_rows, n_cols, tol, relative, lump,
                         out_indptr, out_cols, out_data);
}

}  // extern "C"

// ~~~~~~~~~~~~ one-pass CF submatrix split ~~~~~~~~~~~~
// A -> (A_ff, A_fc, A_cf, A_cc) by the CF markers in ONE streaming pass
// (reference: MatCreateSubMatrixWrapper extraction of the four blocks,
// src/AIR_Operators_Setup.F90:196-227 + src/PETSc_Helper.F90:1121).
// scipy's A[rows][:, cols] double fancy-indexing allocates and re-sorts
// per block; here each CSR entry is routed to exactly one output with
// columns renumbered via col_new (position within its class), staying
// sorted for free.  Outputs are written at the upper bound nnz(A) into
// caller scratch; per-block nnz is returned through the indptrs.

template <typename I, typename T>
static void split_cf_t(const I* indptr, const I* indices, const T* data,
                       int64_t n, const uint8_t* is_fine, const I* col_new,
                       I* ff_indptr, I* ff_cols, T* ff_data,
                       I* fc_indptr, I* fc_cols, T* fc_data,
                       I* cf_indptr, I* cf_cols, T* cf_data,
                       I* cc_indptr, I* cc_cols, T* cc_data, int need_cc) {
    int64_t rf = 0, rc = 0;          // output row counters
    int64_t off = 0, ofc = 0, ocf = 0, occ = 0;
    ff_indptr[0] = fc_indptr[0] = cf_indptr[0] = 0;
    if (need_cc) cc_indptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (is_fine[i]) {
            for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                const I j = indices[p];
                if (is_fine[j]) {
                    ff_cols[off] = col_new[j];
                    ff_data[off] = data[p];
                    ++off;
                } else {
                    fc_cols[ofc] = col_new[j];
                    fc_data[ofc] = data[p];
                    ++ofc;
                }
            }
            ++rf;
            ff_indptr[rf] = (I)off;
            fc_indptr[rf] = (I)ofc;
        } else {
            for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                const I j = indices[p];
                if (is_fine[j]) {
                    cf_cols[ocf] = col_new[j];
                    cf_data[ocf] = data[p];
                    ++ocf;
                } else if (need_cc) {
                    cc_cols[occ] = col_new[j];
                    cc_data[occ] = data[p];
                    ++occ;
                }
            }
            ++rc;
            cf_indptr[rc] = (I)ocf;
            if (need_cc) cc_indptr[rc] = (I)occ;
        }
    }
}

extern "C" {

void split_cf(const int64_t* indptr, const int64_t* indices,
              const double* data, int64_t n, const uint8_t* is_fine,
              const int64_t* col_new,
              int64_t* ff_indptr, int64_t* ff_cols, double* ff_data,
              int64_t* fc_indptr, int64_t* fc_cols, double* fc_data,
              int64_t* cf_indptr, int64_t* cf_cols, double* cf_data,
              int64_t* cc_indptr, int64_t* cc_cols, double* cc_data,
              int need_cc) {
    split_cf_t(indptr, indices, data, n, is_fine, col_new, ff_indptr,
               ff_cols, ff_data, fc_indptr, fc_cols, fc_data, cf_indptr,
               cf_cols, cf_data, cc_indptr, cc_cols, cc_data, need_cc);
}

void split_cf_i32(const int32_t* indptr, const int32_t* indices,
                  const double* data, int64_t n, const uint8_t* is_fine,
                  const int32_t* col_new,
                  int32_t* ff_indptr, int32_t* ff_cols, double* ff_data,
                  int32_t* fc_indptr, int32_t* fc_cols, double* fc_data,
                  int32_t* cf_indptr, int32_t* cf_cols, double* cf_data,
                  int32_t* cc_indptr, int32_t* cc_cols, double* cc_data,
                  int need_cc) {
    split_cf_t(indptr, indices, data, n, is_fine, col_new, ff_indptr,
               ff_cols, ff_data, fc_indptr, fc_cols, fc_data, cf_indptr,
               cf_cols, cf_data, cc_indptr, cc_cols, cc_data, need_cc);
}

void split_cf_f32(const int64_t* indptr, const int64_t* indices,
                  const float* data, int64_t n, const uint8_t* is_fine,
                  const int64_t* col_new,
                  int64_t* ff_indptr, int64_t* ff_cols, float* ff_data,
                  int64_t* fc_indptr, int64_t* fc_cols, float* fc_data,
                  int64_t* cf_indptr, int64_t* cf_cols, float* cf_data,
                  int64_t* cc_indptr, int64_t* cc_cols, float* cc_data,
                  int need_cc) {
    split_cf_t(indptr, indices, data, n, is_fine, col_new, ff_indptr,
               ff_cols, ff_data, fc_indptr, fc_cols, fc_data, cf_indptr,
               cf_cols, cf_data, cc_indptr, cc_cols, cc_data, need_cc);
}

void split_cf_i32f32(const int32_t* indptr, const int32_t* indices,
                     const float* data, int64_t n, const uint8_t* is_fine,
                     const int32_t* col_new,
                     int32_t* ff_indptr, int32_t* ff_cols, float* ff_data,
                     int32_t* fc_indptr, int32_t* fc_cols, float* fc_data,
                     int32_t* cf_indptr, int32_t* cf_cols, float* cf_data,
                     int32_t* cc_indptr, int32_t* cc_cols, float* cc_data,
                     int need_cc) {
    split_cf_t(indptr, indices, data, n, is_fine, col_new, ff_indptr,
               ff_cols, ff_data, fc_indptr, fc_cols, fc_data, cf_indptr,
               cf_cols, cf_data, cc_indptr, cc_cols, cc_data, need_cc);
}

}  // extern "C"

// ~~~~~~~~~~~~ fixed-sparsity polynomial assembly ~~~~~~~~~~~~
// out = sum_k coeffs[k] * A^k restricted onto the pattern S, computed
// row-by-row (reference: mat_mult_powers_share_sparsity,
// src/Gmres_Poly.F90:777-920).  The restricted product is row-local:
// row i of (P @ A)|_S needs only row i of P, so the whole order-m
// accumulation streams each row once through L1 -- no global product is
// ever materialised, unlike the scipy SpGEMM + mask formulation.
// S must contain the diagonal for the k=0 term.

template <typename I, typename T>
static void poly_on_sparsity_t(const I* a_indptr, const I* a_indices,
                               const T* a_data, const I* s_indptr,
                               const I* s_indices, int64_t n_rows,
                               int64_t n_cols, const double* coeffs,
                               int64_t order, T* out_data) {
    // Membership tag and slot packed into ONE word: pk[j] = ((i+1)<<SH)|t
    // when column j sits at slot t of row i's S pattern.  The restricted
    // products (X@A)|_S walk nnz(S) * avg_row(A) elements per power but
    // only 30-45% land inside S (measured on the dense mid-hierarchy
    // A_ff blocks this kernel dominates on) -- an unpredictable branch
    // AND mostly wasted work.  So the intersection PAIR LIST
    // {(src slot, A position, dst slot)} is built once per row (one
    // branchy pass) and each of the order-1 powers replays it as a tight
    // branch-free FMA over the hits only.
    constexpr int SH = 32;
    constexpr int64_t SLOT = ((int64_t)1 << SH) - 1;
    std::vector<int64_t> pk(n_cols, 0);
    std::vector<double> cur, nxt, acc;
    std::vector<int32_t> p_src, p_dst;
    std::vector<int64_t> p_apos;
    for (int64_t i = 0; i < n_rows; ++i) {
        const I s0 = s_indptr[i];
        const int64_t m = s_indptr[i + 1] - s0;
        const int64_t tag = i + 1;
        cur.assign(m, 0.0);
        nxt.assign(m, 0.0);
        acc.assign(m, 0.0);
        for (int64_t t = 0; t < m; ++t)
            pk[s_indices[s0 + t]] = (tag << SH) | t;
        // cur = row i of A restricted to S
        for (I p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
            const int64_t w = pk[a_indices[p]];
            if ((w >> SH) == tag) cur[w & SLOT] = a_data[p];
        }
        for (int64_t t = 0; t < m; ++t) acc[t] = coeffs[1] * cur[t];
        if (order >= 2) {
            p_src.clear(); p_dst.clear(); p_apos.clear();
            for (int64_t t = 0; t < m; ++t) {
                const I kk = s_indices[s0 + t];
                for (I q = a_indptr[kk]; q < a_indptr[kk + 1]; ++q) {
                    const int64_t w = pk[a_indices[q]];
                    if ((w >> SH) == tag) {
                        p_src.push_back((int32_t)t);
                        p_dst.push_back((int32_t)(w & SLOT));
                        p_apos.push_back((int64_t)q);
                    }
                }
            }
            const size_t np = p_src.size();
            const int32_t* ps = p_src.data();
            const int32_t* pd = p_dst.data();
            const int64_t* pa = p_apos.data();
            for (int64_t k = 2; k <= order; ++k) {
                std::fill(nxt.begin(), nxt.end(), 0.0);
                for (size_t e = 0; e < np; ++e)
                    nxt[pd[e]] += cur[ps[e]] * a_data[pa[e]];
                const double ck = coeffs[k];
                for (int64_t t = 0; t < m; ++t) acc[t] += ck * nxt[t];
                cur.swap(nxt);
            }
        }
        if (i < n_cols && (pk[i] >> SH) == tag)
            acc[pk[i] & SLOT] += coeffs[0];
        for (int64_t t = 0; t < m; ++t) out_data[s0 + t] = (T)acc[t];
    }
}

// Newton-basis assembled polynomial restricted onto S: accumulates
// M = sum_i T_i / theta_i with T_{i+1} = (T_i - (T_i A)/theta)|_S,
// complex-conjugate pairs combined in real arithmetic (reference:
// src/Gmres_Poly_Newtonk.kokkos.cxx:15; Loe 2021 Alg. 3).  Row-local for
// the same reason as above.  wr/wi are the Leja-ordered harmonic-Ritz
// roots, k_roots their count.

template <typename I, typename V>
static void newton_on_sparsity_t(const I* a_indptr, const I* a_indices,
                                 const V* a_data, const I* s_indptr,
                                 const I* s_indices, int64_t n_rows,
                                 int64_t n_cols, const double* wr,
                                 const double* wi, int64_t k_roots,
                                 double tol_zero, V* out_data) {
    // packed tag|slot + per-row intersection pair list (see
    // poly_on_sparsity_t above for the rationale): the restricted
    // product runs k_roots times per row on the SAME pattern, so the
    // hits are discovered once and replayed branch-free.
    constexpr int SH = 32;
    constexpr int64_t SLOT = ((int64_t)1 << SH) - 1;
    std::vector<int64_t> pk(n_cols, 0);
    std::vector<double> T, M, TA, T2;
    std::vector<int32_t> p_src, p_dst;
    std::vector<int64_t> p_apos;
    for (int64_t i = 0; i < n_rows; ++i) {
        const I s0 = s_indptr[i];
        const int64_t m = s_indptr[i + 1] - s0;
        const int64_t tag = i + 1;
        T.assign(m, 0.0);
        M.assign(m, 0.0);
        TA.resize(m);
        T2.resize(m);
        int64_t diag_t = -1;
        for (int64_t t = 0; t < m; ++t) {
            const I j = s_indices[s0 + t];
            pk[j] = (tag << SH) | t;
            if ((int64_t)j == i) diag_t = t;
        }
        if (diag_t >= 0) T[diag_t] = 1.0;  // T starts as the identity

        p_src.clear(); p_dst.clear(); p_apos.clear();
        for (int64_t t = 0; t < m; ++t) {
            const I kk = s_indices[s0 + t];
            for (I q = a_indptr[kk]; q < a_indptr[kk + 1]; ++q) {
                const int64_t w = pk[a_indices[q]];
                if ((w >> SH) == tag) {
                    p_src.push_back((int32_t)t);
                    p_dst.push_back((int32_t)(w & SLOT));
                    p_apos.push_back((int64_t)q);
                }
            }
        }
        const size_t np = p_src.size();
        const int32_t* ps = p_src.data();
        const int32_t* pd = p_dst.data();
        const int64_t* pa = p_apos.data();

        // row-local restricted product TA = (T @ A)|_S
        auto restricted_product = [&](const std::vector<double>& X,
                                      std::vector<double>& out) {
            std::fill(out.begin(), out.end(), 0.0);
            const double* Xd = X.data();
            double* od = out.data();
            for (size_t e = 0; e < np; ++e)
                od[pd[e]] += Xd[ps[e]] * a_data[pa[e]];
        };

        int64_t r = 0;
        while (r <= k_roots - 2) {
            if (wi[r] == 0.0) {
                const double th = wr[r];
                if (std::fabs(th) < tol_zero) { ++r; continue; }
                for (int64_t t = 0; t < m; ++t) M[t] += T[t] / th;
                restricted_product(T, TA);
                for (int64_t t = 0; t < m; ++t) T[t] -= TA[t] / th;
                ++r;
            } else {
                const double s = wr[r] * wr[r] + wi[r] * wi[r];
                if (s < tol_zero) { r += 2; continue; }
                restricted_product(T, TA);
                const double tw = 2.0 * wr[r];
                for (int64_t t = 0; t < m; ++t) T2[t] = tw * T[t] - TA[t];
                for (int64_t t = 0; t < m; ++t) M[t] += T2[t] / s;
                if (r <= k_roots - 3) {
                    restricted_product(T2, TA);
                    for (int64_t t = 0; t < m; ++t) T[t] -= TA[t] / s;
                }
                r += 2;
            }
        }
        if (k_roots >= 1 && wi[k_roots - 1] == 0.0 &&
            std::fabs(wr[k_roots - 1]) > tol_zero) {
            const double th = wr[k_roots - 1];
            for (int64_t t = 0; t < m; ++t) M[t] += T[t] / th;
        }
        for (int64_t t = 0; t < m; ++t) out_data[s0 + t] = (V)M[t];
    }
}

extern "C" {

// ~~~~~~~~~~~~ root-node aggregation ~~~~~~~~~~~~
// Sequential three-sweep aggregation (PyAMG-style; reference:
// src/Aggregation.F90).  cf: 0 undecided in, +1 C / -1 F out;
// aggregates: aggregate id per node.  Returns the aggregate count.
int64_t aggregation(const int64_t* indptr, const int64_t* indices,
                    int64_t n, int64_t* cf, int64_t* aggregates) {
    int64_t aggregate = 1;
    // Step 1 -- initial covering
    for (int64_t i = 0; i < n; ++i) {
        const int64_t lo = indptr[i], hi = indptr[i + 1];
        if (hi == lo) { cf[i] = -1; continue; }
        if (cf[i] != 0) continue;
        bool any = false;
        for (int64_t p = lo; p < hi; ++p)
            if (cf[indices[p]] != 0) { any = true; break; }
        if (any) continue;
        cf[i] = 1;
        aggregates[i] = aggregate;
        for (int64_t p = lo; p < hi; ++p) {
            cf[indices[p]] = -1;
            aggregates[indices[p]] = aggregate;
        }
        ++aggregate;
    }
    // Step 2 -- enlarge: join the first strongly connected aggregate
    for (int64_t i = 0; i < n; ++i) {
        if (cf[i] != 0) continue;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int64_t a = aggregates[indices[p]];
            if (a > 0) {
                cf[i] = -1;
                aggregates[i] = -a;
                ++aggregate;
                break;
            }
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (aggregates[i] < 0) aggregates[i] = -aggregates[i];
    // Step 3 -- remnants become new roots
    for (int64_t i = 0; i < n; ++i) {
        if (cf[i] != 0) continue;
        cf[i] = 1;
        aggregates[i] = aggregate;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int64_t j = indices[p];
            if (cf[j] == 0) { cf[j] = -1; aggregates[j] = aggregate; }
        }
        ++aggregate;
    }
    return aggregate - 1;
}

void poly_on_sparsity(const int64_t* a_indptr, const int64_t* a_indices,
                      const double* a_data, const int64_t* s_indptr,
                      const int64_t* s_indices, int64_t n_rows,
                      int64_t n_cols, const double* coeffs, int64_t order,
                      double* out_data) {
    poly_on_sparsity_t(a_indptr, a_indices, a_data, s_indptr, s_indices,
                       n_rows, n_cols, coeffs, order, out_data);
}

void poly_on_sparsity_i32(const int32_t* a_indptr, const int32_t* a_indices,
                          const double* a_data, const int32_t* s_indptr,
                          const int32_t* s_indices, int64_t n_rows,
                          int64_t n_cols, const double* coeffs,
                          int64_t order, double* out_data) {
    poly_on_sparsity_t(a_indptr, a_indices, a_data, s_indptr, s_indices,
                       n_rows, n_cols, coeffs, order, out_data);
}

void newton_on_sparsity(const int64_t* a_indptr, const int64_t* a_indices,
                        const double* a_data, const int64_t* s_indptr,
                        const int64_t* s_indices, int64_t n_rows,
                        int64_t n_cols, const double* wr, const double* wi,
                        int64_t k_roots, double tol_zero, double* out_data) {
    newton_on_sparsity_t(a_indptr, a_indices, a_data, s_indptr, s_indices,
                         n_rows, n_cols, wr, wi, k_roots, tol_zero,
                         out_data);
}

void newton_on_sparsity_i32(const int32_t* a_indptr,
                            const int32_t* a_indices, const double* a_data,
                            const int32_t* s_indptr,
                            const int32_t* s_indices, int64_t n_rows,
                            int64_t n_cols, const double* wr,
                            const double* wi, int64_t k_roots,
                            double tol_zero, double* out_data) {
    newton_on_sparsity_t(a_indptr, a_indices, a_data, s_indptr, s_indices,
                         n_rows, n_cols, wr, wi, k_roots, tol_zero,
                         out_data);
}

void poly_on_sparsity_f32(const int64_t* a_indptr, const int64_t* a_indices,
                          const float* a_data, const int64_t* s_indptr,
                          const int64_t* s_indices, int64_t n_rows,
                          int64_t n_cols, const double* coeffs,
                          int64_t order, float* out_data) {
    poly_on_sparsity_t(a_indptr, a_indices, a_data, s_indptr, s_indices,
                       n_rows, n_cols, coeffs, order, out_data);
}

void poly_on_sparsity_i32f32(const int32_t* a_indptr,
                             const int32_t* a_indices, const float* a_data,
                             const int32_t* s_indptr,
                             const int32_t* s_indices, int64_t n_rows,
                             int64_t n_cols, const double* coeffs,
                             int64_t order, float* out_data) {
    poly_on_sparsity_t(a_indptr, a_indices, a_data, s_indptr, s_indices,
                       n_rows, n_cols, coeffs, order, out_data);
}

void newton_on_sparsity_f32(const int64_t* a_indptr,
                            const int64_t* a_indices, const float* a_data,
                            const int64_t* s_indptr,
                            const int64_t* s_indices, int64_t n_rows,
                            int64_t n_cols, const double* wr,
                            const double* wi, int64_t k_roots,
                            double tol_zero, float* out_data) {
    newton_on_sparsity_t(a_indptr, a_indices, a_data, s_indptr, s_indices,
                         n_rows, n_cols, wr, wi, k_roots, tol_zero,
                         out_data);
}

void newton_on_sparsity_i32f32(const int32_t* a_indptr,
                               const int32_t* a_indices, const float* a_data,
                               const int32_t* s_indptr,
                               const int32_t* s_indices, int64_t n_rows,
                               int64_t n_cols, const double* wr,
                               const double* wi, int64_t k_roots,
                               double tol_zero, float* out_data) {
    newton_on_sparsity_t(a_indptr, a_indices, a_data, s_indptr, s_indices,
                         n_rows, n_cols, wr, wi, k_roots, tol_zero,
                         out_data);
}

}  // extern "C"

// ~~~~~~~~~~~~~~~~ AP product for one-entry-per-row P ~~~~~~~~~~~~~~~~
// C = A @ P when every row of P holds at most ONE entry (the one-point
// classical prolongator P = [W;I] with W one-point, the default; and the
// reference's own device fast path exploits the same structure).  The
// product degenerates to a column relabel pcol[j] + per-row duplicate
// merge -- one streaming O(nnz(A)) pass instead of a general Gustavson
// SpGEMM (reference: the MatMatMult in
// src/AIR_Operators_Setup.F90:1006-1033, here specialised on P's
// structure).  Rows of A are short (<= a few dozen), so the merge is an
// insertion sort into a small local buffer.  Output written at the
// nnz(A) upper bound; returns total kept nnz.
template <typename I, typename T>
static int64_t ap_onepoint_t(const I* a_indptr, const I* a_indices,
                             const T* a_data, const I* pcol, const T* pval,
                             int64_t n_rows, I* out_indptr, I* out_cols,
                             T* out_data) {
    int64_t out = 0;
    out_indptr[0] = 0;
    I cols[512];
    double vals[512];
    std::vector<I> big_cols;
    std::vector<double> big_vals;
    for (int64_t i = 0; i < n_rows; ++i) {
        const int64_t row_len = a_indptr[i + 1] - a_indptr[i];
        I* c = cols;
        double* v = vals;
        if (row_len > 512) {            // arbitrarily wide rows: heap
            big_cols.resize(row_len);
            big_vals.resize(row_len);
            c = big_cols.data();
            v = big_vals.data();
        }
        int64_t m = 0;
        for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
            const I j = a_indices[p];
            const I jj = pcol[j];
            if (jj < 0) continue;       // empty P row contributes nothing
            const double av = (double)a_data[p] * (double)pval[j];
            // insertion into the sorted (c, v) prefix, merging duplicates
            int64_t lo = 0, hi = m;
            while (lo < hi) {           // lower_bound
                const int64_t mid = (lo + hi) >> 1;
                if (c[mid] < jj) lo = mid + 1; else hi = mid;
            }
            if (lo < m && c[lo] == jj) {
                v[lo] += av;
            } else {
                for (int64_t k = m; k > lo; --k) {
                    c[k] = c[k - 1];
                    v[k] = v[k - 1];
                }
                c[lo] = jj;
                v[lo] = av;
                ++m;
            }
        }
        for (int64_t k = 0; k < m; ++k) {
            // exact-cancellation zeros from the duplicate merge are
            // dropped, matching scipy's csr_matmat output pattern
            const T tv = (T)v[k];
            if (tv == (T)0) continue;
            out_cols[out] = c[k];
            out_data[out] = tv;
            ++out;
        }
        out_indptr[i + 1] = (I)out;
    }
    return out;
}

extern "C" {

int64_t ap_onepoint(const int64_t* a_indptr, const int64_t* a_indices,
                    const double* a_data, const int64_t* pcol,
                    const double* pval, int64_t n_rows,
                    int64_t* out_indptr, int64_t* out_cols,
                    double* out_data) {
    return ap_onepoint_t(a_indptr, a_indices, a_data, pcol, pval, n_rows,
                         out_indptr, out_cols, out_data);
}

int64_t ap_onepoint_i32(const int32_t* a_indptr, const int32_t* a_indices,
                        const double* a_data, const int32_t* pcol,
                        const double* pval, int64_t n_rows,
                        int32_t* out_indptr, int32_t* out_cols,
                        double* out_data) {
    return ap_onepoint_t(a_indptr, a_indices, a_data, pcol, pval, n_rows,
                         out_indptr, out_cols, out_data);
}

int64_t ap_onepoint_f32(const int64_t* a_indptr, const int64_t* a_indices,
                        const float* a_data, const int64_t* pcol,
                        const float* pval, int64_t n_rows,
                        int64_t* out_indptr, int64_t* out_cols,
                        float* out_data) {
    return ap_onepoint_t(a_indptr, a_indices, a_data, pcol, pval, n_rows,
                         out_indptr, out_cols, out_data);
}

int64_t ap_onepoint_i32f32(const int32_t* a_indptr,
                           const int32_t* a_indices, const float* a_data,
                           const int32_t* pcol, const float* pval,
                           int64_t n_rows, int32_t* out_indptr,
                           int32_t* out_cols, float* out_data) {
    return ap_onepoint_t(a_indptr, a_indices, a_data, pcol, pval, n_rows,
                         out_indptr, out_cols, out_data);
}

}  // extern "C"

// ~~~~~~~~~~~~~~~~ CSR -> padded-ELL layout ~~~~~~~~~~~~~~~~
// One pass over rows filling the padded column table and the CSR-pos ->
// ELL-slot map (pattern.py::SparsityPattern._build_ell's job: the numpy
// fancy-indexed form costs ~0.24 s at 512^2 -- ~20% of a warm host
// setup -- vs ~10 ms here; this is pure layout shuffling, exactly the
// kind of scalar loop the Fortran reference does inline when it builds
// its AIJ structures).  Padded slots stay 0 (caller pre-zeroes or we
// zero here: we zero here so the caller can use np.empty).

template <typename I>
static int csr_to_ell_t(const I* indptr, const I* indices, int64_t n_rows,
                        int64_t K, int32_t* ell_cols,
                        int64_t* slot_of_pos) {
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t s = (int64_t)indptr[r];
        const int64_t e = (int64_t)indptr[r + 1];
        int32_t* row = ell_cols + r * K;
        const int64_t len = e - s;
        if (len > K) return 1;  // caller's K too small: loud, not corrupt
        for (int64_t j = 0; j < len; ++j) {
            row[j] = (int32_t)indices[s + j];
            slot_of_pos[s + j] = r * K + j;
        }
        for (int64_t j = len; j < K; ++j) row[j] = 0;
    }
    return 0;
}

extern "C" {

int csr_to_ell(const int64_t* indptr, const int64_t* indices,
               int64_t n_rows, int64_t K, int32_t* ell_cols,
               int64_t* slot_of_pos) {
    return csr_to_ell_t(indptr, indices, n_rows, K, ell_cols, slot_of_pos);
}

int csr_to_ell_i32(const int32_t* indptr, const int32_t* indices,
                   int64_t n_rows, int64_t K, int32_t* ell_cols,
                   int64_t* slot_of_pos) {
    return csr_to_ell_t(indptr, indices, n_rows, K, ell_cols, slot_of_pos);
}

}  // extern "C"

// ~~~~~~~~~~~~~~~~ plan enumeration with lump redirect ~~~~~~~~~~~~~~~~
// Like plan_fill, but triples whose (i,j) is outside C's pattern are
// REDIRECTED onto C's diagonal entry of row i (the fused drop+lump of the
// RAP re-product, reference: remove_small_from_sparse lump semantics,
// src/PETSc_Helper.F90:207-412).  Rows without a structural diagonal in C
// drop their outside triples instead (matching spgemm_onto_pattern_t).
// Triple order is (i, p, q) lexicographic -- identical accumulation order
// to plan_fill restricted to the kept entries.
template <typename I>
static int64_t plan_fill_lump_t(const I* a_indptr, const I* a_indices,
                                const I* b_indptr, const I* b_indices,
                                const I* c_indptr, const I* c_indices,
                                int64_t n_rows, int64_t n_cols,
                                int64_t* a_pos, int64_t* b_pos,
                                int64_t* c_pos) {
    std::vector<int64_t> stamp(n_cols, -1);
    std::vector<int64_t> cpos(n_cols, 0);
    int64_t out = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t diag_pos = -1;
        for (I c = c_indptr[i]; c < c_indptr[i + 1]; ++c) {
            const I j = c_indices[c];
            stamp[j] = i;
            cpos[j] = c;
            if ((int64_t)j == i) diag_pos = c;
        }
        for (I p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
            const I k = a_indices[p];
            for (I q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
                const I j = b_indices[q];
                int64_t tgt;
                if (stamp[j] == i) tgt = cpos[j];
                else if (diag_pos >= 0) tgt = diag_pos;
                else continue;
                a_pos[out] = p;
                b_pos[out] = q;
                c_pos[out] = tgt;
                ++out;
            }
        }
    }
    return out;
}

// ~~~~~~~~~~~~~~~~ plan execution ~~~~~~~~~~~~~~~~
// Numeric re-execution of a stored SpGEMM plan: out[c_pos[k]] +=
// alpha * a[a_pos[k]] * b[b_pos[k]] over k ascending -- the exact
// accumulation order of a numpy bincount over the triple arrays, so host
// plan execs stay bitwise-paired with the device segment-sum re-setup.
// b may be NULL (unit second operand: the one-point AP product whose P
// values are all 1.0).
static void plan_execute_impl(const double* a, const double* b,
                              const int64_t* a_pos, const int64_t* b_pos,
                              const int64_t* c_pos, int64_t n_triples,
                              double alpha, double* out, int64_t nnz_out) {
    for (int64_t t = 0; t < nnz_out; ++t) out[t] = 0.0;
    if (b != nullptr) {
        if (alpha == 1.0) {
            for (int64_t k = 0; k < n_triples; ++k)
                out[c_pos[k]] += a[a_pos[k]] * b[b_pos[k]];
        } else {
            for (int64_t k = 0; k < n_triples; ++k)
                out[c_pos[k]] += alpha * a[a_pos[k]] * b[b_pos[k]];
        }
    } else {
        if (alpha == 1.0) {
            for (int64_t k = 0; k < n_triples; ++k)
                out[c_pos[k]] += a[a_pos[k]];
        } else {
            for (int64_t k = 0; k < n_triples; ++k)
                out[c_pos[k]] += alpha * a[a_pos[k]];
        }
    }
}

// Gather with a fill value for negative indices: out[k] = idx[k] >= 0 ?
// src[idx[k]] : fill  (the R/P value-assembly permutations, where -1
// marks the structural identity entries).
static void gather_fill_impl(const double* src, const int64_t* idx,
                             int64_t n, double fill, double* out) {
    for (int64_t k = 0; k < n; ++k)
        out[k] = idx[k] >= 0 ? src[idx[k]] : fill;
}

extern "C" {

int64_t plan_fill_lump(const int64_t* a_indptr, const int64_t* a_indices,
                       const int64_t* b_indptr, const int64_t* b_indices,
                       const int64_t* c_indptr, const int64_t* c_indices,
                       int64_t n_rows, int64_t n_cols,
                       int64_t* a_pos, int64_t* b_pos, int64_t* c_pos) {
    return plan_fill_lump_t(a_indptr, a_indices, b_indptr, b_indices,
                            c_indptr, c_indices, n_rows, n_cols,
                            a_pos, b_pos, c_pos);
}

int64_t plan_fill_lump_i32(const int32_t* a_indptr, const int32_t* a_indices,
                           const int32_t* b_indptr, const int32_t* b_indices,
                           const int32_t* c_indptr, const int32_t* c_indices,
                           int64_t n_rows, int64_t n_cols,
                           int64_t* a_pos, int64_t* b_pos, int64_t* c_pos) {
    return plan_fill_lump_t(a_indptr, a_indices, b_indptr, b_indices,
                            c_indptr, c_indices, n_rows, n_cols,
                            a_pos, b_pos, c_pos);
}

void plan_execute(const double* a, const double* b, const int64_t* a_pos,
                  const int64_t* b_pos, const int64_t* c_pos,
                  int64_t n_triples, double alpha, double* out,
                  int64_t nnz_out) {
    plan_execute_impl(a, b, a_pos, b_pos, c_pos, n_triples, alpha, out,
                      nnz_out);
}

void gather_fill(const double* src, const int64_t* idx, int64_t n,
                 double fill, double* out) {
    gather_fill_impl(src, idx, n, fill, out);
}

}  // extern "C"

// int32-position variants of the plan executor / permutation gather (plan
// position arrays halve; these kernels are memory-bound on the triple
// streams, measured ~25% faster at the 512^2 RAP re-product).
static void plan_execute_impl32(const double* a, const double* b,
                                const int32_t* a_pos, const int32_t* b_pos,
                                const int32_t* c_pos, int64_t n_triples,
                                double alpha, double* out,
                                int64_t nnz_out) {
    for (int64_t t = 0; t < nnz_out; ++t) out[t] = 0.0;
    if (b != nullptr) {
        if (alpha == 1.0) {
            for (int64_t k = 0; k < n_triples; ++k)
                out[c_pos[k]] += a[a_pos[k]] * b[b_pos[k]];
        } else {
            for (int64_t k = 0; k < n_triples; ++k)
                out[c_pos[k]] += alpha * a[a_pos[k]] * b[b_pos[k]];
        }
    } else {
        if (alpha == 1.0) {
            for (int64_t k = 0; k < n_triples; ++k)
                out[c_pos[k]] += a[a_pos[k]];
        } else {
            for (int64_t k = 0; k < n_triples; ++k)
                out[c_pos[k]] += alpha * a[a_pos[k]];
        }
    }
}

extern "C" {

void plan_execute_i32(const double* a, const double* b,
                      const int32_t* a_pos, const int32_t* b_pos,
                      const int32_t* c_pos, int64_t n_triples,
                      double alpha, double* out, int64_t nnz_out) {
    plan_execute_impl32(a, b, a_pos, b_pos, c_pos, n_triples, alpha, out,
                        nnz_out);
}

void gather_fill_i32(const double* src, const int32_t* idx, int64_t n,
                     double fill, double* out) {
    for (int64_t k = 0; k < n; ++k)
        out[k] = idx[k] >= 0 ? src[idx[k]] : fill;
}

}  // extern "C"

// Templated-output variants of the plan fills: int32 position outputs
// halve the triple-stream memory (valid whenever every operand nnz fits
// int32, always true for single-host problems).
template <typename I, typename O>
static int64_t plan_fill_o(const I* a_indptr, const I* a_indices,
                           const I* b_indptr, const I* b_indices,
                           const I* c_indptr, const I* c_indices,
                           int64_t n_rows, int64_t n_cols,
                           O* a_pos, O* b_pos, O* c_pos) {
    std::vector<int64_t> stamp(n_cols, -1);
    std::vector<int64_t> cpos(n_cols, 0);
    int64_t out = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        for (I c = c_indptr[i]; c < c_indptr[i + 1]; ++c) {
            stamp[c_indices[c]] = i;
            cpos[c_indices[c]] = c;
        }
        for (I p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
            const I k = a_indices[p];
            for (I q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
                const I j = b_indices[q];
                if (stamp[j] == i) {
                    a_pos[out] = (O)p;
                    b_pos[out] = (O)q;
                    c_pos[out] = (O)cpos[j];
                    ++out;
                }
            }
        }
    }
    return out;
}

template <typename I, typename O>
static int64_t plan_fill_lump_o(const I* a_indptr, const I* a_indices,
                                const I* b_indptr, const I* b_indices,
                                const I* c_indptr, const I* c_indices,
                                int64_t n_rows, int64_t n_cols,
                                O* a_pos, O* b_pos, O* c_pos) {
    std::vector<int64_t> stamp(n_cols, -1);
    std::vector<int64_t> cpos(n_cols, 0);
    int64_t out = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t diag_pos = -1;
        for (I c = c_indptr[i]; c < c_indptr[i + 1]; ++c) {
            const I j = c_indices[c];
            stamp[j] = i;
            cpos[j] = c;
            if ((int64_t)j == i) diag_pos = c;
        }
        for (I p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
            const I k = a_indices[p];
            for (I q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
                const I j = b_indices[q];
                int64_t tgt;
                if (stamp[j] == i) tgt = cpos[j];
                else if (diag_pos >= 0) tgt = diag_pos;
                else continue;
                a_pos[out] = (O)p;
                b_pos[out] = (O)q;
                c_pos[out] = (O)tgt;
                ++out;
            }
        }
    }
    return out;
}

extern "C" {

int64_t plan_fill32_i32(const int32_t* a_indptr, const int32_t* a_indices,
                        const int32_t* b_indptr, const int32_t* b_indices,
                        const int32_t* c_indptr, const int32_t* c_indices,
                        int64_t n_rows, int64_t n_cols,
                        int32_t* a_pos, int32_t* b_pos, int32_t* c_pos) {
    return plan_fill_o(a_indptr, a_indices, b_indptr, b_indices,
                       c_indptr, c_indices, n_rows, n_cols,
                       a_pos, b_pos, c_pos);
}

int64_t plan_fill32(const int64_t* a_indptr, const int64_t* a_indices,
                    const int64_t* b_indptr, const int64_t* b_indices,
                    const int64_t* c_indptr, const int64_t* c_indices,
                    int64_t n_rows, int64_t n_cols,
                    int32_t* a_pos, int32_t* b_pos, int32_t* c_pos) {
    return plan_fill_o(a_indptr, a_indices, b_indptr, b_indices,
                       c_indptr, c_indices, n_rows, n_cols,
                       a_pos, b_pos, c_pos);
}

int64_t plan_fill_lump32_i32(const int32_t* a_indptr,
                             const int32_t* a_indices,
                             const int32_t* b_indptr,
                             const int32_t* b_indices,
                             const int32_t* c_indptr,
                             const int32_t* c_indices,
                             int64_t n_rows, int64_t n_cols,
                             int32_t* a_pos, int32_t* b_pos,
                             int32_t* c_pos) {
    return plan_fill_lump_o(a_indptr, a_indices, b_indptr, b_indices,
                            c_indptr, c_indices, n_rows, n_cols,
                            a_pos, b_pos, c_pos);
}

int64_t plan_fill_lump32(const int64_t* a_indptr, const int64_t* a_indices,
                         const int64_t* b_indptr, const int64_t* b_indices,
                         const int64_t* c_indptr, const int64_t* c_indices,
                         int64_t n_rows, int64_t n_cols,
                         int32_t* a_pos, int32_t* b_pos, int32_t* c_pos) {
    return plan_fill_lump_o(a_indptr, a_indices, b_indptr, b_indices,
                            c_indptr, c_indices, n_rows, n_cols,
                            a_pos, b_pos, c_pos);
}

}  // extern "C"

// ~~~~~~~~~~~~~~~~ pattern symmetrize (S | S^T) ~~~~~~~~~~~~~~~~
// Union pattern of a sorted CSR with its transpose, all values 1.0 --
// the strength-matrix symmetrization (reference: src/SAbs.F90 S + S^T),
// whose values are overwritten with 1 afterwards so only the PATTERN
// matters.  Builds the transpose with a counting scatter (row-major scan
// keeps its rows sorted), then merges row pairs.  Two exact-size passes.
template <typename I>
static int64_t sym_union_count_t(const I* indptr, const I* indices,
                                 int64_t n, I* t_indptr, I* t_indices,
                                 I* out_rowcnt) {
    // transpose counts
    std::vector<int64_t> cnt(n, 0);
    const int64_t nnz = indptr[n];
    for (int64_t p = 0; p < nnz; ++p) ++cnt[indices[p]];
    t_indptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) t_indptr[i + 1] = (I)(t_indptr[i] + cnt[i]);
    std::vector<int64_t> w(n);
    for (int64_t i = 0; i < n; ++i) w[i] = t_indptr[i];
    for (int64_t i = 0; i < n; ++i)
        for (I p = indptr[i]; p < indptr[i + 1]; ++p)
            t_indices[w[indices[p]]++] = (I)i;
    // merged union counts per row
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        I a = indptr[i], ae = indptr[i + 1];
        I b = t_indptr[i], be = t_indptr[i + 1];
        int64_t c = 0;
        while (a < ae && b < be) {
            if (indices[a] == t_indices[b]) { ++a; ++b; }
            else if (indices[a] < t_indices[b]) ++a;
            else ++b;
            ++c;
        }
        c += (ae - a) + (be - b);
        out_rowcnt[i] = (I)c;
        total += c;
    }
    return total;
}

template <typename I, typename T>
static void sym_union_fill_t(const I* indptr, const I* indices,
                             const I* t_indptr, const I* t_indices,
                             int64_t n, const I* out_indptr,
                             I* out_indices, T* out_data) {
    for (int64_t i = 0; i < n; ++i) {
        I a = indptr[i], ae = indptr[i + 1];
        I b = t_indptr[i], be = t_indptr[i + 1];
        int64_t o = out_indptr[i];
        while (a < ae && b < be) {
            if (indices[a] == t_indices[b]) {
                out_indices[o] = indices[a]; ++a; ++b;
            } else if (indices[a] < t_indices[b]) {
                out_indices[o] = indices[a]; ++a;
            } else {
                out_indices[o] = t_indices[b]; ++b;
            }
            out_data[o++] = (T)1.0;
        }
        for (; a < ae; ++a) { out_indices[o] = indices[a]; out_data[o++] = (T)1.0; }
        for (; b < be; ++b) { out_indices[o] = t_indices[b]; out_data[o++] = (T)1.0; }
    }
}

extern "C" {

int64_t sym_union_count(const int64_t* indptr, const int64_t* indices,
                        int64_t n, int64_t* t_indptr, int64_t* t_indices,
                        int64_t* out_rowcnt) {
    return sym_union_count_t(indptr, indices, n, t_indptr, t_indices,
                             out_rowcnt);
}

int64_t sym_union_count_i32(const int32_t* indptr, const int32_t* indices,
                            int64_t n, int32_t* t_indptr,
                            int32_t* t_indices, int32_t* out_rowcnt) {
    return sym_union_count_t(indptr, indices, n, t_indptr, t_indices,
                             out_rowcnt);
}

void sym_union_fill(const int64_t* indptr, const int64_t* indices,
                    const int64_t* t_indptr, const int64_t* t_indices,
                    int64_t n, const int64_t* out_indptr,
                    int64_t* out_indices, double* out_data) {
    sym_union_fill_t(indptr, indices, t_indptr, t_indices, n, out_indptr,
                     out_indices, out_data);
}

void sym_union_fill_i32(const int32_t* indptr, const int32_t* indices,
                        const int32_t* t_indptr, const int32_t* t_indices,
                        int64_t n, const int32_t* out_indptr,
                        int32_t* out_indices, double* out_data) {
    sym_union_fill_t(indptr, indices, t_indptr, t_indices, n, out_indptr,
                     out_indices, out_data);
}

void sym_union_fill_f32(const int64_t* indptr, const int64_t* indices,
                        const int64_t* t_indptr, const int64_t* t_indices,
                        int64_t n, const int64_t* out_indptr,
                        int64_t* out_indices, float* out_data) {
    sym_union_fill_t(indptr, indices, t_indptr, t_indices, n, out_indptr,
                     out_indices, out_data);
}

void sym_union_fill_i32f32(const int32_t* indptr, const int32_t* indices,
                           const int32_t* t_indptr, const int32_t* t_indices,
                           int64_t n, const int32_t* out_indptr,
                           int32_t* out_indices, float* out_data) {
    sym_union_fill_t(indptr, indices, t_indptr, t_indices, n, out_indptr,
                     out_indices, out_data);
}

}  // extern "C"

// ~~~~~~~~~~~~~~~~ one-point strongest (classical prolongator) ~~~~~~~~~~~~~~~~
// out_cols[i] = column of the strongest |entry| of row i (FIRST position
// achieving the row max -- the lowest column, since CSR entries are
// column-sorted), or -1 for empty rows.  Returns the nonempty-row count.
// Replaces a numpy np.maximum.at reduction (unbuffered ufunc.at measured
// ~20 ms per call at 512^2); reference: src/Grid_Transfer.F90:26.
template <typename I, typename T>
static int64_t one_point_strongest_t(const I* indptr, const I* indices,
                                     const T* data, int64_t n_rows,
                                     I* out_cols) {
    int64_t cnt = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        double best = -1.0;
        I bc = (I)-1;
        for (I p = indptr[i]; p < indptr[i + 1]; ++p) {
            const double v = std::fabs((double)data[p]);
            if (v > best) { best = v; bc = indices[p]; }
        }
        out_cols[i] = bc;
        if (bc >= 0) ++cnt;
    }
    return cnt;
}

extern "C" {

int64_t one_point_strongest(const int64_t* indptr, const int64_t* indices,
                            const double* data, int64_t n_rows,
                            int64_t* out_cols) {
    return one_point_strongest_t(indptr, indices, data, n_rows, out_cols);
}

int64_t one_point_strongest_i32(const int32_t* indptr,
                                const int32_t* indices, const double* data,
                                int64_t n_rows, int32_t* out_cols) {
    return one_point_strongest_t(indptr, indices, data, n_rows, out_cols);
}

int64_t one_point_strongest_f32(const int64_t* indptr,
                                const int64_t* indices, const float* data,
                                int64_t n_rows, int64_t* out_cols) {
    return one_point_strongest_t(indptr, indices, data, n_rows, out_cols);
}

int64_t one_point_strongest_i32f32(const int32_t* indptr,
                                   const int32_t* indices,
                                   const float* data, int64_t n_rows,
                                   int32_t* out_cols) {
    return one_point_strongest_t(indptr, indices, data, n_rows, out_cols);
}

}  // extern "C"
