// Native host data layer of basic_iterative_solvers_tpu_torch: the JAX
// package's csrc/bis_host.cpp, copied with its C interface unchanged.
//
// The reference implements its entire host pipeline in C++ (mmio parser,
// COO->CRS conversion, L/U splitting, diagonal peeling, ILU(0) — see the
// reference's utilities/{mmio.cpp,utilities.hpp,LU_factors.hpp}).  This
// library is the port's equivalent: single-pass C++ loops for the
// set-up-time host work, called from Python via ctypes (_native.py), with
// the NumPy branches kept as plain versions and test oracles.  It is built
// with g++ at first use, apart from the CUDA kernels' library.
//
// All functions are extern "C", operate on caller-allocated buffers, and
// return 0 on success or a negative error code:
//   -1 generic failure        -2 duplicate (row,col) entry
//   -3 missing diagonal       -4 zero diagonal (row via out-param where
//   present; bis_ilu0 returns -(1000+i) with i = the missing-diagonal row)
//
// Index conventions match the Python layer: row_ptr int64, col/I/J int32,
// values double.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Matrix Market triplet parsing (hot loop of the .mtx reader; the analog of
// mm_read_mtx_crd_data, the reference's utilities/mmio.cpp and the optional
// fast_matrix_market path, the reference's sparse_matrix.hpp:230-259).
//
// Parses up to max_entries "i j [v]" lines from text (skipping blank lines
// and '%' comments), writing 0-based indices.  with_value=0 -> pattern file,
// V filled with pattern_value.  Returns the number of entries parsed, or a
// negative error code on malformed input.
// ---------------------------------------------------------------------------
long long bis_parse_triplets(const char* text, long long len,
                             long long max_entries, int with_value,
                             double pattern_value,
                             int32_t* I, int32_t* J, double* V) {
    const char* p = text;
    const char* end = text + len;
    long long count = 0;
    while (p < end && count < max_entries) {
        // skip whitespace/newlines
        while (p < end && isspace((unsigned char)*p)) ++p;
        if (p >= end) break;
        if (*p == '%') {  // comment line
            while (p < end && *p != '\n') ++p;
            continue;
        }
        char* q;
        long i = strtol(p, &q, 10);
        if (q == p) return -1;
        p = q;
        long j = strtol(p, &q, 10);
        if (q == p) return -1;
        p = q;
        double v = pattern_value;
        if (with_value) {
            v = strtod(p, &q);
            if (q == p) return -1;
            p = q;
        }
        I[count] = (int32_t)(i - 1);
        J[count] = (int32_t)(j - 1);
        V[count] = v;
        ++count;
    }
    return count;
}

// ---------------------------------------------------------------------------
// COO -> CSR with row-major (row, col) ordering and duplicate detection
// (convert_coo_to_crs analog, the reference's utilities/utilities.hpp:326-367,
// plus the fast-mmio sort, sparse_matrix.hpp:20-57).  LSD counting sort:
// stable by column, then stable by row -> fully (row, col)-sorted in two
// O(nnz) passes with no comparison sort.
// ---------------------------------------------------------------------------
int bis_coo_to_csr(long long nnz, int32_t n_rows, int32_t n_cols,
                   const int32_t* I, const int32_t* J, const double* V,
                   int64_t* row_ptr, int32_t* col, double* val) {
    std::vector<int64_t> counts((size_t)(n_cols > n_rows ? n_cols : n_rows) + 1, 0);
    std::vector<int32_t> tmpI((size_t)nnz);
    std::vector<int32_t> tmpJ((size_t)nnz);
    std::vector<double> tmpV((size_t)nnz);

    // pass 1: stable counting sort by column
    for (long long k = 0; k < nnz; ++k) {
        int32_t j = J[k];
        if (j < 0 || j >= n_cols || I[k] < 0 || I[k] >= n_rows) return -1;
        ++counts[(size_t)j];
    }
    int64_t acc = 0;
    for (int32_t j = 0; j < n_cols; ++j) {
        int64_t c = counts[(size_t)j];
        counts[(size_t)j] = acc;
        acc += c;
    }
    for (long long k = 0; k < nnz; ++k) {
        int64_t dst = counts[(size_t)J[k]]++;
        tmpI[(size_t)dst] = I[k];
        tmpJ[(size_t)dst] = J[k];
        tmpV[(size_t)dst] = V[k];
    }

    // pass 2: stable counting sort by row (column order preserved per row)
    std::memset(counts.data(), 0, sizeof(int64_t) * ((size_t)n_rows + 1));
    for (long long k = 0; k < nnz; ++k) ++counts[(size_t)tmpI[(size_t)k]];
    acc = 0;
    for (int32_t i = 0; i < n_rows; ++i) {
        int64_t c = counts[(size_t)i];
        row_ptr[i] = acc;
        counts[(size_t)i] = acc;
        acc += c;
    }
    row_ptr[n_rows] = acc;
    for (long long k = 0; k < nnz; ++k) {
        int64_t dst = counts[(size_t)tmpI[(size_t)k]]++;
        col[dst] = tmpJ[(size_t)k];
        val[dst] = tmpV[(size_t)k];
    }

    // duplicate detection on the sorted output
    for (int32_t i = 0; i < n_rows; ++i)
        for (int64_t k = row_ptr[i] + 1; k < row_ptr[i + 1]; ++k)
            if (col[k] == col[k - 1]) return -2;
    return 0;
}

// ---------------------------------------------------------------------------
// COO -> CSR with duplicate (i,j) entries SUMMED (Matrix-Market duplicate
// semantics; generators.scattered_band's symmetrization overlaps).  Same
// two stable LSD counting-sort passes as bis_coo_to_csr, then an in-place
// compaction — summation order is the stable sort order, i.e. the input
// order within each (i,j) group, so results are bit-identical to the NumPy
// stable-argsort + add.at pipeline it replaces (which comparison-sorted
// ~90M int64 keys: the dominant generator cost on a slow host).
// Returns the deduplicated nnz, or -1 on out-of-range indices.
// ---------------------------------------------------------------------------
long long bis_coo_dedup_csr(long long nnz, int32_t n_rows, int32_t n_cols,
                            const int32_t* I, const int32_t* J,
                            const double* V, int64_t* row_ptr, int32_t* col,
                            double* val) {
    int rc = bis_coo_to_csr(nnz, n_rows, n_cols, I, J, V, row_ptr, col, val);
    if (rc == -1) return -1;
    if (rc == 0) return nnz;               // no duplicates: already done
    int64_t w = 0;
    int64_t read = 0;
    for (int32_t i = 0; i < n_rows; ++i) {
        const int64_t e = row_ptr[i + 1];
        const int64_t row_start = w;
        while (read < e) {
            int32_t c = col[read];
            double s = val[read];
            ++read;
            while (read < e && col[read] == c) { s += val[read]; ++read; }
            col[w] = c;
            val[w] = s;
            ++w;
        }
        // safe: row i's old end (row_ptr[i+1]) was read before this and
        // row_ptr[i] is not consulted again
        row_ptr[i] = row_start;
    }
    row_ptr[n_rows] = w;
    return w;
}

// ---------------------------------------------------------------------------
// L/U split: one counting pass + one fill pass producing all four parts
// (split_LU_new analog, the reference's utilities/LU_factors.hpp:122-309).
// Outputs: L (lower+diag), Ls (strict lower), U (upper+diag), Us (strict
// upper).  Caller sizes col/val arrays from the returned row_ptrs after
// calling bis_split_lu_count.
// ---------------------------------------------------------------------------
void bis_split_lu_count(int32_t n_rows, const int64_t* row_ptr,
                        const int32_t* col,
                        int64_t* L_ptr, int64_t* Ls_ptr,
                        int64_t* U_ptr, int64_t* Us_ptr) {
    int64_t nL = 0, nLs = 0, nU = 0, nUs = 0;
    L_ptr[0] = Ls_ptr[0] = U_ptr[0] = Us_ptr[0] = 0;
    for (int32_t i = 0; i < n_rows; ++i) {
        for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
            int32_t j = col[k];
            if (j <= i) ++nL;
            if (j < i) ++nLs;
            if (j >= i) ++nU;
            if (j > i) ++nUs;
        }
        L_ptr[i + 1] = nL;
        Ls_ptr[i + 1] = nLs;
        U_ptr[i + 1] = nU;
        Us_ptr[i + 1] = nUs;
    }
}

void bis_split_lu_fill(int32_t n_rows, const int64_t* row_ptr,
                       const int32_t* col, const double* val,
                       const int64_t* L_ptr, int32_t* L_col, double* L_val,
                       const int64_t* Ls_ptr, int32_t* Ls_col, double* Ls_val,
                       const int64_t* U_ptr, int32_t* U_col, double* U_val,
                       const int64_t* Us_ptr, int32_t* Us_col, double* Us_val) {
    for (int32_t i = 0; i < n_rows; ++i) {
        int64_t pL = L_ptr[i], pLs = Ls_ptr[i], pU = U_ptr[i], pUs = Us_ptr[i];
        for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
            int32_t j = col[k];
            double v = val[k];
            if (j <= i) { L_col[pL] = j; L_val[pL] = v; ++pL; }
            if (j < i)  { Ls_col[pLs] = j; Ls_val[pLs] = v; ++pLs; }
            if (j >= i) { U_col[pU] = j; U_val[pU] = v; ++pU; }
            if (j > i)  { Us_col[pUs] = j; Us_val[pUs] = v; ++pUs; }
        }
    }
}

// ---------------------------------------------------------------------------
// Diagonal peel (peel_diag_crs analog, LU_factors.hpp:783-878).  D[i] = 0
// when missing.  Returns 0, or a small error enum with the offending row
// written to *bad_row: -3 = missing diagonal, -4 = |diag| < zero_tol
// (checks enabled via flags bit0 = check_missing, bit1 = check_zero).
// Non-overlapping encodings — row-in-return-code schemes collide once the
// row index crosses the next code's base.
// ---------------------------------------------------------------------------
long long bis_peel_diag(int32_t n_rows, const int64_t* row_ptr,
                        const int32_t* col, const double* val,
                        double zero_tol, int flags, double* D,
                        int64_t* bad_row) {
    *bad_row = -1;
    for (int32_t i = 0; i < n_rows; ++i) {
        double d = 0.0;
        int found = 0;
        for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
            if (col[k] == i) { d = val[k]; found = 1; break; }
        }
        if (!found && (flags & 1)) { *bad_row = i; return -3; }
        if (found && (flags & 2) && std::fabs(d) < zero_tol) {
            *bad_row = i;
            return -4;
        }
        D[i] = d;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// ILU(0): row-wise IKJ elimination restricted to A's pattern, with the
// reference's pivot guards (LU_factors.hpp:337-430,602,639-642):
//   * skip elimination pivots with |U(k,k)| < 1e-16
//   * replace final diagonals with |d| < pivot_tol by sign(d)*pivot_rep
// lu_val is A.val copied by the caller; modified in place.  w_pos is an
// n_cols scratch the caller allocates (int64, initialized here).
// Returns 0 or -(1000+i) for a missing diagonal in row i.
// ---------------------------------------------------------------------------
long long bis_ilu0(int32_t n_rows, int32_t n_cols, const int64_t* row_ptr,
                   const int32_t* col, double* lu_val,
                   double pivot_tol, double pivot_rep) {
    std::vector<int64_t> diag_pos((size_t)n_rows, -1);
    for (int32_t i = 0; i < n_rows; ++i)
        for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k)
            if (col[k] == i) { diag_pos[(size_t)i] = k; break; }
    for (int32_t i = 0; i < n_rows; ++i)
        if (diag_pos[(size_t)i] < 0) return -(1000LL + i);

    std::vector<int64_t> w_pos((size_t)n_cols, -1);
    for (int32_t i = 0; i < n_rows; ++i) {
        int64_t s = row_ptr[i], e = row_ptr[i + 1];
        for (int64_t k = s; k < e; ++k) w_pos[(size_t)col[k]] = k;
        for (int64_t p = s; p < e; ++p) {
            int32_t k = col[p];
            if (k >= i) break;
            double pivot = lu_val[diag_pos[(size_t)k]];
            if (std::fabs(pivot) < 1e-16) continue;
            double factor = lu_val[p] / pivot;
            lu_val[p] = factor;
            for (int64_t q = diag_pos[(size_t)k] + 1; q < row_ptr[k + 1]; ++q) {
                int64_t tgt = w_pos[(size_t)col[q]];
                if (tgt >= 0) lu_val[tgt] -= factor * lu_val[q];
            }
        }
        double d = lu_val[diag_pos[(size_t)i]];
        if (std::fabs(d) < pivot_tol)
            lu_val[diag_pos[(size_t)i]] = (d >= 0.0 ? 1.0 : -1.0) * pivot_rep;
        for (int64_t k = s; k < e; ++k) w_pos[(size_t)col[k]] = -1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Level sets for triangular solves (the SMAX level-scheduler analog,
// LU_factors.hpp:559-569): level[i] = 1 + max over the row's strict pattern.
// upper=1 walks rows N-1..0 (backward substitution dependencies).
// ---------------------------------------------------------------------------
void bis_level_sets(int32_t n_rows, const int64_t* row_ptr,
                    const int32_t* col, int upper, int32_t* level) {
    if (!upper) {
        for (int32_t i = 0; i < n_rows; ++i) {
            int32_t lv = -1;
            for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
                int32_t lj = level[col[k]];
                if (lj > lv) lv = lj;
            }
            level[i] = lv + 1;
        }
    } else {
        for (int32_t i = n_rows - 1; i >= 0; --i) {
            int32_t lv = -1;
            for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
                int32_t lj = level[col[k]];
                if (lj > lv) lv = lj;
            }
            level[i] = lv + 1;
        }
    }
}

// ---------------------------------------------------------------------------
// BFS / RCM orderings (the SMAX permute_mat analog,
// the reference's utilities/smax_helpers.hpp:44-80 + PERM_MODE,
// CMakeLists.txt:128-136).  Reordering shrinks triangular-solve level counts
// (wavefront depth), which is what makes the exact SpTRSV scan practical on
// the device.  perm[new_index] = old_index.  Pattern is taken as given (callers pass
// A whose pattern is structurally symmetric for the matrices of interest;
// unreached components are appended in natural order).
// reverse=1 gives RCM (Cuthill-McKee reversed); sort_by_degree=1 orders each
// BFS frontier by ascending degree (the CM rule).
// ---------------------------------------------------------------------------
void bis_bfs_perm(int32_t n_rows, const int64_t* row_ptr, const int32_t* col,
                  int reverse, int sort_by_degree, int32_t* perm) {
    std::vector<unsigned char> seen((size_t)n_rows, 0);
    std::vector<int32_t> queue;
    queue.reserve((size_t)n_rows);
    std::vector<int32_t> nbrs;
    long long head = 0;
    for (int32_t start = 0; start < n_rows; ++start) {
        if (seen[(size_t)start]) continue;
        // component seed: lowest-degree unseen node scan is O(n^2) worst
        // case; use the natural-order seed (matches simple BFS modes).
        seen[(size_t)start] = 1;
        queue.push_back(start);
        while (head < (long long)queue.size()) {
            int32_t u = queue[(size_t)head++];
            nbrs.clear();
            for (int64_t k = row_ptr[u]; k < row_ptr[u + 1]; ++k) {
                int32_t v = col[k];
                if (v >= 0 && v < n_rows && !seen[(size_t)v]) {
                    seen[(size_t)v] = 1;
                    nbrs.push_back(v);
                }
            }
            if (sort_by_degree) {
                // insertion sort by degree (frontiers are small)
                for (size_t a = 1; a < nbrs.size(); ++a) {
                    int32_t x = nbrs[a];
                    int64_t dx = row_ptr[x + 1] - row_ptr[x];
                    size_t b = a;
                    while (b > 0) {
                        int32_t y = nbrs[b - 1];
                        if (row_ptr[y + 1] - row_ptr[y] <= dx) break;
                        nbrs[b] = y;
                        --b;
                    }
                    nbrs[b] = x;
                }
            }
            for (int32_t v : nbrs) queue.push_back(v);
        }
    }
    if (reverse) {
        for (int32_t i = 0; i < n_rows; ++i)
            perm[i] = queue[(size_t)(n_rows - 1 - i)];
    } else {
        for (int32_t i = 0; i < n_rows; ++i) perm[i] = queue[(size_t)i];
    }
}

// ---------------------------------------------------------------------------
// Greedy graph coloring (the SMAX C/PC/PC_BAL permutation-mode analog,
// the reference's utilities/smax_helpers.hpp:25-28, CMakeLists.txt:128-136).
// Sequential first-fit over the CSR row pattern (assumed structurally
// symmetric, like bis_bfs_perm); balanced=1 picks the least-loaded
// admissible color (PC_BAL).  Returns the number of colors used.
// A proper coloring makes rows of one color mutually independent, so exact
// GS sweeps/triangular solves become #colors parallel steps.
// ---------------------------------------------------------------------------
long long bis_greedy_color(int32_t n_rows, const int64_t* row_ptr,
                           const int32_t* col, int balanced,
                           int32_t* colors) {
    for (int32_t i = 0; i < n_rows; ++i) colors[i] = -1;
    std::vector<int32_t> mark;   // mark[c] == i  <=>  color c used by a nbr
    std::vector<int64_t> load;   // rows per color (balanced mode)
    for (int32_t i = 0; i < n_rows; ++i) {
        for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
            int32_t j = col[k];
            if (j == i || j < 0 || j >= n_rows) continue;
            int32_t cj = colors[j];
            if (cj >= 0) mark[(size_t)cj] = i;
        }
        int32_t c = -1;
        if (balanced) {
            int64_t best_load = -1;
            for (size_t cc = 0; cc < load.size(); ++cc) {
                if (mark[cc] != i && (best_load < 0 || load[cc] < best_load)) {
                    c = (int32_t)cc;
                    best_load = load[cc];
                }
            }
        } else {
            for (size_t cc = 0; cc < load.size(); ++cc)
                if (mark[cc] != i) { c = (int32_t)cc; break; }
        }
        if (c < 0) {
            c = (int32_t)load.size();
            mark.push_back(-1);
            load.push_back(0);
        }
        colors[i] = c;
        ++load[(size_t)c];
    }
    return (long long)load.size();
}

// ---------------------------------------------------------------------------
// Symmetric permutation A' = P A P^T with column-sorted rows:
// A'[new_i, inv[j]] = A[perm[new_i], j].
// ---------------------------------------------------------------------------
void bis_permute_csr(int32_t n_rows, const int64_t* row_ptr,
                     const int32_t* col, const double* val,
                     const int32_t* perm, const int32_t* inv_perm,
                     int64_t* out_ptr, int32_t* out_col, double* out_val) {
    out_ptr[0] = 0;
    for (int32_t ni = 0; ni < n_rows; ++ni) {
        int32_t oi = perm[ni];
        out_ptr[ni + 1] = out_ptr[ni] + (row_ptr[oi + 1] - row_ptr[oi]);
    }
    std::vector<std::pair<int32_t, double>> row;
    for (int32_t ni = 0; ni < n_rows; ++ni) {
        int32_t oi = perm[ni];
        row.clear();
        for (int64_t k = row_ptr[oi]; k < row_ptr[oi + 1]; ++k)
            row.emplace_back(inv_perm[col[k]], val[k]);
        // insertion sort by new column (rows are short)
        for (size_t a = 1; a < row.size(); ++a) {
            auto x = row[a];
            size_t b = a;
            while (b > 0 && row[b - 1].first > x.first) {
                row[b] = row[b - 1];
                --b;
            }
            row[b] = x;
        }
        int64_t o = out_ptr[ni];
        for (size_t a = 0; a < row.size(); ++a) {
            out_col[o + (int64_t)a] = row[a].first;
            out_val[o + (int64_t)a] = row[a].second;
        }
    }
}

// ---------------------------------------------------------------------------
// Fused symmetric permutation + in-pattern ILU(0): emits the color-permuted
// CSR pattern (out_ptr/out_col) and the FACTORED values (lu_val) in one
// sweep over the natural-order matrix.  Output row r is row perm[r] of A
// with columns remapped through inv_perm and sorted; each row is eliminated
// in place the moment it is emitted (rows < r are already factored), so the
// separate permute pass, the Python-side value copy and the second
// full-matrix factor read of the bis_permute_csr -> bis_ilu0 pipeline all
// collapse into this single pass — the dominant set-up cost on a
// slow host (the colored-ILU(0) path of precond.setup_preconditioner).
// Arithmetic is identical to bis_permute_csr followed by bis_ilu0
// (the reference's elimination + pivot guards, LU_factors.hpp:337-430).
// Square matrices only.  Returns 0, or -(1000+r) for a missing diagonal in
// permuted row r (detected mid-stream; lu_val is garbage then).
// ---------------------------------------------------------------------------
long long bis_permute_factor_csr(int32_t n_rows, const int64_t* row_ptr,
                                 const int32_t* col, const double* val,
                                 const int32_t* perm, const int32_t* inv_perm,
                                 double pivot_tol, double pivot_rep,
                                 int64_t* out_ptr, int32_t* out_col,
                                 double* lu_val) {
    out_ptr[0] = 0;
    for (int32_t ni = 0; ni < n_rows; ++ni) {
        int32_t oi = perm[ni];
        out_ptr[ni + 1] = out_ptr[ni] + (row_ptr[oi + 1] - row_ptr[oi]);
    }
    std::vector<int64_t> diag_pos((size_t)n_rows);
    std::vector<int64_t> w_pos((size_t)n_rows, -1);
    std::vector<std::pair<int32_t, double>> row;
    for (int32_t ni = 0; ni < n_rows; ++ni) {
        int32_t oi = perm[ni];
        row.clear();
        for (int64_t k = row_ptr[oi]; k < row_ptr[oi + 1]; ++k)
            row.emplace_back(inv_perm[col[k]], val[k]);
        // insertion sort by new column (rows are short)
        for (size_t a = 1; a < row.size(); ++a) {
            auto x = row[a];
            size_t b = a;
            while (b > 0 && row[b - 1].first > x.first) {
                row[b] = row[b - 1];
                --b;
            }
            row[b] = x;
        }
        int64_t s = out_ptr[ni], e = s + (int64_t)row.size();
        int64_t dp = -1;
        for (size_t a = 0; a < row.size(); ++a) {
            out_col[s + (int64_t)a] = row[a].first;
            lu_val[s + (int64_t)a] = row[a].second;
            if (row[a].first == ni) dp = s + (int64_t)a;
        }
        if (dp < 0) return -(1000LL + ni);
        diag_pos[(size_t)ni] = dp;
        for (int64_t k = s; k < e; ++k) w_pos[(size_t)out_col[k]] = k;
        for (int64_t p = s; p < e; ++p) {
            int32_t k = out_col[p];
            if (k >= ni) break;
            double pivot = lu_val[diag_pos[(size_t)k]];
            if (std::fabs(pivot) < 1e-16) continue;
            double factor = lu_val[p] / pivot;
            lu_val[p] = factor;
            for (int64_t q = diag_pos[(size_t)k] + 1; q < out_ptr[k + 1];
                 ++q) {
                int64_t tgt = w_pos[(size_t)out_col[q]];
                if (tgt >= 0) lu_val[tgt] -= factor * lu_val[q];
            }
        }
        double d = lu_val[dp];
        if (std::fabs(d) < pivot_tol)
            lu_val[dp] = (d >= 0.0 ? 1.0 : -1.0) * pivot_rep;
        for (int64_t k = s; k < e; ++k) w_pos[(size_t)out_col[k]] = -1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// One-pass CSR pattern statistics for device-format selection
// (device_matrix.auto_format_choice / ops/lane_ell.py builders — these were
// multi-pass NumPy sweeps over nnz-sized index arrays, the dominant setup
// cost for general matrices on a slow host).
//   stats[0] = number of distinct diagonal offsets, or -1 if > cap
//   stats[1] = lane-window span  max |col/128 - row/128|
//   stats[2] = 1 iff every row's columns are strictly ascending
// offs_out (size >= cap) receives the sorted distinct offsets when
// stats[0] >= 0.  Returns 0.
// ---------------------------------------------------------------------------
long long bis_csr_pattern_stats(int32_t n_rows, int32_t n_cols,
                                const int64_t* row_ptr, const int32_t* col,
                                int64_t cap, int64_t* offs_out,
                                int64_t* stats) {
    const int64_t span_off = (int64_t)n_rows - 1;   // offset -> bitmap slot
    std::vector<uint8_t> seen((size_t)(n_rows + n_cols - 1 > 0
                                       ? n_rows + n_cols - 1 : 1), 0);
    int64_t n_diags = 0, span = 0;
    int sorted_ok = 1;
    for (int32_t i = 0; i < n_rows; ++i) {
        int32_t prev = -1;
        const int64_t rb = (int64_t)i / 128;
        for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
            const int32_t c = col[k];
            if (c <= prev) sorted_ok = 0;
            prev = c;
            const int64_t slot = (int64_t)c - i + span_off;
            if (!seen[(size_t)slot]) { seen[(size_t)slot] = 1; ++n_diags; }
            int64_t ro = (int64_t)c / 128 - rb;
            if (ro < 0) ro = -ro;
            if (ro > span) span = ro;
        }
    }
    stats[1] = span;
    stats[2] = sorted_ok;
    if (n_diags > cap) { stats[0] = -1; return 0; }
    stats[0] = n_diags;
    int64_t w = 0;
    for (int64_t s = 0; s < (int64_t)seen.size(); ++s)
        if (seen[(size_t)s]) offs_out[w++] = s - span_off;
    return 0;
}

// ---------------------------------------------------------------------------
// Lane-ELL slot shift ranges: lo/hi[k] = min/max rowoff over the k-th
// entry (in ascending-column order) of every row.  Requires ascending
// columns (the CSR invariant) so the within-row (rowoff, lane) order IS the
// storage order — the NumPy builder's global lexsort disappears.  Returns
// 0, or -1 when a row has more than K entries or columns are not ascending
// (caller falls back to the NumPy path).
// ---------------------------------------------------------------------------
long long bis_lane_ell_ranges(int32_t n_rows, const int64_t* row_ptr,
                              const int32_t* col, int32_t K,
                              int32_t* lo, int32_t* hi) {
    for (int32_t k = 0; k < K; ++k) { lo[k] = INT32_MAX; hi[k] = INT32_MIN; }
    for (int32_t i = 0; i < n_rows; ++i) {
        const int64_t s = row_ptr[i], e = row_ptr[i + 1];
        if (e - s > K) return -1;
        int32_t prev = -1;
        const int32_t rb = i / 128;
        for (int64_t k = s; k < e; ++k) {
            const int32_t c = col[k];
            if (c <= prev) return -1;
            prev = c;
            const int32_t ro = c / 128 - rb;
            const int32_t kk = (int32_t)(k - s);
            if (ro < lo[kk]) lo[kk] = ro;
            if (ro > hi[kk]) hi[kk] = ro;
        }
    }
    for (int32_t k = 0; k < K; ++k)
        if (lo[k] == INT32_MAX) { lo[k] = 0; hi[k] = 0; }   // empty slot
    return 0;
}

// ---------------------------------------------------------------------------
// Lane-ELL plane pack: fill vals (f32/f64 by dtype32) and packed idx
// (K, R_pad, 128) planes in one sequential sweep — 128-row blocks buffered
// in cache, every plane element written exactly once (callers allocate
// with np.empty; no 1-GB calloc, no nnz-sized fancy scatter, no per-slot
// pad-fix passes).  Pad slots get idx (lo[k]+S)*128, matching the NumPy
// builder bit for bit (including its idx==0 real-zero-entry corner).
// Assumes ascending columns (checked by bis_lane_ell_ranges first).
// ---------------------------------------------------------------------------
void bis_lane_ell_pack(int32_t n_rows, const int64_t* row_ptr,
                       const int32_t* col, const double* val,
                       int32_t K, int32_t S, int64_t R_pad,
                       const int32_t* lo, int dtype32,
                       void* vals_out, int32_t* idx_out) {
    float* vf = (float*)vals_out;
    double* vd = (double*)vals_out;
    std::vector<double> bufv((size_t)K * 128);
    std::vector<int32_t> bufi((size_t)K * 128);
    const int64_t plane = R_pad * 128;
    for (int64_t r2 = 0; r2 < R_pad; ++r2) {
        for (int32_t l = 0; l < 128; ++l) {
            const int64_t i = r2 * 128 + l;
            int64_t nz = 0, s = 0;
            if (i < (int64_t)n_rows) {
                s = row_ptr[i];
                nz = row_ptr[i + 1] - s;
            }
            const int32_t rb = (int32_t)(i / 128);
            for (int64_t k = 0; k < nz; ++k) {
                const int32_t c = col[s + k];
                const double v = val[s + k];
                int32_t pk = (c / 128 - rb + S) * 128 + (c % 128);
                if (v == 0.0 && pk == 0)        // NumPy pad-fix corner
                    pk = (lo[k] + S) * 128;
                bufv[(size_t)(k * 128 + l)] = v;
                bufi[(size_t)(k * 128 + l)] = pk;
            }
            for (int64_t k = nz; k < (int64_t)K; ++k) {
                bufv[(size_t)(k * 128 + l)] = 0.0;
                bufi[(size_t)(k * 128 + l)] = (lo[k] + S) * 128;
            }
        }
        for (int32_t k = 0; k < K; ++k) {
            const int64_t dst = (int64_t)k * plane + r2 * 128;
            if (dtype32)
                for (int32_t l = 0; l < 128; ++l)
                    vf[dst + l] = (float)bufv[(size_t)(k * 128 + l)];
            else
                std::memcpy(vd + dst, bufv.data() + (size_t)k * 128,
                            128 * sizeof(double));
            std::memcpy(idx_out + dst, bufi.data() + (size_t)k * 128,
                        128 * sizeof(int32_t));
        }
    }
}

// ---------------------------------------------------------------------------
// Padded-row ELL pack (the XLA-gather fallback format): cols/data are
// (n_rows, K) row-major, pre-zeroed by the caller; one sequential sweep.
// ---------------------------------------------------------------------------
void bis_csr_to_ell_pack(int32_t n_rows, const int64_t* row_ptr,
                         const int32_t* col, const double* val,
                         int64_t K, int dtype32, int32_t* cols_out,
                         void* data_out) {
    float* df = (float*)data_out;
    double* dd = (double*)data_out;
    for (int32_t i = 0; i < n_rows; ++i) {
        const int64_t s = row_ptr[i], e = row_ptr[i + 1];
        const int64_t base = (int64_t)i * K;
        for (int64_t k = s; k < e; ++k) {
            cols_out[base + (k - s)] = col[k];
            if (dtype32) df[base + (k - s)] = (float)val[k];
            else dd[base + (k - s)] = val[k];
        }
    }
}

// ---------------------------------------------------------------------------
// DIA pack: data[d, i] = A[i, i + offsets[d]] in one sweep over the CSR
// (device_matrix.csr_to_dia's repeat/searchsorted/fancy-scatter NumPy
// passes).  `offsets` sorted ascending (from bis_csr_pattern_stats);
// per-entry diagonal index by binary search (n_diags is small — DIA is
// only chosen under ~100 diagonals).  data_out is (n_diags, npad),
// pre-zeroed by the caller.
// ---------------------------------------------------------------------------
void bis_csr_to_dia_pack(int32_t n_rows, const int64_t* row_ptr,
                         const int32_t* col, const double* val,
                         const int64_t* offsets, int64_t n_diags,
                         int64_t npad, int dtype32, void* data_out) {
    float* df = (float*)data_out;
    double* dd = (double*)data_out;
    for (int32_t i = 0; i < n_rows; ++i) {
        for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
            const int64_t off = (int64_t)col[k] - i;
            int64_t lo = 0, hi = n_diags - 1, d = 0;
            while (lo <= hi) {
                const int64_t mid = (lo + hi) >> 1;
                if (offsets[mid] < off) lo = mid + 1;
                else if (offsets[mid] > off) hi = mid - 1;
                else { d = mid; break; }
            }
            if (dtype32) df[d * npad + i] = (float)val[k];
            else dd[d * npad + i] = val[k];
        }
    }
}

// ---------------------------------------------------------------------------
// HPCG 27-point stencil CSR generator (the benchmark family's matrix,
// the reference's README.md:3-6 figures; row-equivalent to
// generators.stencil_27pt, which is the NumPy oracle).  Columns come out
// ascending because the (dz, dy, dx)-ascending neighbor order is ascending
// in linear offset.  nnz = (3nx-2)(3ny-2)(3nz-2) — caller allocates.
// ---------------------------------------------------------------------------
void bis_hpcg_csr(int32_t nx, int32_t ny, int32_t nz, double diag, double off,
                  int64_t* row_ptr, int32_t* col, double* val) {
    int64_t pos = 0;
    row_ptr[0] = 0;
    int64_t i = 0;
    for (int32_t z = 0; z < nz; ++z)
        for (int32_t y = 0; y < ny; ++y)
            for (int32_t x = 0; x < nx; ++x, ++i) {
                for (int32_t dz = -1; dz <= 1; ++dz) {
                    int32_t zn = z + dz;
                    if (zn < 0 || zn >= nz) continue;
                    for (int32_t dy = -1; dy <= 1; ++dy) {
                        int32_t yn = y + dy;
                        if (yn < 0 || yn >= ny) continue;
                        for (int32_t dx = -1; dx <= 1; ++dx) {
                            int32_t xn = x + dx;
                            if (xn < 0 || xn >= nx) continue;
                            col[pos] = (int32_t)(i + dx
                                                 + (int64_t)nx * (dy + (int64_t)ny * dz));
                            val[pos] = (dx == 0 && dy == 0 && dz == 0)
                                           ? diag : off;
                            ++pos;
                        }
                    }
                }
                row_ptr[i + 1] = pos;
            }
}

// ---------------------------------------------------------------------------
// Colored-ILU(0) triplet expansion: permuted CSR (Ap, factored values) →
// original-ordering (rows_o, cols_o) int32 triplets + peeled diagonal, one
// pass (replaces three 55M-entry NumPy gather passes on a slow
// host; factor.factor_ilu0_colored_triplets).
// ---------------------------------------------------------------------------
void bis_expand_perm_triplets(int32_t n, const int64_t* row_ptr,
                              const int32_t* col, const double* lu_val,
                              const int32_t* perm,
                              int32_t* rows_o, int32_t* cols_o, double* U_D) {
    for (int32_t i = 0; i < n; ++i) {
        int32_t oi = perm[i];
        for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
            int32_t oc = perm[col[k]];
            rows_o[k] = oi;
            cols_o[k] = oc;
            if (oc == oi) U_D[oi] = lu_val[k];
        }
    }
}

// ---------------------------------------------------------------------------
// Superblock trisolve packing (ops/block_trisolve.build_superblock_trisolve
// fast path).  Grid colorings only: per-entry colors / superblocks / slots
// are pure arithmetic on grid coordinates, so BOTH triangles are analyzed
// in one pass with zero intermediate arrays (the NumPy path materializes
// ~10 full-nnz temporaries on a ~0.2 GB/s host).
//
// bis_sb_analyze: discover the (sb_i, sb_j, Δ) cross groups and (sb_i, dx)
// self groups of the color-lower and color-upper triangles.  Key encodings
// match the NumPy builder:
//   cross: (sb_i·S + sb_j)·(2m+1) + (Δ + m)
//   self:  sb_i·257 + (dx + 128)
// Outputs 4 ascending key lists (caps checked); error codes:
//   -10 improper coloring   -11 same-superblock coupling beyond x
//   -12 self reach >= min(nx, 128)   -13 more than `cap` groups
// ---------------------------------------------------------------------------
namespace {
struct KeySet {
    // open-address hash of int64 keys, capacity fixed (G is tiny)
    static const int CAP = 4096;
    int64_t slots[CAP];
    int count;
    KeySet() : count(0) { for (int i = 0; i < CAP; ++i) slots[i] = -1; }
    // returns false on overflow
    bool insert(int64_t key, int limit) {
        size_t h = ((size_t)key * 0x9E3779B97F4A7C15ull) & (CAP - 1);
        while (slots[h] != -1) {
            if (slots[h] == key) return true;
            h = (h + 1) & (CAP - 1);
        }
        if (count >= limit || count >= CAP / 2) return false;
        slots[h] = key;
        ++count;
        return true;
    }
    // true iff present
    bool find(int64_t key) const {
        size_t h = ((size_t)key * 0x9E3779B97F4A7C15ull) & (CAP - 1);
        while (slots[h] != -1) {
            if (slots[h] == key) return true;
            h = (h + 1) & (CAP - 1);
        }
        return false;
    }
};

inline void sb_coords(int32_t r, int32_t nx, int32_t ny,
                      int32_t* x, int32_t* y, int32_t* z) {
    *x = r % nx;
    *y = (r / nx) % ny;
    *z = r / (nx * ny);
}
}  // namespace

long long bis_sb_analyze(long long nnz, const int32_t* rows,
                         const int32_t* cols,
                         int32_t nx, int32_t ny, int32_t nz,
                         int32_t sx, int32_t sy, int32_t sz,
                         long long cap,
                         int64_t* ukc_lo, int64_t* uks_lo,
                         int64_t* ukc_up, int64_t* uks_up,
                         long long* counts /*4: c_lo, s_lo, c_up, s_up*/) {
    const int32_t LANES = 128;
    int32_t my = ny / sy, mz = nz / sz;
    int64_t m = (int64_t)nx * my * mz;
    int64_t span = 2 * m + 1;
    int32_t S = sy * sz;
    int32_t xmax = nx < LANES ? nx : LANES;
    KeySet* sets = new KeySet[4];  // c_lo, s_lo, c_up, s_up
    long long rc = 0;
    for (long long k = 0; k < nnz; ++k) {
        int32_t r = rows[k], c = cols[k];
        if (r == c) continue;
        int32_t xr, yr, zr, xc, yc, zc;
        sb_coords(r, nx, ny, &xr, &yr, &zr);
        sb_coords(c, nx, ny, &xc, &yc, &zc);
        int32_t cr = (xr % sx) + sx * ((yr % sy) + sy * (zr % sz));
        int32_t cc = (xc % sx) + sx * ((yc % sy) + sy * (zc % sz));
        if (cr == cc) { rc = -10; break; }
        int lower = cc < cr;
        int32_t sbr = (yr % sy) + sy * (zr % sz);
        int32_t sbc = (yc % sy) + sy * (zc % sz);
        if (sbr == sbc) {
            if (yr != yc || zr != zc) { rc = -11; break; }
            int32_t dx = xc - xr;
            if ((dx < 0 ? -dx : dx) >= xmax) { rc = -12; break; }
            int64_t key = (int64_t)sbr * (2 * LANES + 1) + (dx + LANES);
            if (!sets[lower ? 1 : 3].insert(key, (int)cap)) { rc = -13; break; }
        } else {
            int64_t slot_r = xr + (int64_t)nx * ((yr / sy) + (int64_t)my * (zr / sz));
            int64_t slot_c = xc + (int64_t)nx * ((yc / sy) + (int64_t)my * (zc / sz));
            int64_t key = ((int64_t)sbr * S + sbc) * span + (slot_c - slot_r + m);
            if (!sets[lower ? 0 : 2].insert(key, (int)cap)) { rc = -13; break; }
        }
    }
    if (rc == 0) {
        int64_t* outs[4] = {ukc_lo, uks_lo, ukc_up, uks_up};
        for (int s = 0; s < 4; ++s) {
            int cnt = 0;
            for (int i = 0; i < KeySet::CAP; ++i)
                if (sets[s].slots[i] != -1) outs[s][cnt++] = sets[s].slots[i];
            counts[s] = cnt;
            // insertion sort (tiny)
            for (int a = 1; a < cnt; ++a) {
                int64_t x = outs[s][a];
                int b = a;
                while (b > 0 && outs[s][b - 1] > x) {
                    outs[s][b] = outs[s][b - 1];
                    --b;
                }
                outs[s][b] = x;
            }
        }
    }
    delete[] sets;
    return rc;
}

// ---------------------------------------------------------------------------
// CSR-direct variants: analyze/scatter straight off a color-PERMUTED CSR
// (row i of Ap = original row perm[i]) without materializing the
// original-ordering triplets at all — the colored-ILU(0) superblock setup
// then runs in two passes over Ap (a slow host makes every avoided
// full-nnz array worth seconds).  bis_sb_scatter_csr fills BOTH triangles'
// planes plus the peeled diagonal in its single pass.
// ---------------------------------------------------------------------------
long long bis_sb_analyze_csr(int32_t n, const int64_t* row_ptr,
                             const int32_t* col, const int32_t* perm,
                             int32_t nx, int32_t ny, int32_t nz,
                             int32_t sx, int32_t sy, int32_t sz,
                             long long cap,
                             int64_t* ukc_lo, int64_t* uks_lo,
                             int64_t* ukc_up, int64_t* uks_up,
                             long long* counts) {
    const int32_t LANES = 128;
    int32_t my = ny / sy, mz = nz / sz;
    int64_t m = (int64_t)nx * my * mz;
    int64_t span = 2 * m + 1;
    int32_t S = sy * sz;
    int32_t xmax = nx < LANES ? nx : LANES;
    KeySet* sets = new KeySet[4];
    long long rc = 0;
    for (int32_t pi = 0; pi < n && rc == 0; ++pi) {
        int32_t r = perm[pi];
        int32_t xr, yr, zr;
        sb_coords(r, nx, ny, &xr, &yr, &zr);
        int32_t cr = (xr % sx) + sx * ((yr % sy) + sy * (zr % sz));
        int32_t sbr = (yr % sy) + sy * (zr % sz);
        int64_t slot_r = xr + (int64_t)nx * ((yr / sy) + (int64_t)my * (zr / sz));
        for (int64_t k = row_ptr[pi]; k < row_ptr[pi + 1]; ++k) {
            int32_t c = perm[col[k]];
            if (r == c) continue;
            int32_t xc, yc, zc;
            sb_coords(c, nx, ny, &xc, &yc, &zc);
            int32_t cc = (xc % sx) + sx * ((yc % sy) + sy * (zc % sz));
            if (cr == cc) { rc = -10; break; }
            int lower = cc < cr;
            int32_t sbc = (yc % sy) + sy * (zc % sz);
            if (sbr == sbc) {
                if (yr != yc || zr != zc) { rc = -11; break; }
                int32_t dx = xc - xr;
                if ((dx < 0 ? -dx : dx) >= xmax) { rc = -12; break; }
                int64_t key = (int64_t)sbr * (2 * LANES + 1) + (dx + LANES);
                if (!sets[lower ? 1 : 3].insert(key, (int)cap)) {
                    rc = -13; break;
                }
            } else {
                int64_t slot_c = xc + (int64_t)nx * ((yc / sy)
                                                    + (int64_t)my * (zc / sz));
                int64_t key = ((int64_t)sbr * S + sbc) * span
                              + (slot_c - slot_r + m);
                if (!sets[lower ? 0 : 2].insert(key, (int)cap)) {
                    rc = -13; break;
                }
            }
        }
    }
    if (rc == 0) {
        int64_t* outs[4] = {ukc_lo, uks_lo, ukc_up, uks_up};
        for (int s = 0; s < 4; ++s) {
            int cnt = 0;
            for (int i = 0; i < KeySet::CAP; ++i)
                if (sets[s].slots[i] != -1) outs[s][cnt++] = sets[s].slots[i];
            counts[s] = cnt;
            for (int a = 1; a < cnt; ++a) {
                int64_t x = outs[s][a];
                int b = a;
                while (b > 0 && outs[s][b - 1] > x) {
                    outs[s][b] = outs[s][b - 1];
                    --b;
                }
                outs[s][b] = x;
            }
        }
    }
    delete[] sets;
    return rc;
}

long long bis_sb_scatter_csr(int32_t n, const int64_t* row_ptr,
                             const int32_t* col, const double* lu_val,
                             const int32_t* perm,
                             int32_t nx, int32_t ny, int32_t nz,
                             int32_t sx, int32_t sy, int32_t sz,
                             const int64_t* ukc_lo, int32_t Gc_lo,
                             const int64_t* uks_lo, int32_t Gs_lo,
                             const int64_t* ukc_up, int32_t Gc_up,
                             const int64_t* uks_up, int32_t Gs_up,
                             int64_t Rb128_lo, int64_t Rb128_up, int dtype32,
                             void* pc_lo, void* ps_lo,
                             void* pc_up, void* ps_up, double* U_D) {
    const int32_t LANES = 128;
    int32_t my = ny / sy, mz = nz / sz;
    int64_t m = (int64_t)nx * my * mz;
    int64_t span = 2 * m + 1;
    int32_t S = sy * sz;
    for (int32_t pi = 0; pi < n; ++pi) {
        int32_t r = perm[pi];
        int32_t xr, yr, zr;
        sb_coords(r, nx, ny, &xr, &yr, &zr);
        int32_t cr = (xr % sx) + sx * ((yr % sy) + sy * (zr % sz));
        int32_t sbr = (yr % sy) + sy * (zr % sz);
        int64_t slot_r = xr + (int64_t)nx * ((yr / sy) + (int64_t)my * (zr / sz));
        for (int64_t k = row_ptr[pi]; k < row_ptr[pi + 1]; ++k) {
            int32_t c = perm[col[k]];
            double v = lu_val[k];
            if (r == c) { U_D[r] = v; continue; }
            int32_t xc, yc, zc;
            sb_coords(c, nx, ny, &xc, &yc, &zc);
            int32_t cc = (xc % sx) + sx * ((yc % sy) + sy * (zc % sz));
            int lower = cc < cr;
            int32_t sbc = (yc % sy) + sy * (zc % sz);
            const int64_t* uk;
            int32_t G;
            void* planes;
            int64_t Rb128 = lower ? Rb128_lo : Rb128_up;
            int64_t key;
            if (sbr == sbc) {
                key = (int64_t)sbr * (2 * LANES + 1) + (xc - xr + LANES);
                uk = lower ? uks_lo : uks_up;
                G = lower ? Gs_lo : Gs_up;
                planes = lower ? ps_lo : ps_up;
            } else {
                int64_t slot_c = xc + (int64_t)nx * ((yc / sy)
                                                    + (int64_t)my * (zc / sz));
                key = ((int64_t)sbr * S + sbc) * span + (slot_c - slot_r + m);
                uk = lower ? ukc_lo : ukc_up;
                G = lower ? Gc_lo : Gc_up;
                planes = lower ? pc_lo : pc_up;
            }
            int32_t lo = 0, hi = G - 1, g = -1;
            while (lo <= hi) {
                int32_t mid = (lo + hi) >> 1;
                if (uk[mid] == key) { g = mid; break; }
                if (uk[mid] < key) lo = mid + 1; else hi = mid - 1;
            }
            if (g < 0) return -1;
            if (dtype32)
                ((float*)planes)[(int64_t)g * Rb128 + slot_r] = (float)v;
            else
                ((double*)planes)[(int64_t)g * Rb128 + slot_r] = v;
        }
    }
    return 0;
}

// Scatter one triangle's values into the group planes (rows in ukey order,
// which is the level/slab order): planes_*[g * Rb128 + slot(row)] = value.
// dtype32: 1 = float32 planes, 0 = float64.
long long bis_sb_scatter(long long nnz, const int32_t* rows,
                         const int32_t* cols, const double* vals,
                         int32_t nx, int32_t ny, int32_t nz,
                         int32_t sx, int32_t sy, int32_t sz,
                         int upper,
                         const int64_t* ukc, int32_t Gc,
                         const int64_t* uks, int32_t Gs,
                         int64_t Rb128, int dtype32,
                         void* planes_cross, void* planes_self) {
    const int32_t LANES = 128;
    int32_t my = ny / sy, mz = nz / sz;
    int64_t m = (int64_t)nx * my * mz;
    int64_t span = 2 * m + 1;
    int32_t S = sy * sz;
    float* pc32 = (float*)planes_cross;
    float* ps32 = (float*)planes_self;
    double* pc64 = (double*)planes_cross;
    double* ps64 = (double*)planes_self;
    for (long long k = 0; k < nnz; ++k) {
        int32_t r = rows[k], c = cols[k];
        if (r == c) continue;
        int32_t xr, yr, zr, xc, yc, zc;
        sb_coords(r, nx, ny, &xr, &yr, &zr);
        sb_coords(c, nx, ny, &xc, &yc, &zc);
        int32_t cr = (xr % sx) + sx * ((yr % sy) + sy * (zr % sz));
        int32_t cc = (xc % sx) + sx * ((yc % sy) + sy * (zc % sz));
        int lower = cc < cr;
        if (lower == upper) continue;
        int32_t sbr = (yr % sy) + sy * (zr % sz);
        int64_t slot_r = xr + (int64_t)nx * ((yr / sy) + (int64_t)my * (zr / sz));
        if (sbr == ((yc % sy) + sy * (zc % sz))) {
            int64_t key = (int64_t)sbr * (2 * LANES + 1) + (xc - xr + LANES);
            // binary search (G <= ~hundreds)
            int32_t lo = 0, hi = Gs - 1, g = -1;
            while (lo <= hi) {
                int32_t mid = (lo + hi) >> 1;
                if (uks[mid] == key) { g = mid; break; }
                if (uks[mid] < key) lo = mid + 1; else hi = mid - 1;
            }
            if (g < 0) return -1;
            if (dtype32) ps32[(int64_t)g * Rb128 + slot_r] = (float)vals[k];
            else         ps64[(int64_t)g * Rb128 + slot_r] = vals[k];
        } else {
            int32_t sbc = (yc % sy) + sy * (zc % sz);
            int64_t slot_c = xc + (int64_t)nx * ((yc / sy) + (int64_t)my * (zc / sz));
            int64_t key = ((int64_t)sbr * S + sbc) * span + (slot_c - slot_r + m);
            int32_t lo = 0, hi = Gc - 1, g = -1;
            while (lo <= hi) {
                int32_t mid = (lo + hi) >> 1;
                if (ukc[mid] == key) { g = mid; break; }
                if (ukc[mid] < key) lo = mid + 1; else hi = mid - 1;
            }
            if (g < 0) return -1;
            if (dtype32) pc32[(int64_t)g * Rb128 + slot_r] = (float)vals[k];
            else         pc64[(int64_t)g * Rb128 + slot_r] = vals[k];
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// CSR SpMV host oracle (native_spmv analog, the reference's kernels.hpp:22-42)
// — used for explicit final residuals on host matrices.
// ---------------------------------------------------------------------------
void bis_spmv_csr(int32_t n_rows, const int64_t* row_ptr, const int32_t* col,
                  const double* val, const double* x, double* y) {
    for (int32_t i = 0; i < n_rows; ++i) {
        double acc = 0.0;
        for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k)
            acc += val[k] * x[col[k]];
        y[i] = acc;
    }
}

}  // extern "C"
