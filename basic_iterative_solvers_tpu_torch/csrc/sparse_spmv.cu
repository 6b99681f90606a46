// SpMV on the stored sparse formats, for Hopper (sm_90a): DIA and
// lane-ELL.
//
// dia_spmv_kernel replaces the Pallas kernel dia_pallas_core (body
// _dia_kernel) of basic_iterative_solvers_tpu/ops/pallas_spmv.py:
//
//     y[i] = sum_d data[d*n + i] * x[i + off_d]      (x read as 0 outside)
//
// lane_ell_spmv_kernel replaces _lane_ell_kernel_call of
// basic_iterative_solvers_tpu/ops/lane_ell.py: row i = 128*r + l owns slot
// k at vals[k*R*128 + i] and the packed index p = idx[k*R*128 + i] =
// (rowoff + S)*128 + lane, its column j = (r + p/128 - S)*128 + p%128;
//
//     y[i] = sum_k vals[k, i] * x[j]                  (j clipped to the
//                                                       planes, x 0 past n)
//
// The plain forms are ops/dia_spmv.dia_spmv_plain and
// ops/lane_ell.lane_ell_spmv_plain.  One thread per row.  The TPU kernels
// keep a window of x in VMEM (two row tiles for DIA, three for lane-ELL)
// and group diagonals by lane residue or gather within 128-lane registers;
// on the card neighbouring threads read neighbouring entries of data/vals
// and of x (DIA) or of the idx planes, so the loads coalesce and x's reuse
// comes from L1/L2: no window, no lane gathers, no slot ranges.  Terms are
// added in the plain version's order (ascending offset, ascending slot),
// each product and sum rounded alone (__fmul_rn, __fadd_rn: no fused
// multiply-add), and an out-of-range x reads 0 as the plain version's zero
// padding does, so kernel and plain agree bit for bit.
//
// What bounds them: bytes.  DIA reads k*n values plus x and writes y (x
// from L2 after the first diagonal).  Each thread's loop is a load, a
// multiply and an add per term.
//
// Lane-ELL pads every row to K slots (the longest row's), and the pad
// slots are bytes with no work in them: on sband:500000,8,400 the real
// entries fill 48% of the K*n slots.  So lane_ell_spmv_kernel stops each
// row at its count of real slots, row_len[i] (one plus the row's last
// nonzero-valued slot, built once at set-up from the planes): a warp
// fetches a slot plane's sectors only where one of its 32 rows still
// needs that slot.  Its indices come from a 16-bit copy of the packed
// index plane where they fit ((2S + 1)*128 <= 65535, I = unsigned short:
// half the index bytes), else from the int32 plane (I = int); the counts
// are bytes where K <= 255 (C = unsigned char), else int32.  A skipped
// slot holds value 0: its product is +-0, and adding +-0 to an
// accumulator that starts at +0 changes no bit (a round-to-nearest sum of
// nonzero terms is never -0), so y stays bit-equal to the plain version
// for finite x.  Only a NaN or +-Inf in x at a skipped slot's column,
// which the plain version and the JAX kernel carry into y as 0*Inf, does
// not reach y here.
//
// Matrix data in bfloat16 (the JAX package's --matrix-dtype bfloat16, its
// products promoting to the vector dtype, ops/pallas_spmv.py:142-143): a
// second type parameter M for data/vals.  Each bf16 value is widened
// exactly (__bfloat162float, then to T) and the product rounded in T as
// above, so the bf16 forms equal their plain versions, data.to(x.dtype)
// times x in the same order, bit for bit.  They move half the value bytes
// (DIA: 2k*n + 2*4n bytes instead of 4k*n + 2*4n in f32).
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bis_device.cuh"

#define BIS_DIA_MAX_DIAGS 96

// The DIA offsets go by value (at most the JAX package's dia_max_diags).
// Keep in step with the ctypes mirror DiaArgs in _build.py.
struct BisDiaArgs {
    long long off[BIS_DIA_MAX_DIAGS];
    long long n;
    int n_diags;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// A stored matrix value as the vector type T: exact for every M (a bf16
// value is a float with 8 significant bits).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, typename M>
__global__ void __launch_bounds__(256)
dia_spmv_kernel(const __grid_constant__ BisDiaArgs a, const M* data,
                const T* x, T* y) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n) return;
    T acc = T(0);
    for (int d = 0; d < a.n_diags; ++d) {
        const long long j = i + a.off[d];
        const T xv = (j >= 0 && j < a.n) ? x[j] : T(0);
        acc = add_rn(acc, mul_rn(T(widen(data[(long long)d * a.n + i])), xv));
    }
    y[i] = acc;
}

// x at packed index p of a row of x2-row r: the column clipped into the
// planes, 0 past n (the plain version's zero padding).
template <typename T>
__device__ __forceinline__ T lane_x(const T* __restrict__ x, long long r,
                                    int p, int S, long long n,
                                    long long plane) {
    long long j = (r + (p >> 7) - S) * 128 + (p & 127);
    j = j < 0 ? 0 : (j > plane - 1 ? plane - 1 : j);
    return j < n ? x[j] : T(0);
}

template <typename T, typename M, typename I, typename C>
__global__ void __launch_bounds__(256)
lane_ell_spmv_kernel(const M* __restrict__ vals, const I* __restrict__ idx,
                     const C* __restrict__ row_len,
                     const T* __restrict__ x, T* __restrict__ y,
                     long long n, long long plane, int S) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long r = i >> 7;
    const int len = (int)row_len[i];
    T acc = T(0);
    for (int k = 0; k < len; ++k) {
        const long long s = (long long)k * plane + i;
        acc = add_rn(acc, mul_rn(T(widen(vals[s])),
                                 lane_x(x, r, (int)idx[s], S, n, plane)));
    }
    y[i] = acc;
}

// ---------------------------------------------------------------------------
// Shard-local forms for a row-sharded mesh.
//
// dia_spmv_halo_kernel replaces dia_pallas_core fed a halo-padded window
// (basic_iterative_solvers_tpu/ops/pallas_spmv.py:72, reached through
// parallel/mesh_ops.mesh_dia_spmv): a shard's `rows` rows, its own data
// (k, rows), and its x window xw = hneg rows of its left neighbour, its own
// rows, hpos rows of its right neighbour:
//
//     y[t] = sum_d data[d*rows + t] * xw[hneg + t + off_d]
//
// The window's zeros at the global edges stand for the single-device
// kernel's bounds test (x read as 0 outside [0, n)), so y is bit-equal to
// it row for row.  A window index outside [0, wlen) reads 0; the mesh
// sizes the window so that none is.
//
// lane_ell_spmv_halo_kernel replaces lane_ell_spmv_halo
// (basic_iterative_solvers_tpu/ops/lane_ell.py:268, over
// _lane_ell_kernel_call): a shard's slot planes (K, rows) for the rows
// [128*r0, 128*r0 + rows) and the x window of H x2-rows a side (H >= S, so
// every slot's column lies inside it).  Each slot's global column is
// clipped into [0, plane - 1] exactly as in the single-device kernel and
// read as 0 past n, then looked up in the window: every slot reads the
// value the single-device kernel reads.  Its counted form reads the
// shard's rows of row_len and stops there as the single-device kernel
// does; its padded form reads all K slots, and is the route of a launch
// too small to fill the card (ops/lane_ell.halo_route_for): with a few
// blocks an SM the counted loop, whose loads wait on the count's, ran
// slower on the H100 than the padded one.  Both take 16-bit or int32
// indices.
//
// Bound: bytes, as the single-device forms, plus the window's halo.
// ---------------------------------------------------------------------------

template <typename T, typename M>
__global__ void __launch_bounds__(256)
dia_spmv_halo_kernel(const __grid_constant__ BisDiaArgs a, const M* data,
                     const T* xw, T* y, long long hneg, long long wlen) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= a.n) return;
    T acc = T(0);
    for (int d = 0; d < a.n_diags; ++d) {
        const long long j = hneg + t + a.off[d];
        const T xv = (j >= 0 && j < wlen) ? xw[j] : T(0);
        acc = add_rn(acc, mul_rn(T(widen(data[(long long)d * a.n + t])), xv));
    }
    y[t] = acc;
}

// x at packed index p of a shard row of global x2-row r, from the window
// whose first entry is global row `base`.
template <typename T>
__device__ __forceinline__ T lane_xw(const T* __restrict__ xw, long long r,
                                     int p, int S, long long n,
                                     long long plane, long long base,
                                     long long wlen) {
    long long j = (r + (p >> 7) - S) * 128 + (p & 127);
    j = j < 0 ? 0 : (j > plane - 1 ? plane - 1 : j);
    const long long jw = j - base;
    return (j < n && jw >= 0 && jw < wlen) ? xw[jw] : T(0);
}

template <typename T, typename M, typename I, typename C>
__global__ void __launch_bounds__(256)
lane_ell_spmv_halo_kernel(const M* __restrict__ vals,
                          const I* __restrict__ idx,
                          const C* __restrict__ row_len,
                          const T* __restrict__ xw, T* __restrict__ y,
                          long long rows, long long r0, long long halo,
                          long long n, long long plane, int S,
                          long long wlen) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows) return;
    const long long r = r0 + (t >> 7);
    const long long base = (r0 - halo) * 128;
    const int len = (int)row_len[t];
    T acc = T(0);
    for (int k = 0; k < len; ++k) {
        const long long s = (long long)k * rows + t;
        acc = add_rn(acc, mul_rn(T(widen(vals[s])),
                                 lane_xw(xw, r, (int)idx[s], S, n, plane,
                                         base, wlen)));
    }
    y[t] = acc;
}

template <typename T, typename M, typename I>
__global__ void __launch_bounds__(256)
lane_ell_spmv_halo_padded_kernel(const M* vals, const I* idx, const T* xw,
                                 T* y, long long rows, long long r0,
                                 long long halo, long long n,
                                 long long plane, int K, int S,
                                 long long wlen) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows) return;
    const long long r = r0 + (t >> 7);
    const long long base = (r0 - halo) * 128;
    T acc = T(0);
    for (int k = 0; k < K; ++k) {
        const long long s = (long long)k * rows + t;
        const int p = (int)idx[s];
        long long j = (r + (p >> 7) - S) * 128 + (p & 127);
        j = j < 0 ? 0 : (j > plane - 1 ? plane - 1 : j);
        const long long jw = j - base;
        const T xv = (j < n && jw >= 0 && jw < wlen) ? xw[jw] : T(0);
        acc = add_rn(acc, mul_rn(T(widen(vals[s])), xv));
    }
    y[t] = acc;
}

static unsigned blocks_for(long long n) {
    return (unsigned)((n + 255) / 256);
}

template <typename T, typename M>
static int launch_dia(int device, const BisDiaArgs* a, const M* data,
                      const T* x, T* y, cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    dia_spmv_kernel<T, M><<<blocks_for(a->n), 256, 0, stream>>>(*a, data, x, y);
    return (int)cudaGetLastError();
}

// The counted kernel for the index and count widths the wrapper names
// (idx_bytes 2 or 4, len_bytes 1 or 4); anything else is refused.
template <typename T, typename M>
static int launch_lane_ell(int device, const M* vals, const void* idx,
                           const void* row_len, const T* x, T* y,
                           long long n, long long plane, int S,
                           int idx_bytes, int len_bytes,
                           cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    typedef unsigned short I2;
    typedef unsigned char C1;
    const unsigned grid = blocks_for(n);
#define BIS_LE_CASE(I, C)                                                    \
    lane_ell_spmv_kernel<T, M, I, C><<<grid, 256, 0, stream>>>(              \
        vals, (const I*)idx, (const C*)row_len, x, y, n, plane, S)
    if (idx_bytes == 2 && len_bytes == 1) BIS_LE_CASE(I2, C1);
    else if (idx_bytes == 2 && len_bytes == 4) BIS_LE_CASE(I2, int);
    else if (idx_bytes == 4 && len_bytes == 1) BIS_LE_CASE(int, C1);
    else if (idx_bytes == 4 && len_bytes == 4) BIS_LE_CASE(int, int);
    else return (int)cudaErrorInvalidValue;
#undef BIS_LE_CASE
    return (int)cudaGetLastError();
}

template <typename T, typename M>
static int launch_dia_halo(int device, const BisDiaArgs* a, const M* data,
                           const T* xw, T* y, long long hneg, long long wlen,
                           cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    dia_spmv_halo_kernel<T, M><<<blocks_for(a->n), 256, 0, stream>>>(
        *a, data, xw, y, hneg, wlen);
    return (int)cudaGetLastError();
}

template <typename T, typename M>
static int launch_lane_ell_halo(int device, const M* vals, const void* idx,
                                const void* row_len, const T* xw, T* y,
                                long long rows, long long r0, long long halo,
                                long long n, long long plane, int S,
                                long long wlen, int idx_bytes, int len_bytes,
                                cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    typedef unsigned short I2;
    typedef unsigned char C1;
    const unsigned grid = blocks_for(rows);
#define BIS_LE_CASE(I, C)                                                    \
    lane_ell_spmv_halo_kernel<T, M, I, C><<<grid, 256, 0, stream>>>(         \
        vals, (const I*)idx, (const C*)row_len, xw, y, rows, r0, halo, n,    \
        plane, S, wlen)
    if (idx_bytes == 2 && len_bytes == 1) BIS_LE_CASE(I2, C1);
    else if (idx_bytes == 2 && len_bytes == 4) BIS_LE_CASE(I2, int);
    else if (idx_bytes == 4 && len_bytes == 1) BIS_LE_CASE(int, C1);
    else if (idx_bytes == 4 && len_bytes == 4) BIS_LE_CASE(int, int);
    else return (int)cudaErrorInvalidValue;
#undef BIS_LE_CASE
    return (int)cudaGetLastError();
}

template <typename T, typename M>
static int launch_lane_ell_halo_padded(int device, const M* vals,
                                       const void* idx, const T* xw, T* y,
                                       long long rows, long long r0,
                                       long long halo, long long n,
                                       long long plane, int K, int S,
                                       long long wlen, int idx_bytes,
                                       cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const unsigned grid = blocks_for(rows);
#define BIS_LE_CASE(I)                                                       \
    lane_ell_spmv_halo_padded_kernel<T, M, I><<<grid, 256, 0, stream>>>(     \
        vals, (const I*)idx, xw, y, rows, r0, halo, n, plane, K, S, wlen)
    if (idx_bytes == 2) BIS_LE_CASE(unsigned short);
    else if (idx_bytes == 4) BIS_LE_CASE(int);
    else return (int)cudaErrorInvalidValue;
#undef BIS_LE_CASE
    return (int)cudaGetLastError();
}

extern "C" {

// bis_dia_spmv_<vector type>[_bf16]: the suffix _bf16 takes bf16 data.
#define BIS_DIA_ENTRY(NAME, T, M)                                            \
    int NAME(int device, const BisDiaArgs* a, const M* data, const T* x,   \
             T* y, void* stream) {                                          \
        return launch_dia<T, M>(device, a, data, x, y, (cudaStream_t)stream); \
    }
BIS_DIA_ENTRY(bis_dia_spmv_f32, float, float)
BIS_DIA_ENTRY(bis_dia_spmv_f64, double, double)
BIS_DIA_ENTRY(bis_dia_spmv_f32_bf16, float, __nv_bfloat16)
BIS_DIA_ENTRY(bis_dia_spmv_f64_bf16, double, __nv_bfloat16)

// plane = R*128, the entries of one slot plane (R padded x2 rows); idx the
// packed index plane of idx_bytes (2: unsigned 16-bit, 4: int32) an
// entry, row_len the rows' counts of len_bytes (1: unsigned byte, 4:
// int32) each.
#define BIS_LANE_ELL_ENTRY(NAME, T, M)                                       \
    int NAME(int device, const M* vals, const void* idx,                    \
             const void* row_len, const T* x, T* y, long long n,            \
             long long plane, int S, int idx_bytes, int len_bytes,          \
             void* stream) {                                                \
        return launch_lane_ell<T, M>(device, vals, idx, row_len, x, y, n,   \
                                     plane, S, idx_bytes, len_bytes,        \
                                     (cudaStream_t)stream);                 \
    }
BIS_LANE_ELL_ENTRY(bis_lane_ell_spmv_f32, float, float)
BIS_LANE_ELL_ENTRY(bis_lane_ell_spmv_f64, double, double)
BIS_LANE_ELL_ENTRY(bis_lane_ell_spmv_f32_bf16, float, __nv_bfloat16)
BIS_LANE_ELL_ENTRY(bis_lane_ell_spmv_f64_bf16, double, __nv_bfloat16)

// The shard-local forms: bis_<kernel>_halo_<vector type>[_bf16]; a->n is
// the shard's row count.
#define BIS_DIA_HALO_ENTRY(NAME, T, M)                                       \
    int NAME(int device, const BisDiaArgs* a, const M* data, const T* xw,  \
             T* y, long long hneg, long long wlen, void* stream) {          \
        return launch_dia_halo<T, M>(device, a, data, xw, y, hneg, wlen,    \
                                     (cudaStream_t)stream);                 \
    }
BIS_DIA_HALO_ENTRY(bis_dia_spmv_halo_f32, float, float)
BIS_DIA_HALO_ENTRY(bis_dia_spmv_halo_f64, double, double)
BIS_DIA_HALO_ENTRY(bis_dia_spmv_halo_f32_bf16, float, __nv_bfloat16)
BIS_DIA_HALO_ENTRY(bis_dia_spmv_halo_f64_bf16, double, __nv_bfloat16)

// rows = the shard's x2-rows * 128, r0 its first x2-row, halo = H x2-rows
// a side, plane = R*128 of the whole (row-extended) planes; idx, row_len
// the shard's, as in the single-device entries.
#define BIS_LANE_ELL_HALO_ENTRY(NAME, T, M)                                  \
    int NAME(int device, const M* vals, const void* idx,                    \
             const void* row_len, const T* xw, T* y, long long rows,        \
             long long r0, long long halo, long long n, long long plane,    \
             int S, long long wlen, int idx_bytes, int len_bytes,           \
             void* stream) {                                                \
        return launch_lane_ell_halo<T, M>(device, vals, idx, row_len, xw,   \
                                          y, rows, r0, halo, n, plane, S,   \
                                          wlen, idx_bytes, len_bytes,       \
                                          (cudaStream_t)stream);            \
    }                                                                       \
    int NAME##_padded(int device, const M* vals, const void* idx,           \
                      const T* xw, T* y, long long rows, long long r0,      \
                      long long halo, long long n, long long plane, int K,  \
                      int S, long long wlen, int idx_bytes, void* stream) { \
        return launch_lane_ell_halo_padded<T, M>(                           \
            device, vals, idx, xw, y, rows, r0, halo, n, plane, K, S, wlen, \
            idx_bytes, (cudaStream_t)stream);                               \
    }
BIS_LANE_ELL_HALO_ENTRY(bis_lane_ell_spmv_halo_f32, float, float)
BIS_LANE_ELL_HALO_ENTRY(bis_lane_ell_spmv_halo_f64, double, double)
BIS_LANE_ELL_HALO_ENTRY(bis_lane_ell_spmv_halo_f32_bf16, float, __nv_bfloat16)
BIS_LANE_ELL_HALO_ENTRY(bis_lane_ell_spmv_halo_f64_bf16, double, __nv_bfloat16)

int bis_dia_args_size(void) { return (int)sizeof(BisDiaArgs); }

}  // extern "C"
