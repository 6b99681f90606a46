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
// from L2 after the first diagonal); lane-ELL reads K*n values and K*n
// 4-byte indices plus gathered x.  Each thread's loop is a load, a
// multiply and an add per term.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

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

template <typename T>
__global__ void __launch_bounds__(256)
dia_spmv_kernel(const __grid_constant__ BisDiaArgs a, const T* data,
                const T* x, T* y) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n) return;
    T acc = T(0);
    for (int d = 0; d < a.n_diags; ++d) {
        const long long j = i + a.off[d];
        const T xv = (j >= 0 && j < a.n) ? x[j] : T(0);
        acc = add_rn(acc, mul_rn(data[(long long)d * a.n + i], xv));
    }
    y[i] = acc;
}

template <typename T>
__global__ void __launch_bounds__(256)
lane_ell_spmv_kernel(const T* vals, const int* idx, const T* x, T* y,
                     long long n, long long plane, int K, int S) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long r = i >> 7;
    T acc = T(0);
    for (int k = 0; k < K; ++k) {
        const long long s = (long long)k * plane + i;
        const int p = idx[s];
        long long j = (r + (p >> 7) - S) * 128 + (p & 127);
        j = j < 0 ? 0 : (j > plane - 1 ? plane - 1 : j);
        const T xv = j < n ? x[j] : T(0);
        acc = add_rn(acc, mul_rn(vals[s], xv));
    }
    y[i] = acc;
}

static unsigned blocks_for(long long n) {
    return (unsigned)((n + 255) / 256);
}

template <typename T>
static int launch_dia(int device, const BisDiaArgs* a, const T* data,
                      const T* x, T* y, cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    dia_spmv_kernel<T><<<blocks_for(a->n), 256, 0, stream>>>(*a, data, x, y);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_lane_ell(int device, const T* vals, const int* idx,
                           const T* x, T* y, long long n, long long plane,
                           int K, int S, cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    lane_ell_spmv_kernel<T><<<blocks_for(n), 256, 0, stream>>>(
        vals, idx, x, y, n, plane, K, S);
    return (int)cudaGetLastError();
}

extern "C" {

int bis_dia_spmv_f32(int device, const BisDiaArgs* a, const float* data,
                     const float* x, float* y, void* stream) {
    return launch_dia<float>(device, a, data, x, y, (cudaStream_t)stream);
}

int bis_dia_spmv_f64(int device, const BisDiaArgs* a, const double* data,
                     const double* x, double* y, void* stream) {
    return launch_dia<double>(device, a, data, x, y, (cudaStream_t)stream);
}

// plane = R*128, the entries of one slot plane (R padded x2 rows).
int bis_lane_ell_spmv_f32(int device, const float* vals, const int* idx,
                          const float* x, float* y, long long n,
                          long long plane, int K, int S, void* stream) {
    return launch_lane_ell<float>(device, vals, idx, x, y, n, plane, K, S,
                                  (cudaStream_t)stream);
}

int bis_lane_ell_spmv_f64(int device, const double* vals, const int* idx,
                          const double* x, double* y, long long n,
                          long long plane, int K, int S, void* stream) {
    return launch_lane_ell<double>(device, vals, idx, x, y, n, plane, K, S,
                                   (cudaStream_t)stream);
}

int bis_dia_args_size(void) { return (int)sizeof(BisDiaArgs); }

}  // extern "C"
