// Matrix-free constant-coefficient stencil SpMV for Hopper (sm_90a).
//
// Replaces the Pallas kernel basic_iterative_solvers_tpu/stencil_op.py:
// stencil_spmv_resident (body _resident_kernel): for the row
// i = x + nx*(y + ny*z) of an open-boundary nx*ny*nz grid
//
//     y[i] = sum_legs c_l * x[i + off_l]      (leg masked at the boundary)
//
// with the (0,0,0) leg's coefficient replaced by diag[i] when a dense
// diagonal is given, and optional per-block partial sums of y.x ("x"),
// y.y ("self") and y.aux ("aux").  Legs with equal coefficients are summed
// before one multiply, as the TPU kernel does.  Boundary masks come from
// the (x, y, z) coordinates, so any leg offset is allowed and no halo is
// stored.
//
// What bounds it on the card: the operation's floor is bytes.  Each apply
// reads x (plus diag and aux when present) and writes y, at 2*|legs| flops
// per row.  At 128^3 in f32 a vector is 8.4 MB, so CG's working set x, r,
// p, t (~34 MB) fits in the H100's 50 MB L2; the 384^3 case (226 MB per
// vector) streams from HBM.  The design is the simple one: threads along x
// so that neighbouring threads read neighbouring addresses, a grid over
// (y-tile, z), the neighbour reads served by L1/L2, legs walked in a
// runtime loop with a bounds check each.  That loop, not the bytes, is
// what this form is measured to be bound by on an H100 (the same ~27 G
// rows/s at 128^3 and at 384^3, where HBM would allow ~7x more).
// Unrolled legs, shared-memory tiles, TMA and a fused CG update are later
// work.
//
// Dot partials go to a (n_blocks, n_dots) buffer that the caller sums, so
// the result is deterministic without atomics.
//
// The multicolour Gauss-Seidel step (replaces the Pallas kernel
// basic_iterative_solvers_tpu/stencil_op.py: stencil_gs_color_step, which
// shares _resident_kernel's body) is the same row sum with an epilogue:
//
//     x'[i] = colour(i) == c ? x[i] + (rhs[i] - (A x)[i]) * dinv[i] : x[i]
//
// with the colour computed from (x, y, z) as coloring.color_ids does:
// parity (x+y+z) mod 2, grid (x mod sx) + sx*((y mod sy) + sy*(z mod sz)),
// or mod (i mod k).  Only rows of colour c sum their legs; the others copy
// x through, so the step reads x (rhs, dinv on colour c) and writes x'.
// It is out of place: x' never aliases x.  The epilogue rounds the
// difference, the product and the sum one at a time, as the plain
// version's separate PyTorch operations do.  Same bound as the SpMV: the
// leg loop, at 1/n_colours of the rows.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#define BIS_MAX_LEGS 27
#define BIS_MAX_DOTS 3

// Launch table, built by the Python wrapper (stencil_op._launch_table).
// Legs are stored grouped by coefficient value: group g owns legs
// [group_begin[g], group_begin[g+1]).  Keep the field order in step with
// the ctypes mirror in _build.py (8-byte fields first: no padding).
struct BisStencilArgs {
    long long off[BIS_MAX_LEGS];        // linear offset dx + nx*(dy + ny*dz)
    double group_coeff[BIS_MAX_LEGS];
    int dx[BIS_MAX_LEGS];
    int dy[BIS_MAX_LEGS];
    int dz[BIS_MAX_LEGS];
    int group_begin[BIS_MAX_LEGS + 1];
    int n_groups;
    int nx, ny, nz;
    int block_x, block_y;               // threads per block along x and y
    int grid_x, grid_y;                 // ceil(ny / block_y), nz
    int n_dots;
    int dot_kind[BIS_MAX_DOTS];         // 0: y.x, 1: y.y, 2: y.aux
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Sum v[0..n) over the block; thread 0 writes the sums to out[0..n).
// Every thread of the block must call it (it synchronises).
template <typename T>
__device__ void block_sums(T (&v)[BIS_MAX_DOTS], int n, T* out) {
    __shared__ T warp_part[BIS_MAX_DOTS][32];
    const int tid = threadIdx.x + blockDim.x * threadIdx.y;
    const int lane = tid & 31, warp = tid >> 5;
    const int n_warps = (blockDim.x * blockDim.y + 31) >> 5;
    for (int k = 0; k < n; ++k) {
        const T s = warp_sum(v[k]);
        if (lane == 0) warp_part[k][warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
        for (int k = 0; k < n; ++k) {
            T s = lane < n_warps ? warp_part[k][lane] : T(0);
            s = warp_sum(s);
            if (lane == 0) out[k] = s;
        }
    }
}

// y[i] for the row i = (gx, gy, gz): each coefficient group's in-bounds
// legs summed, times the group's coefficient, plus diag[i]*x[i].
template <typename T>
__device__ __forceinline__ T stencil_row(const BisStencilArgs& a,
                                         const T* __restrict__ x,
                                         const T* __restrict__ diag,
                                         long long i, int gx, int gy,
                                         int gz) {
    T acc = T(0);
    for (int g = 0; g < a.n_groups; ++g) {
        T s = T(0);
        for (int l = a.group_begin[g]; l < a.group_begin[g + 1]; ++l) {
            const int px = gx + a.dx[l], py = gy + a.dy[l], pz = gz + a.dz[l];
            if (px >= 0 && px < a.nx && py >= 0 && py < a.ny &&
                pz >= 0 && pz < a.nz)
                s += x[i + a.off[l]];
        }
        acc += T(a.group_coeff[g]) * s;
    }
    if (diag != nullptr) acc += diag[i] * x[i];
    return acc;
}

template <typename T>
__global__ void __launch_bounds__(256)
stencil_spmv_kernel(const __grid_constant__ BisStencilArgs a,
                    const T* __restrict__ x,
                    const T* __restrict__ diag, const T* __restrict__ aux,
                    T* __restrict__ y, T* __restrict__ partials) {
    const int gy = blockIdx.x * a.block_y + threadIdx.y;
    const int gz = blockIdx.y;
    T dsum[BIS_MAX_DOTS] = {T(0), T(0), T(0)};
    if (gy < a.ny) {
        const long long row = (long long)a.nx * (gy + (long long)a.ny * gz);
        for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
            const long long i = row + gx;
            const T acc = stencil_row(a, x, diag, i, gx, gy, gz);
            y[i] = acc;
            for (int k = 0; k < a.n_dots; ++k) {
                const int kind = a.dot_kind[k];
                const T v = kind == 0 ? x[i] : (kind == 1 ? acc : aux[i]);
                dsum[k] += acc * v;
            }
        }
    }
    if (a.n_dots > 0)
        block_sums(dsum, a.n_dots,
                   partials + (long long)(blockIdx.x + gridDim.x * blockIdx.y) *
                                  a.n_dots);
}

// Colouring of the GS step: kind 0 parity, 1 grid (p = sx, sy, sz),
// 2 mod (p[0] = k); `color` is the colour the step updates.
struct BisColorStep {
    int kind;
    int p[3];
    int color;
};

__device__ __forceinline__ int color_of(const BisColorStep& c, long long i,
                                        int gx, int gy, int gz) {
    if (c.kind == 0) return (gx + gy + gz) & 1;
    if (c.kind == 1)
        return gx % c.p[0] + c.p[0] * (gy % c.p[1] + c.p[1] * (gz % c.p[2]));
    return (int)(i % c.p[0]);
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(256)
stencil_gs_color_step_kernel(const __grid_constant__ BisStencilArgs a,
                             const BisColorStep c, const T* __restrict__ x,
                             const T* __restrict__ diag,
                             const T* __restrict__ rhs,
                             const T* __restrict__ dinv,
                             T* __restrict__ out) {
    const int gy = blockIdx.x * a.block_y + threadIdx.y;
    const int gz = blockIdx.y;
    if (gy >= a.ny) return;
    const long long row = (long long)a.nx * (gy + (long long)a.ny * gz);
    for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
        const long long i = row + gx;
        T xi = x[i];
        if (color_of(c, i, gx, gy, gz) == c.color) {
            const T ax = stencil_row(a, x, diag, i, gx, gy, gz);
            xi = add_rn(xi, mul_rn(sub_rn(rhs[i], ax), dinv[i]));
        }
        out[i] = xi;
    }
}

template <typename T>
static int launch(int device, const BisStencilArgs* a, const T* x,
                  const T* diag, const T* aux, T* y, T* partials,
                  cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    const dim3 block(a->block_x, a->block_y);
    const dim3 grid(a->grid_x, a->grid_y);
    stencil_spmv_kernel<T><<<grid, block, 0, stream>>>(*a, x, diag, aux, y,
                                                        partials);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_gs(int device, const BisStencilArgs* a, int kind, int p0,
                     int p1, int p2, int color, const T* x, const T* diag,
                     const T* rhs, const T* dinv, T* out,
                     cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    const BisColorStep c = {kind, {p0, p1, p2}, color};
    const dim3 block(a->block_x, a->block_y);
    const dim3 grid(a->grid_x, a->grid_y);
    stencil_gs_color_step_kernel<T><<<grid, block, 0, stream>>>(
        *a, c, x, diag, rhs, dinv, out);
    return (int)cudaGetLastError();
}

extern "C" {

int bis_stencil_spmv_f32(int device, const BisStencilArgs* a,
                         const float* x,
                         const float* diag, const float* aux, float* y,
                         float* partials, void* stream) {
    return launch<float>(device, a, x, diag, aux, y, partials, (cudaStream_t)stream);
}

int bis_stencil_spmv_f64(int device, const BisStencilArgs* a,
                         const double* x,
                         const double* diag, const double* aux, double* y,
                         double* partials, void* stream) {
    return launch<double>(device, a, x, diag, aux, y, partials, (cudaStream_t)stream);
}

int bis_stencil_gs_color_step_f32(int device, const BisStencilArgs* a,
                                  int kind, int p0, int p1, int p2,
                                  int color, const float* x,
                                  const float* diag, const float* rhs,
                                  const float* dinv, float* out,
                                  void* stream) {
    return launch_gs<float>(device, a, kind, p0, p1, p2, color, x, diag, rhs,
                            dinv, out, (cudaStream_t)stream);
}

int bis_stencil_gs_color_step_f64(int device, const BisStencilArgs* a,
                                  int kind, int p0, int p1, int p2,
                                  int color, const double* x,
                                  const double* diag, const double* rhs,
                                  const double* dinv, double* out,
                                  void* stream) {
    return launch_gs<double>(device, a, kind, p0, p1, p2, color, x, diag,
                             rhs, dinv, out, (cudaStream_t)stream);
}

int bis_stencil_args_size(void) { return (int)sizeof(BisStencilArgs); }

}  // extern "C"
