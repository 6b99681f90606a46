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

template <typename T>
__global__ void __launch_bounds__(256)
stencil_spmv_kernel(const BisStencilArgs a, const T* __restrict__ x,
                    const T* __restrict__ diag, const T* __restrict__ aux,
                    T* __restrict__ y, T* __restrict__ partials) {
    const int gy = blockIdx.x * a.block_y + threadIdx.y;
    const int gz = blockIdx.y;
    T dsum[BIS_MAX_DOTS] = {T(0), T(0), T(0)};
    if (gy < a.ny) {
        const long long row = (long long)a.nx * (gy + (long long)a.ny * gz);
        for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
            const long long i = row + gx;
            T acc = T(0);
            for (int g = 0; g < a.n_groups; ++g) {
                T s = T(0);
                for (int l = a.group_begin[g]; l < a.group_begin[g + 1]; ++l) {
                    const int px = gx + a.dx[l], py = gy + a.dy[l],
                              pz = gz + a.dz[l];
                    if (px >= 0 && px < a.nx && py >= 0 && py < a.ny &&
                        pz >= 0 && pz < a.nz)
                        s += x[i + a.off[l]];
                }
                acc += T(a.group_coeff[g]) * s;
            }
            if (diag != nullptr) acc += diag[i] * x[i];
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

int bis_stencil_args_size(void) { return (int)sizeof(BisStencilArgs); }

}  // extern "C"
