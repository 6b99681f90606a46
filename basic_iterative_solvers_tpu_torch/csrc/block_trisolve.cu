// One superblock level of a const-mode coloured triangular solve, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel basic_iterative_solvers_tpu/ops/
// block_trisolve.py: _super_level_pallas in its const mode (the plain form
// there is _super_level_xla).  A grid colouring with strides (sx, sy, sz)
// of an open-boundary nx*ny*nz constant stencil groups the rows into
// S = sy*sz superblocks, superblock sb holding the rows with
// (y mod sy, z mod sz) = (sb mod sy, sb / sy); inside one, the colours are
// the sx x-parities.  A level solves one superblock of (T + D) x = y, T the
// strict triangle of the colour-sorted ordering:
//
//     acc[i] = y[i] - sum_cross c * x[i + dx + nx*(dy + ny*dz)]
//     for each x-parity p in order (reversed for the upper triangle):
//         x[i] = (acc[i] - sum_self c * x[i + dx]) * dinv   on parity p rows
//
// Cross legs reach only superblocks already solved (lower ones for L,
// higher ones for U); a self leg (dy = dz = 0) counts only where its
// source parity is already solved (lower for L, higher for U).  Boundary
// masks come from (x, y, z), in the natural flat order: the TPU's
// rank-space permute, planes and lane rolls have no counterpart here.
// Every difference and product is rounded alone (no fused multiply-add),
// cross legs in their given order, then self legs, as the plain version's
// separate PyTorch operations and the JAX package's XLA form round them.
//
// One launch per level.  A block owns whole x-lines of the superblock (a
// self leg never leaves its line), so the parities chain inside the block
// with __syncthreads() between them.  acc is kept in x itself: the level's
// own rows are not read by anyone else during the launch, so y may alias x
// (the U solve of symmetric GS runs in place).
//
// What bounds it on the card: like the SpMV, the per-row leg loop with a
// bounds check per leg, here over 1/S of the rows per launch; each level
// reads its rows of y and the solved neighbours of x (mostly from L2 at
// 128^3) and writes its rows of x twice (acc, then the solution).  Only
// 1/sx of a block's threads work in each parity step.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#define BIS_SL_MAX_LEGS 27

// Launch table of one level, built by the Python wrapper
// (ops/block_trisolve._level_args).  Keep the field order in step with the
// ctypes mirror in _build.py (8-byte fields first: no padding).
struct BisSuperLevelArgs {
    long long cross_off[BIS_SL_MAX_LEGS];   // dx + nx*(dy + ny*dz)
    double cross_coeff[BIS_SL_MAX_LEGS];
    double self_coeff[BIS_SL_MAX_LEGS];
    double dinv;                            // 1 / D, rounded to the dtype
    int cross_dx[BIS_SL_MAX_LEGS];
    int cross_dy[BIS_SL_MAX_LEGS];
    int cross_dz[BIS_SL_MAX_LEGS];
    int self_dx[BIS_SL_MAX_LEGS];
    int n_cross, n_self;
    int nx, ny, nz, sx, sy, sz;
    int py, pz;                             // the superblock's (y, z) phases
    int my, lines;                          // ny / sy, lines of the superblock
    int upper;
    int block_x, block_y, grid_x;
};

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(256)
super_level_kernel(const __grid_constant__ BisSuperLevelArgs a, const T* y,
                   T* x) {
    const int line = blockIdx.x * a.block_y + threadIdx.y;
    const bool live = line < a.lines;
    const int gy = a.sy * (line % a.my) + a.py;
    const int gz = a.sz * (line / a.my) + a.pz;
    const long long row = (long long)a.nx * (gy + (long long)a.ny * gz);
    if (live) {
        for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
            const long long i = row + gx;
            T acc = y[i];
            for (int l = 0; l < a.n_cross; ++l) {
                const int px = gx + a.cross_dx[l], py = gy + a.cross_dy[l],
                          pz = gz + a.cross_dz[l];
                if (px >= 0 && px < a.nx && py >= 0 && py < a.ny &&
                    pz >= 0 && pz < a.nz)
                    acc = sub_rn(acc, mul_rn(T(a.cross_coeff[l]),
                                             x[i + a.cross_off[l]]));
            }
            x[i] = acc;
        }
    }
    __syncthreads();
    for (int step = 0; step < a.sx; ++step) {
        const int p = a.upper ? a.sx - 1 - step : step;
        if (live) {
            for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
                if (gx % a.sx != p) continue;
                const long long i = row + gx;
                T v = x[i];
                for (int l = 0; l < a.n_self; ++l) {
                    const int px = gx + a.self_dx[l];
                    if (px < 0 || px >= a.nx) continue;
                    const int ps = px % a.sx;
                    if (a.upper ? ps <= p : ps >= p) continue;
                    v = sub_rn(v, mul_rn(T(a.self_coeff[l]),
                                         x[i + a.self_dx[l]]));
                }
                x[i] = mul_rn(v, T(a.dinv));
            }
        }
        __syncthreads();
    }
}

template <typename T>
static int launch(int device, const BisSuperLevelArgs* a, const T* y, T* x,
                  cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    const dim3 block(a->block_x, a->block_y);
    super_level_kernel<T><<<a->grid_x, block, 0, stream>>>(*a, y, x);
    return (int)cudaGetLastError();
}

extern "C" {

int bis_super_level_f32(int device, const BisSuperLevelArgs* a,
                        const float* y, float* x, void* stream) {
    return launch<float>(device, a, y, x, (cudaStream_t)stream);
}

int bis_super_level_f64(int device, const BisSuperLevelArgs* a,
                        const double* y, double* x, void* stream) {
    return launch<double>(device, a, y, x, (cudaStream_t)stream);
}

int bis_super_level_args_size(void) { return (int)sizeof(BisSuperLevelArgs); }

}  // extern "C"
