// Levels of the coloured triangular solves, for Hopper (sm_90a): the
// superblock levels, in const mode (exact GS on a stencil, or on host CSR
// whose legs are constant), factor-table mode (exact ILU(0) on a stencil)
// and plane mode (factors built from host CSR), fused in one launch a
// level or split into an acc step and one step per x-parity; a whole
// const-mode solve in one cooperative launch (super_solve_mega_kernel);
// and the rank-space level of host-CSR factors under a mod or grid
// colouring (rank_level_kernel, below).
//
// Replaces the Pallas kernels of basic_iterative_solvers_tpu/ops/
// block_trisolve.py: _super_level_pallas in its const, plane, packed and
// flat-IO modes (super_level_kernel), the split-mode pair
// _super_acc_pallas (super_acc_kernel) and _super_parity_pallas
// (super_parity_kernel), and _super_solve_pallas_mega
// (super_solve_mega_kernel).  The plain forms are ops/block_trisolve.py's
// super_level_plain, super_acc_plain, super_parity_plain and
// super_solve_mega_plain.
//
// A grid colouring with strides (sx, sy, sz) of an nx*ny*nz grid groups
// the rows into S = sy*sz superblocks, superblock sb holding the rows with
// (y mod sy, z mod sz) = (sb mod sy, sb / sy); inside one, the colours are
// the sx x-parities.  A level solves one superblock of (T + D) x = y, T
// the strict triangle of the colour-sorted ordering:
//
//     acc[i] = y[i] - sum_cross f * x[source of i]
//     for each x-parity p in order (reversed for the upper triangle):
//         x[i] = (acc[i] - sum_self f * x[i + dx]) * dinv   on parity p rows
//
// Const mode: a cross leg (dx, dy, dz) reads x[i + dx + nx*(dy + ny*dz)],
// f is the leg's coefficient and dinv the constant 1/D or, for a pair
// built from host CSR, the row's drows[i].  Factor-table mode: f =
// table[kd * n_proto + base(i)], the coloured ILU(0) factor value of leg
// kd at row i's class, and dinv = 1 (L, unit diagonal, no multiply) or
// tdinv[base(i)] (U).  base(i) maps (x, y, z) per axis to the prototype
// grid: exact within `radius` of either edge, the phase (i - radius) mod s
// inside.  The table is 27 x 5,832 values for HPCG at any grid size (~630
// KB in float32): it stays in L2.  Plane mode: the factor values of level
// l's groups are planes of the superblock's m slots, slot t = line*nx + x
// (line = y/sy + my*(z/sz)); a cross group (src, delta) maps slot t to
// slot t + delta of superblock src, whose row follows from src's (y, z)
// phases, and reads 0 outside [0, m) as the TPU's zero-padded window does;
// f = vc[g*m + t] or vs[g*m + t], dinv = drows[i].  Plane mode multiplies
// every group's value, zero or not, as the JAX package's XLA form does.
//
// Cross legs reach only superblocks already solved (lower ones for L,
// higher ones for U); a self leg (dy = dz = 0) reads x only where its
// source parity is already solved (lower for L, higher for U).  Boundary
// masks come from (x, y, z), in the natural flat order: the TPU's
// rank-space permute, (R_b, 128) planes and lane rolls have no counterpart
// here.  Every difference and product is rounded alone (no fused
// multiply-add), cross legs in their given order, then self legs, as the
// plain version's separate PyTorch operations and the JAX package's XLA
// form round them, so the fused, split and one-launch routes and the
// plain version agree bit for bit.
//
// Fused: one launch per level.  A block owns whole x-lines of the
// superblock (a self leg never leaves its line), so the parities chain
// inside the block with __syncthreads() between them.  acc is kept in x
// itself: the level's own rows are not read by anyone else during the
// launch, so y may alias x (the U solve of symmetric GS and of ILU(0) runs
// in place).  Split (the JAX package's BIS_SB_ALIGNED=0 route): acc goes
// to a scratch of the level's rows, then one launch per parity.  One
// launch (const mode, the JAX package's BIS_SB_MEGA=1 route): a persistent
// cooperative grid, sized to the blocks that fit on the card at once,
// walks every level's line blocks with a grid-stride loop and meets at
// grid.sync() between levels, which also makes each level's writes of x
// visible to the next.
//
// What bounds it on the card: like the SpMV, the per-row leg loop with a
// bounds check per leg, here over 1/S of the rows per launch, plus in
// factor-table mode the class computation and one table load (from L2)
// per leg, in plane mode one plane value per group and an integer
// division per cross group; each level reads its rows of y and the solved
// neighbours of x (from L2 at 128^3, from HBM at 384^3) and writes its
// rows of x twice (acc, then the solution).  Only 1/sx of a block's
// threads work in each parity step.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define BIS_SL_MAX_LEGS 27

// How a level finds its factor values (BisSuperLevelArgs::mode).
#define BIS_SL_CONST 0
#define BIS_SL_TABLE 1
#define BIS_SL_PLANE 2

// Launch table of one level, built by the Python wrapper
// (ops/block_trisolve._level_args).  Keep the field order in step with the
// ctypes mirror in _build.py (8-byte fields first: no padding).
struct BisSuperLevelArgs {
    long long cross_off[BIS_SL_MAX_LEGS];   // dx + nx*(dy + ny*dz)
    double cross_coeff[BIS_SL_MAX_LEGS];    // const mode
    double self_coeff[BIS_SL_MAX_LEGS];     // const mode
    double dinv;                            // const mode: 1 / D, rounded
    long long cross_delta[BIS_SL_MAX_LEGS]; // plane mode: slot offset
    long long m;                            // slots of a superblock
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
    int cross_kd[BIS_SL_MAX_LEGS];          // factor-table mode: table rows
    int self_kd[BIS_SL_MAX_LEGS];
    int proto_x, proto_y, proto_z;          // prototype grid
    int radius, n_proto;                    // class radius, proto_x*y*z
    int cross_spy[BIS_SL_MAX_LEGS];         // plane mode: source phases
    int cross_spz[BIS_SL_MAX_LEGS];
    int mode;                               // BIS_SL_CONST, _TABLE, _PLANE
};

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Prototype coordinate of grid coordinate i on an axis of n points.
__device__ __forceinline__ int proto_class(int i, int n, int P, int s, int R) {
    if (P == n) return i;
    const int c = i < R ? i : (n - 1 - i < R ? P - 1 - (n - 1 - i)
                                             : R + (i - R) % s);
    return min(max(c, 0), P - 1);
}

__device__ __forceinline__ int class_base(const BisSuperLevelArgs& a, int gx,
                                          int gy, int gz) {
    return proto_class(gx, a.nx, a.proto_x, a.sx, a.radius)
        + a.proto_x * (proto_class(gy, a.ny, a.proto_y, a.sy, a.radius)
                       + a.proto_y * proto_class(gz, a.nz, a.proto_z, a.sz,
                                                 a.radius));
}

// Flat row of slot s of the superblock with (y, z) phases (spy, spz).
__device__ __forceinline__ long long slot_row(const BisSuperLevelArgs& a,
                                              long long s, int spy, int spz) {
    const long long line = s / a.nx;
    const long long gy = (long long)a.sy * (line % a.my) + spy;
    const long long gz = (long long)a.sz * (line / a.my) + spz;
    return s - line * a.nx + a.nx * (gy + a.ny * gz);
}

// acc = y[i] - sum_cross f * x[source], legs (groups) in order; t is row
// i's slot.
template <typename T, int MODE>
__device__ __forceinline__ T cross_sum(const BisSuperLevelArgs& a,
                                       const T* y, const T* x, const T* table,
                                       const T* vc, long long i, long long t,
                                       int gx, int gy, int gz, int base) {
    T acc = y[i];
    for (int l = 0; l < a.n_cross; ++l) {
        if (MODE == BIS_SL_PLANE) {
            const long long s = t + a.cross_delta[l];
            const T xv = (s >= 0 && s < a.m)
                ? x[slot_row(a, s, a.cross_spy[l], a.cross_spz[l])] : T(0);
            acc = sub_rn(acc, mul_rn(vc[l * a.m + t], xv));
            continue;
        }
        const int px = gx + a.cross_dx[l], py = gy + a.cross_dy[l],
                  pz = gz + a.cross_dz[l];
        if (px >= 0 && px < a.nx && py >= 0 && py < a.ny && pz >= 0 &&
            pz < a.nz) {
            const T f = MODE == BIS_SL_TABLE
                ? table[(long long)a.cross_kd[l] * a.n_proto + base]
                : T(a.cross_coeff[l]);
            acc = sub_rn(acc, mul_rn(f, x[i + a.cross_off[l]]));
        }
    }
    return acc;
}

// (v - sum_self f * x[i + dx]) * dinv on a parity-p row (slot t).
template <typename T, int MODE>
__device__ __forceinline__ T parity_update(const BisSuperLevelArgs& a, int p,
                                           T v, const T* x, const T* table,
                                           const T* tdinv, const T* vs,
                                           const T* drows, long long i,
                                           long long t, int gx, int base) {
    for (int l = 0; l < a.n_self; ++l) {
        const int px = gx + a.self_dx[l];
        const bool solved = px >= 0 && px < a.nx &&
                            (a.upper ? px % a.sx > p : px % a.sx < p);
        if (MODE == BIS_SL_PLANE) {
            v = sub_rn(v, mul_rn(vs[l * a.m + t],
                                 solved ? x[i + a.self_dx[l]] : T(0)));
            continue;
        }
        if (!solved) continue;
        const T f = MODE == BIS_SL_TABLE
            ? table[(long long)a.self_kd[l] * a.n_proto + base]
            : T(a.self_coeff[l]);
        v = sub_rn(v, mul_rn(f, x[i + a.self_dx[l]]));
    }
    if (MODE == BIS_SL_TABLE) return tdinv ? mul_rn(v, tdinv[base]) : v;
    return mul_rn(v, drows ? drows[i] : T(a.dinv));
}

struct LevelRow {
    bool live;
    int line, gy, gz;
    long long row;                          // flat index of the line's x = 0
    long long slot;                         // slot of the line's x = 0
};

// Line `block * block_y + threadIdx.y` of the level's superblock.
__device__ __forceinline__ LevelRow level_row(const BisSuperLevelArgs& a,
                                              int block) {
    LevelRow r;
    r.line = block * a.block_y + threadIdx.y;
    r.live = r.line < a.lines;
    r.gy = a.sy * (r.line % a.my) + a.py;
    r.gz = a.sz * (r.line / a.my) + a.pz;
    r.row = (long long)a.nx * (r.gy + (long long)a.ny * r.gz);
    r.slot = (long long)r.line * a.nx;
    return r;
}

// One block of lines of a fused level: acc into x, then the parities in
// order, the block meeting at __syncthreads() between them (every thread
// of the block reaches each barrier).
template <typename T, int MODE>
__device__ __forceinline__ void level_block(const BisSuperLevelArgs& a,
                                            int block, const T* y, T* x,
                                            const T* table, const T* tdinv,
                                            const T* vc, const T* vs,
                                            const T* drows) {
    const LevelRow r = level_row(a, block);
    if (r.live) {
        for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
            const int base = MODE == BIS_SL_TABLE ? class_base(a, gx, r.gy, r.gz)
                                                  : 0;
            x[r.row + gx] = cross_sum<T, MODE>(a, y, x, table, vc, r.row + gx,
                                               r.slot + gx, gx, r.gy, r.gz,
                                               base);
        }
    }
    __syncthreads();
    for (int step = 0; step < a.sx; ++step) {
        const int p = a.upper ? a.sx - 1 - step : step;
        if (r.live) {
            for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
                if (gx % a.sx != p) continue;
                const long long i = r.row + gx;
                const int base = MODE == BIS_SL_TABLE
                    ? class_base(a, gx, r.gy, r.gz) : 0;
                x[i] = parity_update<T, MODE>(a, p, x[i], x, table, tdinv, vs,
                                              drows, i, r.slot + gx, gx, base);
            }
        }
        __syncthreads();
    }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(256)
super_level_kernel(const __grid_constant__ BisSuperLevelArgs a, const T* y,
                   T* x, const T* table, const T* tdinv, const T* vc,
                   const T* vs, const T* drows) {
    level_block<T, MODE>(a, blockIdx.x, y, x, table, tdinv, vc, vs, drows);
}

// A whole const-mode solve: levels[0..n_levels) in order, one grid-wide
// barrier after each, which also makes the level's writes of x visible to
// every block after it.  Each level's launch table is copied from device
// memory to shared memory first (read there as the per-level kernel reads
// its parameter).  The grid-stride loop is uniform across a block, so
// level_block's __syncthreads() is reached by every thread of it.
template <typename T>
__global__ void __launch_bounds__(256)
super_solve_mega_kernel(const BisSuperLevelArgs* levels, int n_levels,
                        const T* y, T* x, const T* drows) {
    __shared__ BisSuperLevelArgs a;
    cg::grid_group grid = cg::this_grid();
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int li = 0; li < n_levels; ++li) {
        const int* from = reinterpret_cast<const int*>(levels + li);
        int* to = reinterpret_cast<int*>(&a);
        for (int k = tid; k < (int)(sizeof(a) / sizeof(int));
             k += blockDim.x * blockDim.y)
            to[k] = from[k];
        __syncthreads();
        for (int block = blockIdx.x; block < a.grid_x; block += gridDim.x)
            level_block<T, BIS_SL_CONST>(a, block, y, x, nullptr, nullptr,
                                         nullptr, nullptr, drows);
        grid.sync();
    }
}

// Split route, step 1: acc[line * nx + x] = y - sum_cross f * x.
template <typename T, int MODE>
__global__ void __launch_bounds__(256)
super_acc_kernel(const __grid_constant__ BisSuperLevelArgs a, const T* y,
                 const T* x, T* acc, const T* table, const T* vc) {
    const LevelRow r = level_row(a, blockIdx.x);
    if (!r.live) return;
    for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
        const int base = MODE == BIS_SL_TABLE ? class_base(a, gx, r.gy, r.gz)
                                              : 0;
        acc[r.slot + gx] = cross_sum<T, MODE>(a, y, x, table, vc, r.row + gx,
                                              r.slot + gx, gx, r.gy, r.gz,
                                              base);
    }
}

// Split route, step 2: parity p's rows from acc (or y) and the self legs.
template <typename T, int MODE>
__global__ void __launch_bounds__(256)
super_parity_kernel(const __grid_constant__ BisSuperLevelArgs a, int p,
                    const T* y, const T* acc, T* x, const T* table,
                    const T* tdinv, const T* vs, const T* drows) {
    const LevelRow r = level_row(a, blockIdx.x);
    if (!r.live) return;
    for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
        if (gx % a.sx != p) continue;
        const long long i = r.row + gx;
        const int base = MODE == BIS_SL_TABLE ? class_base(a, gx, r.gy, r.gz)
                                              : 0;
        const T v = acc ? acc[r.slot + gx] : y[i];
        x[i] = parity_update<T, MODE>(a, p, v, x, table, tdinv, vs, drows, i,
                                      r.slot + gx, gx, base);
    }
}

// Rank-space level (replaces _level_pallas of basic_iterative_solvers_tpu/
// ops/block_trisolve.py; plain form ops/block_trisolve.rank_level_plain).
// Host-CSR factors under a mod colouring: the colour blocks are one (C, M)
// state, slot t of colour c the rank-t row of that colour, and level c is
//
//     x[c, t] = (y[c, t] - sum_g vals[g, t] * x[src_g, t + delta_g])
//               * dinv[c, t]
//
// over the level's groups (src, delta, plane), a small int64 table on the
// card, in the order the builder sorted them.  One thread per slot; a
// source slot outside [0, M) reads 0 where the plain version's roll wraps
// (a wrapped slot always meets a zero value, so for finite x the two
// agree bit for bit).  The TPU kernel reads three (TB, 128) windows per
// source colour and rotates lanes; here neighbouring threads read
// neighbouring slots of every plane and of x, so the loads coalesce and
// the windows' reuse comes from L1/L2.  What bounds it: bytes (a value
// plane and an x window per group, y, dinv, x out), each product and
// difference rounded alone.  y may alias x: a level reads y only at its
// own colour's slot and x only at other colours'.
template <typename T>
__global__ void __launch_bounds__(256)
rank_level_kernel(const T* y, T* x, const T* vals, const T* dinv,
                  const long long* groups, int n_groups, long long M, int c) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= M) return;
    const long long row = (long long)c * M + t;
    T acc = y[row];
    for (int g = 0; g < n_groups; ++g) {
        const long long src = groups[3 * g], delta = groups[3 * g + 1],
                        plane = groups[3 * g + 2];
        const long long s = t + delta;
        const T xv = (s >= 0 && s < M) ? x[src * M + s] : T(0);
        acc = sub_rn(acc, mul_rn(vals[plane * M + t], xv));
    }
    x[row] = mul_rn(acc, dinv[row]);
}

static cudaError_t set_device(int device) { return cudaSetDevice(device); }

template <typename T>
static int launch_level(int device, const BisSuperLevelArgs* a, const T* y,
                        T* x, const T* table, const T* tdinv, const T* vc,
                        const T* vs, const T* drows, cudaStream_t stream) {
    const cudaError_t set = set_device(device);
    if (set != cudaSuccess) return (int)set;
    const dim3 block(a->block_x, a->block_y);
    if (a->mode == BIS_SL_TABLE)
        super_level_kernel<T, BIS_SL_TABLE><<<a->grid_x, block, 0, stream>>>(
            *a, y, x, table, tdinv, nullptr, nullptr, nullptr);
    else if (a->mode == BIS_SL_PLANE)
        super_level_kernel<T, BIS_SL_PLANE><<<a->grid_x, block, 0, stream>>>(
            *a, y, x, nullptr, nullptr, vc, vs, drows);
    else
        super_level_kernel<T, BIS_SL_CONST><<<a->grid_x, block, 0, stream>>>(
            *a, y, x, nullptr, nullptr, nullptr, nullptr, drows);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_acc(int device, const BisSuperLevelArgs* a, const T* y,
                      const T* x, T* acc, const T* table, const T* vc,
                      cudaStream_t stream) {
    const cudaError_t set = set_device(device);
    if (set != cudaSuccess) return (int)set;
    const dim3 block(a->block_x, a->block_y);
    if (a->mode == BIS_SL_PLANE)
        super_acc_kernel<T, BIS_SL_PLANE><<<a->grid_x, block, 0, stream>>>(
            *a, y, x, acc, nullptr, vc);
    else
        super_acc_kernel<T, BIS_SL_TABLE><<<a->grid_x, block, 0, stream>>>(
            *a, y, x, acc, table, nullptr);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_parity(int device, const BisSuperLevelArgs* a, int p,
                         const T* y, const T* acc, T* x, const T* table,
                         const T* tdinv, const T* vs, const T* drows,
                         cudaStream_t stream) {
    const cudaError_t set = set_device(device);
    if (set != cudaSuccess) return (int)set;
    const dim3 block(a->block_x, a->block_y);
    if (a->mode == BIS_SL_PLANE)
        super_parity_kernel<T, BIS_SL_PLANE><<<a->grid_x, block, 0, stream>>>(
            *a, p, y, acc, x, nullptr, nullptr, vs, drows);
    else
        super_parity_kernel<T, BIS_SL_TABLE><<<a->grid_x, block, 0, stream>>>(
            *a, p, y, acc, x, table, tdinv, nullptr, nullptr);
    return (int)cudaGetLastError();
}

// The blocks of the one-launch solve: as many as fit on the card at once
// (a cooperative launch of more fails), and no more than the most line
// blocks a level has.  0 when the card cannot run it.
template <typename T>
static int mega_grid(int device, int threads, int max_blocks) {
    int coop = 0, sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)
            != cudaSuccess || !coop)
        return 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
            != cudaSuccess)
        return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, super_solve_mega_kernel<T>, threads, 0) != cudaSuccess)
        return 0;
    const long long fit = (long long)per_sm * sms;
    return (int)(fit < max_blocks ? fit : max_blocks);
}

template <typename T>
static int launch_mega(int device, const BisSuperLevelArgs* levels,
                       int n_levels, int block_x, int block_y, int max_blocks,
                       const T* y, T* x, const T* drows, cudaStream_t stream) {
    const cudaError_t set = set_device(device);
    if (set != cudaSuccess) return (int)set;
    const int grid = mega_grid<T>(device, block_x * block_y, max_blocks);
    if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {(void*)&levels, (void*)&n_levels, (void*)&y, (void*)&x,
                    (void*)&drows};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)super_solve_mega_kernel<T>, dim3(grid),
        dim3(block_x, block_y), args, 0, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_rank_level(int device, const T* y, T* x, const T* vals,
                             const T* dinv, const long long* groups,
                             int n_groups, long long M, int c,
                             cudaStream_t stream) {
    const cudaError_t set = set_device(device);
    if (set != cudaSuccess) return (int)set;
    rank_level_kernel<T><<<(unsigned)((M + 255) / 256), 256, 0, stream>>>(
        y, x, vals, dinv, groups, n_groups, M, c);
    return (int)cudaGetLastError();
}

extern "C" {

// The mode (a->mode) picks the pointers read: table and tdinv (NULL for L)
// in factor-table mode; vc, vs (NULL where the level has no such groups)
// and drows in plane mode; drows (NULL: the scalar a->dinv) in const mode.
int bis_super_level_f32(int device, const BisSuperLevelArgs* a,
                        const float* y, float* x, const float* table,
                        const float* tdinv, const float* vc, const float* vs,
                        const float* drows, void* stream) {
    return launch_level<float>(device, a, y, x, table, tdinv, vc, vs, drows,
                               (cudaStream_t)stream);
}

int bis_super_level_f64(int device, const BisSuperLevelArgs* a,
                        const double* y, double* x, const double* table,
                        const double* tdinv, const double* vc,
                        const double* vs, const double* drows, void* stream) {
    return launch_level<double>(device, a, y, x, table, tdinv, vc, vs, drows,
                                (cudaStream_t)stream);
}

int bis_super_acc_f32(int device, const BisSuperLevelArgs* a, const float* y,
                      const float* x, float* acc, const float* table,
                      const float* vc, void* stream) {
    return launch_acc<float>(device, a, y, x, acc, table, vc,
                             (cudaStream_t)stream);
}

int bis_super_acc_f64(int device, const BisSuperLevelArgs* a,
                      const double* y, const double* x, double* acc,
                      const double* table, const double* vc, void* stream) {
    return launch_acc<double>(device, a, y, x, acc, table, vc,
                              (cudaStream_t)stream);
}

// acc == NULL: the level has no cross legs and reads y.
int bis_super_parity_f32(int device, const BisSuperLevelArgs* a, int p,
                         const float* y, const float* acc, float* x,
                         const float* table, const float* tdinv,
                         const float* vs, const float* drows, void* stream) {
    return launch_parity<float>(device, a, p, y, acc, x, table, tdinv, vs,
                                drows, (cudaStream_t)stream);
}

int bis_super_parity_f64(int device, const BisSuperLevelArgs* a, int p,
                         const double* y, const double* acc, double* x,
                         const double* table, const double* tdinv,
                         const double* vs, const double* drows,
                         void* stream) {
    return launch_parity<double>(device, a, p, y, acc, x, table, tdinv, vs,
                                 drows, (cudaStream_t)stream);
}

// levels: n_levels launch tables in device memory, in solve order, all of
// one const-mode solve (same grid, block shape and drows).
int bis_super_solve_mega_f32(int device, const BisSuperLevelArgs* levels,
                             int n_levels, int block_x, int block_y,
                             int max_blocks, const float* y, float* x,
                             const float* drows, void* stream) {
    return launch_mega<float>(device, levels, n_levels, block_x, block_y,
                              max_blocks, y, x, drows, (cudaStream_t)stream);
}

int bis_super_solve_mega_f64(int device, const BisSuperLevelArgs* levels,
                             int n_levels, int block_x, int block_y,
                             int max_blocks, const double* y, double* x,
                             const double* drows, void* stream) {
    return launch_mega<double>(device, levels, n_levels, block_x, block_y,
                               max_blocks, y, x, drows, (cudaStream_t)stream);
}

// The one-launch solve's grid for this block shape and dtype (8 or 4
// bytes): blocks co-resident on the card, capped at max_blocks.
int bis_super_solve_mega_grid(int device, int threads, int max_blocks,
                              int itemsize) {
    if (set_device(device) != cudaSuccess) return 0;
    return itemsize == 8 ? mega_grid<double>(device, threads, max_blocks)
                         : mega_grid<float>(device, threads, max_blocks);
}

int bis_rank_level_f32(int device, const float* y, float* x,
                       const float* vals, const float* dinv,
                       const long long* groups, int n_groups, long long M,
                       int c, void* stream) {
    return launch_rank_level<float>(device, y, x, vals, dinv, groups,
                                    n_groups, M, c, (cudaStream_t)stream);
}

int bis_rank_level_f64(int device, const double* y, double* x,
                       const double* vals, const double* dinv,
                       const long long* groups, int n_groups, long long M,
                       int c, void* stream) {
    return launch_rank_level<double>(device, y, x, vals, dinv, groups,
                                     n_groups, M, c, (cudaStream_t)stream);
}

int bis_super_level_args_size(void) { return (int)sizeof(BisSuperLevelArgs); }

}  // extern "C"
