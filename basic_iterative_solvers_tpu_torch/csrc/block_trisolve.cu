// Levels of the coloured triangular solves, for Hopper (sm_90a): the
// superblock levels, in const mode (exact GS on a stencil, or on host CSR
// whose legs are constant), factor-table mode (exact ILU(0) on a stencil)
// and plane mode (factors built from host CSR), fused in one launch a
// level or split into an acc step and one step per x-parity; a whole
// const-mode solve in one cooperative launch (super_solve_mega_kernel, the
// "direct" route, and super_solve_brick_kernel, the "brick" route, which
// keeps x in shared memory for the whole solve);
// and the rank-space level of host-CSR factors under a mod or grid
// colouring (rank_level_kernel, the "scalar" route, and
// rank_level_vec_kernel, the "vec" route, below).
//
// Replaces the Pallas kernels of basic_iterative_solvers_tpu/ops/
// block_trisolve.py: _super_level_pallas in its const, plane, packed and
// flat-IO modes (super_level_kernel, the "direct" route; the "staged"
// route of factor-table mode, super_level_staged_kernel; the "line" route
// of plane and const modes, super_level_line_kernel), and its mesh form
// (row0 on the shards of _solve_super_mesh: the same kernels on one
// shard's window, below), the split-mode pair _super_acc_pallas
// (super_acc_kernel, the "direct" route; super_acc_staged_kernel and
// super_acc_line_kernel) and _super_parity_pallas (super_parity_kernel;
// super_parity_staged_kernel and super_parity_line_kernel), and
// _super_solve_pallas_mega (super_solve_mega_kernel; super_solve_brick_
// kernel).  The plain forms are ops/block_trisolve.py's
// super_level_plain, super_level_halo_plain, super_acc_plain,
// super_parity_plain and super_solve_mega_plain.
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
// One shard of a row-sharded mesh (ops/block_trisolve.super_level_halo):
// the shard owns a contiguous range of whole x-lines, so the superblock's
// lines it owns are a contiguous range [line0, line0 + lines) of the
// superblock's line index.  It passes y as its own rows (global row
// y_row0 first), x as its window (global row x_row0 first: its left
// neighbour's last halo rows, its own rows, its right neighbour's first),
// the per-row 1/D on y's rows, and the plane values of its own slots
// (global slot slot0 first, plane_m slots a group).  Masks, classes,
// parities and a plane group's [0, m) test use global coordinates; the
// launch writes only the shard's own rows.  The single-device launch is
// the case line0 = 0, lines = all, every offset 0 and plane_m = m.
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
// visible to the next; its "brick" route keeps each block's brick of x in
// shared memory from the first level to the last (see there).
//
// The "direct" route (super_level_kernel, the first port's): a block of
// 256 threads holds 256 / block_x lines, block_x = min(128, nx rounded
// up to a warp), whatever the launch.  What bounds it on the card: like
// the SpMV, the per-row leg loop with a six-way bounds check and 64-bit
// offsets per leg, here over 1/S of the rows per launch, plus in
// factor-table mode the class computation and one table load (from L2)
// per leg, in plane mode one plane value per group and three 64-bit
// divisions per cross group and row (slot_row); each level reads its rows
// of y and the solved neighbours of x (from L2 at 128^3, from HBM at
// 384^3) and writes its rows of x twice (acc, then the solution); only
// 1/sx of a block's threads work in each parity step, each with a runtime
// % per self leg.  On the launches of a mesh shard the block shape stays
// the single device's: a 128-line shard of fdm:2048 runs 64 blocks, each
// thread 16 rows a pass, and 8 shard launches cost 8 of one level.
//
// Factor-table mode has a second fused route, "staged", in float32
// (super_level_staged_kernel; ops/block_trisolve.level_route_for picks it
// where its shared memory fits and its grid has a block an SM, the direct
// route elsewhere and in float64).  At 384^3 the direct route ran at ~10x
// its bound, and a level with no cross leg took as long as 0.4 of one
// with 24: the kernel is bound by the instructions it issues, not by HBM.
// The staged route:
//   - stages, once per line, the factors of the line's (y, z) class for
//     every leg and x-class and U's pivots in shared memory (~1.9 KB a
//     line for HPCG), each x's class once per block; a warp owns a line;
//   - gives an interior row (every cross leg's source in the grid: the
//     line inside the cross reach in y and z, x inside it too) a leg loop
//     unrolled at compile time to the level's bucket of cross legs, with
//     no bounds test and 32-bit offsets from the row's x, its x loads
//     issued before the arithmetic; edge rows keep the tested loop;
//   - keeps acc and the solved x in the block's line buffer in shared
//     memory: the parity passes read and write it there, every thread on
//     a row of the parity, the self legs' parity test once per pass; x is
//     written to global memory once.
//
// Plane and const modes have a second fused route, "line"
// (super_level_line_kernel), in both types, for single-device and mesh
// shard launches alike:
//   - the launch decides the block, not nx (ops/block_trisolve.
//     line_shape): tl threads a line, the most that keep the launch
//     within one wave of the card's resident threads (132 SMs x 1,024),
//     a power of two from a warp up to one a row; lb lines a block,
//     doubled while the block stays within 256 threads and the grid has
//     a block an SM.  fdm:2048: 128 threads a line on one device (1,024
//     lines), 1,024 on a shard's 128 lines; 128^3: 32 threads and 8 lines
//     a block (scripts/superblock_line_sweep.py timed every block);
//   - the block's lines live in shared memory (8 KB a 2,048-wide line in
//     float32): acc goes there, the parity passes read and write it
//     there, x is written to global memory once;
//   - every thread works in every parity pass (thread k of a line on rows
//     p + sx*k, p + sx*(k + tl), ...), the self legs' solved parities one
//     bitmask a pass: no % in any per-row path;
//   - plane mode computes no source row per row: the host splits a cross
//     group's delta = q*nx + r (0 <= r < nx); per line and group the block
//     works out, from src's (y, z) phases, the offsets of source lines
//     line + q and line + q + 1, or that one leaves [0, m) (it reads 0);
//     a row at x reads the first at x + r where x + r < nx, else the
//     second at x + r - nx: slot_row's map, wraps included;
//   - const mode unrolls an interior row's cross legs to the level's
//     bucket with no bounds test (as the staged route does); edge rows
//     keep the tested loop; the per-row 1/D is read once a row.
// ops/block_trisolve.level_route_for takes the line route where a
// launch's rows fill the card's resident threads (lines x nx >= SMs x
// 1,024) and a line fits 48 KB; the direct route elsewhere (the 8 launches
// of a 128^3 shard level, 512 lines each, ran 10-13% faster on it).
//
// The split route's acc and parity steps (super_acc_kernel and
// super_parity_kernel are their "direct" route, the first port's) have a
// route of their own in each mode, taken where the fused level takes its
// staged or line route (ops/block_trisolve.split_route_for: the fused
// level's route, but a factor table's parity step in float64 takes the
// staged route where the float32 level does, and its acc step stays
// direct, as the fused float64 levels do):
//   - "staged" (factor-table mode): super_acc_staged_kernel runs the
//     staged fused kernel's cross half (staged_cross_line: a warp a line,
//     the line's cross-leg factors and each x's class in shared memory,
//     interior rows unrolled to the bucket with 32-bit offsets, edge rows
//     tested) and writes acc once, coalesced, in slot order;
//     super_parity_staged_kernel stages each line's self-leg factors and
//     pivots and runs the staged parity pass (staged_parity_rows).  Both
//     walk the lines persistently (a grid of the blocks resident at once)
//     and restage a line slot only where the (y, z) class changes;
//   - "line" (plane mode): super_acc_line_kernel runs the line kernel's
//     cross half (line_sources, line_cross_rows: no division a row) on
//     line_shape's block; super_parity_line_kernel the line parity pass
//     (line_parity_rows), the self planes read at the row's slot;
//   - both parity kernels take the block of ops/block_trisolve.
//     parity_shape (the line route's rule on the nx/sx rows of a parity):
//     every thread works, thread k of a line on rows p + sx*k, p + sx*(k
//     + tl), ..., the self legs' solved parities one bitmask a launch, no
//     % in a per-row path; only parity p's rows are written.
// The fused line kernel calls the same bodies as the split line kernels,
// with the block's line buffer in shared memory as acc and x; the fused
// staged kernel keeps its own (calling the staged bodies slowed its 6-leg
// levels, see there).  Measured on the H100 at 384^3, float32
// (scripts/split_route_ab.py, device time in turns): the staged acc step
// 0.30 ms a level (mean) against the direct route's 0.40 (its bound
// 0.068), the staged parity step 0.066-0.069 against 0.153 (62-65% of its
// sector bound); in float64 the staged acc step lost (0.60 against 0.41)
// and the staged parity step won (0.128 against 0.158).  The staged acc
// step takes time in step with the source lines a row reads (0.13, 0.34,
// 0.41 ms for 2, 6, 8), not with its load instructions: forms that read
// each source line once a warp (the dx = +-1 legs by warp shuffles from
// the dx = 0 load) or a thread (16 bytes of rows a thread, the two
// neighbours loaded or shuffled in) tied or lost (0.306-0.361 against
// 0.300-0.314 in the same runs), so none is kept.
// Every route keeps the plain version's order of differences and
// products, each rounded alone, so each level stays bit-equal to it and
// to the direct route.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cstdint>
#include <cstring>

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bis_device.cuh"

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
    long long y_row0, x_row0;               // global row of y[0], x[0]
    long long slot0, plane_m;               // plane mode: global slot of a
                                            // plane's [0], slots a group
    int cross_dx[BIS_SL_MAX_LEGS];
    int cross_dy[BIS_SL_MAX_LEGS];
    int cross_dz[BIS_SL_MAX_LEGS];
    int self_dx[BIS_SL_MAX_LEGS];
    int n_cross, n_self;
    int nx, ny, nz, sx, sy, sz;
    int py, pz;                             // the superblock's (y, z) phases
    int my, lines;                          // ny / sy, lines of the launch
    int line0;                              // its first superblock line
    int upper;
    int block_x, block_y, grid_x;
    int cross_kd[BIS_SL_MAX_LEGS];          // factor-table mode: table rows
    int self_kd[BIS_SL_MAX_LEGS];
    int proto_x, proto_y, proto_z;          // prototype grid
    int radius, n_proto;                    // class radius, proto_x*y*z
    int cross_spy[BIS_SL_MAX_LEGS];         // plane mode: source phases
    int cross_spz[BIS_SL_MAX_LEGS];
    int mode;                               // BIS_SL_CONST, _TABLE, _PLANE
    int cross_rx, cross_ry, cross_rz;       // max |d| of the cross legs
    int cross_q[BIS_SL_MAX_LEGS];           // plane mode: delta = q*nx + r,
    int cross_r[BIS_SL_MAX_LEGS];           // 0 <= r < nx (line route)
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

// acc = y - sum_cross f * x[source], legs (groups) in order, for the row
// at y[iy] and x[ix] whose global slot is t.
template <typename T, int MODE>
__device__ __forceinline__ T cross_sum(const BisSuperLevelArgs& a,
                                       const T* y, const T* x, const T* table,
                                       const T* vc, long long iy, long long ix,
                                       long long t, int gx, int gy, int gz,
                                       int base) {
    T acc = y[iy];
    for (int l = 0; l < a.n_cross; ++l) {
        if (MODE == BIS_SL_PLANE) {
            const long long s = t + a.cross_delta[l];
            const T xv = (s >= 0 && s < a.m)
                ? x[slot_row(a, s, a.cross_spy[l], a.cross_spz[l]) - a.x_row0]
                : T(0);
            acc = sub_rn(acc, mul_rn(vc[l * a.plane_m + t - a.slot0], xv));
            continue;
        }
        const int px = gx + a.cross_dx[l], py = gy + a.cross_dy[l],
                  pz = gz + a.cross_dz[l];
        if (px >= 0 && px < a.nx && py >= 0 && py < a.ny && pz >= 0 &&
            pz < a.nz) {
            const T f = MODE == BIS_SL_TABLE
                ? table[(long long)a.cross_kd[l] * a.n_proto + base]
                : T(a.cross_coeff[l]);
            acc = sub_rn(acc, mul_rn(f, x[ix + a.cross_off[l]]));
        }
    }
    return acc;
}

// (v - sum_self f * x[ix + dx]) * dinv on a parity-p row (global slot t;
// its 1/D at drows[iy]).
template <typename T, int MODE>
__device__ __forceinline__ T parity_update(const BisSuperLevelArgs& a, int p,
                                           T v, const T* x, const T* table,
                                           const T* tdinv, const T* vs,
                                           const T* drows, long long iy,
                                           long long ix, long long t, int gx,
                                           int base) {
    for (int l = 0; l < a.n_self; ++l) {
        const int px = gx + a.self_dx[l];
        const bool solved = px >= 0 && px < a.nx &&
                            (a.upper ? px % a.sx > p : px % a.sx < p);
        if (MODE == BIS_SL_PLANE) {
            v = sub_rn(v, mul_rn(vs[l * a.plane_m + t - a.slot0],
                                 solved ? x[ix + a.self_dx[l]] : T(0)));
            continue;
        }
        if (!solved) continue;
        const T f = MODE == BIS_SL_TABLE
            ? table[(long long)a.self_kd[l] * a.n_proto + base]
            : T(a.self_coeff[l]);
        v = sub_rn(v, mul_rn(f, x[ix + a.self_dx[l]]));
    }
    if (MODE == BIS_SL_TABLE) return tdinv ? mul_rn(v, tdinv[base]) : v;
    return mul_rn(v, drows ? drows[iy] : T(a.dinv));
}

struct LevelRow {
    bool live;
    int gy, gz;
    long long row;                          // global row of the line's x = 0
    long long slot;                         // global slot of the line's x = 0
    long long iy, ix;                       // row - y_row0, row - x_row0
};

// Line line0 + k of the level's superblock (k < lines: live).
__device__ __forceinline__ LevelRow level_line(const BisSuperLevelArgs& a,
                                               int k) {
    LevelRow r;
    const int line = a.line0 + k;
    r.live = k < a.lines;
    r.gy = a.sy * (line % a.my) + a.py;
    r.gz = a.sz * (line / a.my) + a.pz;
    r.row = (long long)a.nx * (r.gy + (long long)a.ny * r.gz);
    r.slot = (long long)line * a.nx;
    r.iy = r.row - a.y_row0;
    r.ix = r.row - a.x_row0;
    return r;
}

// Line line0 + block * block_y + threadIdx.y of the level's superblock.
__device__ __forceinline__ LevelRow level_row(const BisSuperLevelArgs& a,
                                              int block) {
    return level_line(a, block * a.block_y + threadIdx.y);
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
            x[r.ix + gx] = cross_sum<T, MODE>(a, y, x, table, vc, r.iy + gx,
                                              r.ix + gx, r.slot + gx, gx,
                                              r.gy, r.gz, base);
        }
    }
    __syncthreads();
    for (int step = 0; step < a.sx; ++step) {
        const int p = a.upper ? a.sx - 1 - step : step;
        if (r.live) {
            for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
                if (gx % a.sx != p) continue;
                const long long i = r.ix + gx;
                const int base = MODE == BIS_SL_TABLE
                    ? class_base(a, gx, r.gy, r.gz) : 0;
                x[i] = parity_update<T, MODE>(a, p, x[i], x, table, tdinv, vs,
                                              drows, r.iy + gx, i,
                                              r.slot + gx, gx, base);
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

// Factor-table mode, staged route (see the top of the file).  Its own
// block shape: bx = min(32, nx rounded up to a warp) threads along x,
// 256 / bx lines a block, one line a row of threads: a warp a line (32
// wide ran faster than 64 at 128^3 and 384^3: more rows a thread over the
// same per-thread set-up).  Dynamic shared memory: the block's lines
// (256 / bx x nx values), the x-class of each x (nx ints, padded to 16
// bytes) and each line's factors of every leg and x-class and its pivots
// ((n_legs + 1) x proto_x values a line; staged, they ran faster than
// reads of the table through L1).  NCB is the cross-leg bucket: interior
// rows unroll NCB predicated legs (0, 8, 16, 24 or 27), so a level with
// few cross legs issues no instructions for the rest.  Its registers are
// sized for 4 blocks an SM (__launch_bounds__): that holds the 24-leg
// bucket to 64 registers, where it runs fastest (left to itself ptxas
// gives it 95, 2 blocks an SM; sized for 5 or more it spills).
#define BIS_SL_STAGED_BX 32
#define BIS_SL_MIN_BLOCKS 4

// The most dynamic shared memory a staged launch takes (no opt-in needed).
#define BIS_SL_STAGED_SMEM_MAX (48 * 1024)

static int staged_bx(const BisSuperLevelArgs& a) {
    const int warps = (a.nx + 31) / 32 * 32;
    return warps < BIS_SL_STAGED_BX ? warps : BIS_SL_STAGED_BX;
}

static size_t staged_smem(const BisSuperLevelArgs& a) {
    const size_t lines = 256 / staged_bx(a);
    return lines * a.nx * sizeof(float)
           + (size_t)((a.nx + 3) & ~3) * sizeof(int)
           + lines * (a.n_cross + a.n_self + 1) * a.proto_x * sizeof(float);
}

// The bodies of the staged and line routes.  The fused line kernel calls
// line_sources, line_cross_rows and line_parity_rows with the block's
// line buffer in shared memory as acc and x, the split line kernels with
// acc and x in global memory.  The staged bodies are the fused staged
// kernel's cross half and parity pass (that kernel keeps its own copy:
// see there), called by the split staged kernels.  Each keeps the plain
// version's order of differences and products.

// The block's x-classes: cls[gx] for every x of a line.
__device__ __forceinline__ void stage_classes(const BisSuperLevelArgs& a,
                                              int* cls) {
    const int nt = blockDim.x * blockDim.y;
    for (int gx = threadIdx.y * blockDim.x + threadIdx.x; gx < a.nx;
         gx += nt)
        cls[gx] = proto_class(gx, a.nx, a.proto_x, a.sx, a.radius);
}

// A line's (y, z) class: the offset of its x-class 0 in a table row.
__device__ __forceinline__ int line_class(const BisSuperLevelArgs& a,
                                          const LevelRow& r) {
    return a.proto_x * (proto_class(r.gy, a.ny, a.proto_y, a.sy, a.radius)
                        + a.proto_y * proto_class(r.gz, a.nz, a.proto_z,
                                                  a.sz, a.radius));
}

// The line's factors of legs [l0, l1) of (cross legs, then self legs):
// fac[(l - l0) * Px + cx] at x-class cx; then, where tdinv, U's pivots at
// fac[(l1 - l0) * Px + cx].  By the line's threads (lane of nlanes).
template <typename T>
__device__ __forceinline__ void stage_factors(const BisSuperLevelArgs& a,
                                              int cyz, const T* table,
                                              const T* tdinv, T* fac, int l0,
                                              int l1, int lane, int nlanes) {
    const int Px = a.proto_x;
    for (int l = l0; l < l1; ++l) {
        const T* const row = table + (long long)(
            l < a.n_cross ? a.cross_kd[l] : a.self_kd[l - a.n_cross])
            * a.n_proto + cyz;
        for (int c = lane; c < Px; c += nlanes)
            fac[(l - l0) * Px + c] = row[c];
    }
    if (tdinv)
        for (int c = lane; c < Px; c += nlanes)
            fac[(l1 - l0) * Px + c] = tdinv[cyz + c];
}

// The self legs whose source parity (p + dx) mod sx is solved: one bit a
// leg, worked out once a pass, so no row takes a %.
__device__ __forceinline__ unsigned solved_mask(const BisSuperLevelArgs& a,
                                                int p) {
    unsigned solved = 0;
    for (int l = 0; l < a.n_self; ++l) {
        int q = (p + a.self_dx[l]) % a.sx;
        q += q < 0 ? a.sx : 0;
        if (a.upper ? q > p : q < p) solved |= 1u << l;
    }
    return solved;
}

__device__ __forceinline__ bool line_inside(const BisSuperLevelArgs& a,
                                            const LevelRow& r) {
    return r.gy >= a.cross_ry && r.gy < a.ny - a.cross_ry
           && r.gz >= a.cross_rz && r.gz < a.nz - a.cross_rz;
}

// Staged cross half of the row at x = gx: y - sum_cross f * x, factors
// from the line's staged ones.  Interior rows: the bucket's legs
// unrolled, no bounds test, 32-bit offsets, loads before the arithmetic;
// edge rows: the tested loop.
template <typename T, int NCB>
__device__ __forceinline__ T staged_cross_row(const BisSuperLevelArgs& a,
                                              const LevelRow& r, bool line_in,
                                              const int* cls, const T* fac,
                                              const T* y, const T* x,
                                              int gx) {
    const int nx = a.nx, Px = a.proto_x, nc = a.n_cross;
    T acc = y[r.iy + gx];
    if (NCB > 0) {
        const int cx = cls[gx];
        const T* const xr = x + (r.ix + gx);
        if (line_in && gx >= a.cross_rx && gx < nx - a.cross_rx) {
            T xv[NCB > 0 ? NCB : 1];
#pragma unroll
            for (int l = 0; l < NCB; ++l)
                if (l < nc) xv[l] = __ldg(xr + (int)a.cross_off[l]);
#pragma unroll
            for (int l = 0; l < NCB; ++l)
                if (l < nc)
                    acc = sub_rn(acc, mul_rn(fac[l * Px + cx], xv[l]));
        } else {
            for (int l = 0; l < nc; ++l) {
                const int px = gx + a.cross_dx[l], py = r.gy + a.cross_dy[l],
                          pz = r.gz + a.cross_dz[l];
                if (px >= 0 && px < nx && py >= 0 && py < a.ny && pz >= 0 &&
                    pz < a.nz)
                    acc = sub_rn(acc, mul_rn(fac[l * Px + cx],
                                             xr[(int)a.cross_off[l]]));
            }
        }
    }
    return acc;
}

// The staged cross half of a line into out[gx] (lane of nlanes).
template <typename T, int NCB>
__device__ __forceinline__ void staged_cross_line(
        const BisSuperLevelArgs& a, const LevelRow& r, const int* cls,
        const T* fac, const T* y, const T* x, T* out, int lane, int nlanes) {
    const bool line_in = line_inside(a, r);
    for (int gx = lane; gx < a.nx; gx += nlanes)
        out[gx] = staged_cross_row<T, NCB>(a, r, line_in, cls, fac, y, x, gx);
}

// Staged parity pass: parity p's rows of a line, thread k of tl on rows
// p + sx*k, p + sx*(k + tl), ...: out[gx] = (v[gx] - sum_self f *
// xs[gx + dx]) (times the pivot where `pivot`), fsel the line's staged
// self-leg factors, then its pivots.
template <typename T>
__device__ __forceinline__ void staged_parity_rows(
        const BisSuperLevelArgs& a, int p, unsigned solved, const int* cls,
        const T* fsel, bool pivot, const T* v_in, const T* xs, T* out, int k,
        int tl) {
    const int nx = a.nx, sx = a.sx, Px = a.proto_x, ns = a.n_self;
    for (int gx = p + sx * k; gx < nx; gx += sx * tl) {
        const int cx = cls[gx];
        T v = v_in[gx];
        for (int l = 0; l < ns; ++l) {
            const int px = gx + a.self_dx[l];
            if ((solved >> l & 1u) && px >= 0 && px < nx)
                v = sub_rn(v, mul_rn(fsel[l * Px + cx], xs[px]));
        }
        out[gx] = pivot ? mul_rn(v, fsel[ns * Px + cx]) : v;
    }
}

// The fused staged kernel keeps a body of its own: built from the staged
// bodies above, its 6-leg levels at 384^3 ran 7.5-11% slower (the fused
// levels of this file and of its parent commit timed in turns, scripts/
// split_route_ab.py --fused), beyond that run's 1% spread.
template <typename T, int NCB>
__global__ void __launch_bounds__(256, BIS_SL_MIN_BLOCKS)
super_level_staged_kernel(const __grid_constant__ BisSuperLevelArgs a,
                          const T* y, T* x, const T* __restrict__ table,
                          const T* __restrict__ tdinv) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nx = a.nx, Px = a.proto_x, bx = blockDim.x;
    const int nc = a.n_cross, ns = a.n_self;
    T* const lines = reinterpret_cast<T*>(smem_raw);
    int* const cls = reinterpret_cast<int*>(lines + blockDim.y * nx);
    const int tid = threadIdx.y * bx + threadIdx.x;
    for (int gx = tid; gx < nx; gx += bx * blockDim.y)
        cls[gx] = proto_class(gx, nx, Px, a.sx, a.radius);
    const LevelRow r = level_line(a, blockIdx.x * blockDim.y + threadIdx.y);
    // the line's factors: fac[l * Px + cx] of leg l (cross legs, then self
    // legs) at x-class cx; fac[(nc + ns) * Px + cx] its pivot
    T* const fac = reinterpret_cast<T*>(cls + ((nx + 3) & ~3))
                   + threadIdx.y * (nc + ns + 1) * Px;
    if (r.live) {
        const int cyz = Px * (proto_class(r.gy, a.ny, a.proto_y, a.sy,
                                          a.radius)
                              + a.proto_y * proto_class(r.gz, a.nz, a.proto_z,
                                                        a.sz, a.radius));
        for (int l = 0; l < nc + ns; ++l) {
            const T* const row = table + (long long)(
                l < nc ? a.cross_kd[l] : a.self_kd[l - nc]) * a.n_proto
                + cyz;
            for (int c = threadIdx.x; c < Px; c += bx)
                fac[l * Px + c] = row[c];
        }
        if (tdinv)
            for (int c = threadIdx.x; c < Px; c += bx)
                fac[(nc + ns) * Px + c] = tdinv[cyz + c];
    }
    __syncthreads();
    T* const line = lines + threadIdx.y * nx;
    if (r.live) {
        const bool line_in = r.gy >= a.cross_ry && r.gy < a.ny - a.cross_ry
                             && r.gz >= a.cross_rz
                             && r.gz < a.nz - a.cross_rz;
        for (int gx = threadIdx.x; gx < nx; gx += bx) {
            T acc = y[r.iy + gx];
            if (NCB > 0) {
                const int cx = cls[gx];
                const T* const xr = x + (r.ix + gx);
                if (line_in && gx >= a.cross_rx && gx < nx - a.cross_rx) {
                    T xv[NCB > 0 ? NCB : 1];
#pragma unroll
                    for (int l = 0; l < NCB; ++l)
                        if (l < nc) xv[l] = __ldg(xr + (int)a.cross_off[l]);
#pragma unroll
                    for (int l = 0; l < NCB; ++l)
                        if (l < nc)
                            acc = sub_rn(acc, mul_rn(fac[l * Px + cx],
                                                     xv[l]));
                } else {
                    for (int l = 0; l < nc; ++l) {
                        const int px = gx + a.cross_dx[l],
                                  py = r.gy + a.cross_dy[l],
                                  pz = r.gz + a.cross_dz[l];
                        if (px >= 0 && px < nx && py >= 0 && py < a.ny &&
                            pz >= 0 && pz < a.nz)
                            acc = sub_rn(acc, mul_rn(
                                fac[l * Px + cx], xr[(int)a.cross_off[l]]));
                    }
                }
            }
            line[gx] = acc;
        }
    }
    __syncthreads();
    for (int step = 0; step < a.sx; ++step) {
        const int p = a.upper ? a.sx - 1 - step : step;
        // the self legs whose source parity (p + dx) mod sx is solved
        unsigned solved = 0;
        for (int l = 0; l < ns; ++l) {
            int q = (p + a.self_dx[l]) % a.sx;
            q += q < 0 ? a.sx : 0;
            if (a.upper ? q > p : q < p) solved |= 1u << l;
        }
        if (r.live) {
            for (int gx = p + a.sx * threadIdx.x; gx < nx; gx += a.sx * bx) {
                const int cx = cls[gx];
                T v = line[gx];
                for (int l = 0; l < ns; ++l) {
                    const int px = gx + a.self_dx[l];
                    if ((solved >> l & 1u) && px >= 0 && px < nx)
                        v = sub_rn(v, mul_rn(fac[(nc + l) * Px + cx],
                                             line[px]));
                }
                line[gx] = tdinv ? mul_rn(v, fac[(nc + ns) * Px + cx]) : v;
            }
        }
        __syncthreads();
    }
    if (r.live)
        for (int gx = threadIdx.x; gx < nx; gx += bx)
            x[r.ix + gx] = line[gx];
}

// Plane and const modes, line route (see the top of the file).  Block
// (tl, lb): lb lines, tl threads a line, both chosen by the wrapper
// (ops/block_trisolve.line_shape).  Dynamic shared memory: the block's
// lines (lb x nx values) and, in plane mode, each line's two source
// offsets per cross group (lb x 2 x n_cross ints).  NCB is the cross-leg
// (group) bucket, as in the staged kernel.
#define BIS_SL_LINE_SMEM_MAX (48 * 1024)
#define BIS_SL_LINE_THREADS 1024
// A plane group's source line outside the superblock: the slot reads 0.
#define BIS_SL_NO_SOURCE (-2147483647 - 1)

static size_t line_smem(const BisSuperLevelArgs& a, int lb, size_t item) {
    const size_t groups = a.mode == BIS_SL_PLANE
        ? (size_t)2 * a.n_cross * sizeof(int) : 0;
    return (size_t)lb * ((size_t)a.nx * item + groups);
}

// Plane mode: src[2l + h], the offset from x[ix] of line k + q_l + h's
// row at x = r_l (h = 1 less nx), for the rows at x < nx - r_l (h = 0)
// and the rest; BIS_SL_NO_SOURCE where that line leaves the superblock.
// Line k of the launch, by its threads (lane of nlanes).
__device__ __forceinline__ void line_sources(const BisSuperLevelArgs& a,
                                             const LevelRow& r, int k,
                                             int* src, int lane, int nlanes) {
    const int nx = a.nx;
    const long long lines_m = a.m / nx;
    for (int l = lane; l < a.n_cross; l += nlanes) {
        for (int h = 0; h < 2; ++h) {
            const long long sl = (long long)a.line0 + k + a.cross_q[l] + h;
            int e = BIS_SL_NO_SOURCE;
            if (sl >= 0 && sl < lines_m) {
                const long long gy = (long long)a.sy * (sl % a.my)
                                     + a.cross_spy[l];
                const long long gz = (long long)a.sz * (sl / a.my)
                                     + a.cross_spz[l];
                e = (int)(nx * (gy + (long long)a.ny * gz) - r.row)
                    + a.cross_r[l] - h * nx;
            }
            src[2 * l + h] = e;
        }
    }
}

// The line route's cross half of a line into out[gx] (lane of nlanes):
// plane mode through the line's source offsets (no division a row), const
// mode with interior rows unrolled to the bucket and edge rows tested.
template <typename T, int MODE, int NCB>
__device__ __forceinline__ void line_cross_rows(
        const BisSuperLevelArgs& a, const LevelRow& r, const int* src,
        const T* y, const T* x, const T* vc, T* out, int lane, int nlanes) {
    const int nx = a.nx, nc = a.n_cross;
    const bool line_in = line_inside(a, r);
    for (int gx = lane; gx < nx; gx += nlanes) {
        T acc = y[r.iy + gx];
        const T* const xr = x + (r.ix + gx);
        if (MODE == BIS_SL_PLANE) {
            const T* const vr = vc + (r.slot - a.slot0 + gx);
#pragma unroll
            for (int l = 0; l < NCB; ++l) {
                if (l < nc) {
                    const int e = src[2 * l + (gx + a.cross_r[l] < nx
                                               ? 0 : 1)];
                    const T xv = e != BIS_SL_NO_SOURCE
                        ? xr[e != BIS_SL_NO_SOURCE ? e : 0] : T(0);
                    acc = sub_rn(acc, mul_rn(vr[l * a.plane_m], xv));
                }
            }
        } else if (line_in && gx >= a.cross_rx && gx < nx - a.cross_rx) {
#pragma unroll
            for (int l = 0; l < NCB; ++l)
                if (l < nc)
                    acc = sub_rn(acc, mul_rn(T(a.cross_coeff[l]),
                                             xr[(int)a.cross_off[l]]));
        } else {
            for (int l = 0; l < nc; ++l) {
                const int px = gx + a.cross_dx[l], py = r.gy + a.cross_dy[l],
                          pz = r.gz + a.cross_dz[l];
                if (px >= 0 && px < nx && py >= 0 && py < a.ny && pz >= 0
                    && pz < a.nz)
                    acc = sub_rn(acc, mul_rn(T(a.cross_coeff[l]),
                                             xr[(int)a.cross_off[l]]));
            }
        }
        out[gx] = acc;
    }
}

// The line route's parity pass: parity p's rows of a line, thread k of tl
// on rows p + sx*k, p + sx*(k + tl), ...: out[gx] = (v[gx] - sum_self f *
// xs[gx + dx]) * dinv, plane mode's f from the self planes at the row's
// slot (every plane's value multiplied, 0 where its source is unsolved),
// const mode's the leg's coefficient; dinv the per-row 1/D or the scalar.
template <typename T, int MODE>
__device__ __forceinline__ void line_parity_rows(
        const BisSuperLevelArgs& a, int p, unsigned solved, const LevelRow& r,
        const T* v_in, const T* xs, T* out, const T* vs, const T* drows,
        int k, int tl) {
    const int nx = a.nx, sx = a.sx, ns = a.n_self;
    for (int gx = p + sx * k; gx < nx; gx += sx * tl) {
        T v = v_in[gx];
        for (int l = 0; l < ns; ++l) {
            const int px = gx + a.self_dx[l];
            const bool ok = (solved >> l & 1u) && px >= 0 && px < nx;
            if (MODE == BIS_SL_PLANE)
                v = sub_rn(v, mul_rn(
                    vs[l * a.plane_m + (r.slot - a.slot0 + gx)],
                    ok ? xs[ok ? px : gx] : T(0)));
            else if (ok)
                v = sub_rn(v, mul_rn(T(a.self_coeff[l]), xs[px]));
        }
        out[gx] = mul_rn(v, drows ? drows[r.iy + gx] : T(a.dinv));
    }
}

template <typename T, int MODE, int NCB>
__global__ void __launch_bounds__(BIS_SL_LINE_THREADS)
super_level_line_kernel(const __grid_constant__ BisSuperLevelArgs a,
                        const T* y, T* x, const T* __restrict__ vc,
                        const T* __restrict__ vs,
                        const T* __restrict__ drows) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nx = a.nx, tl = blockDim.x;
    const int k = blockIdx.x * blockDim.y + threadIdx.y;
    const LevelRow r = level_line(a, k);
    T* const line = reinterpret_cast<T*>(smem_raw) + threadIdx.y * nx;
    int* const src = reinterpret_cast<int*>(
        reinterpret_cast<T*>(smem_raw) + blockDim.y * nx)
        + threadIdx.y * 2 * a.n_cross;
    if (MODE == BIS_SL_PLANE && r.live)
        line_sources(a, r, k, src, threadIdx.x, tl);
    __syncthreads();
    if (r.live)
        line_cross_rows<T, MODE, NCB>(a, r, src, y, x, vc, line, threadIdx.x,
                                      tl);
    __syncthreads();
    for (int step = 0; step < a.sx; ++step) {
        const int p = a.upper ? a.sx - 1 - step : step;
        const unsigned solved = solved_mask(a, p);
        if (r.live)
            line_parity_rows<T, MODE>(a, p, solved, r, line, line, line, vs,
                                      drows, threadIdx.x, tl);
        __syncthreads();
    }
    if (r.live)
        for (int gx = threadIdx.x; gx < nx; gx += tl)
            x[r.ix + gx] = line[gx];
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

// The one-launch const solve's "brick" route (super_solve_brick_kernel;
// ops/block_trisolve.mega_route_for picks it, brick_shape sizes it).  The
// TPU kernel keeps the whole solve's x in VMEM across its (levels, row
// tiles) grid; here each block of a persistent, co-resident grid (at most
// one wave, a block an SM) owns a brick: a fixed box of by x bz (y, z)
// x-lines, every x of each, by and bz multiples of sy and sz so that
// every superblock owns the same number of a brick's lines.  The brick's
// x lives in dynamic shared memory for the whole solve, framed by the
// legs' reach: (by + 2ry) x (bz + 2rz) lines of nx + 2rx values (at
// 128^3: 128 bricks of 16 x 8 lines, a frame of 52 lines, 91 KB in
// float32 and 183 KB in float64 a brick).  The same block solves the same
// brick at every level:
//   - set-up: the block's part of the brick tables (built by the wrapper
//     once a solve: each level's scalars, coefficients and 1/D in the
//     vectors' type, each cross leg's offset in the framed brick, the same
//     from every row, and for this brick each level line's place and row
//     and the frame lines the level reads) and the brick's y, into its
//     place, come in by asynchronous copies (cp.async), all in flight at
//     once, while the frame and the lines' x margins are zeroed; a level's
//     acc starts from the y there;
//   - per level, the listed frame lines are copied from global x (their
//     owners wrote them at an earlier level, before the last grid
//     barrier); then every row runs the cross legs unrolled to the level's
//     bucket (0, 8, 16, 24, 27), offsets and coefficients in registers,
//     loads issued eight legs at a time, with no bounds test: a source
//     outside the grid reads a 0 of the frame or of a line's x margin,
//     never written, so the row subtracts f * 0 there as the plain version
//     does for its masked legs (the other routes skip the leg; the two can
//     differ only in the sign of a zero);
//   - the parity passes update the rows in place, every thread on rows of
//     each parity, the solved self legs one bitmask a pass, their sources
//     read with no bounds test (the x margin again); a row's solution is
//     written to global x once, in its parity's pass; a per-row 1/D is
//     read once, into a stage in shared memory, by asynchronous copies in
//     flight across the barrier before its level;
//   - levels meet at grid.sync(), none after the last.
// y may alias x (the U solves of SGS and ILU(0) run in place): each block
// reads its brick's y before it writes any row, and the bricks are
// disjoint; a frame line is copied only once its superblock is solved.
// What bounds it: the y read and x written once over the whole solve
// (HBM), the barriers (a launch with WORK false runs the set-up's table
// copy and the barriers alone: the floor), and, at one block of 512
// threads an SM, the latency of each thread's chains of shared-memory
// loads and rounded differences.  On the H100 a first form that kept acc
// in the brick but read the halo through per-(line, leg) pointers (global
// or shared) and sent edge rows down a tested loop ran no faster than the
// per-level launches: a warp holding x = 0 or nx - 1 ran the tested loop
// too.  The frame, the zero margins (every row unrolled), cp.async and
// the tables built by the wrapper are what brought it to about 0.4 of
// them at 128^3 (PERF.md).  Per-brick level flags in place of grid.sync()
// (a brick waiting only for the owners of its frame lines) did not win in
// turns and are not kept.  Every difference and product is rounded
// alone, cross legs in order, then self legs: bit-equal to the plain loop
// and to the other routes.
#define BIS_SB_BRICK_THREADS 512

// The brick tables (ops/block_trisolve.brick_tables builds them once a
// solve): first, for each level, BIS_SB_BRICK_HDR ints of scalars (cross
// legs, self legs, sx, upper), BIS_SB_BRICK_COEF coefficients in the
// vectors' type (cross legs from 0, self legs from BIS_SB_BRICK_COEF / 2,
// 1/D in the last) and BIS_SB_BRICK_OFFS ints (each cross leg's offset in
// the framed brick, (dz (by + 2ry) + dy) (nx + 2rx) + dx, from 0, each
// self leg's dx from BIS_SB_BRICK_OFFS / 2); then, for each brick and
// level, brick_part ints: a (place, row) pair for each of the level's
// lines of the brick (its x = 0 in the framed brick, its global row), the
// count of frame lines to copy, a pad, and a (place, row) pair for each.
#define BIS_SB_BRICK_HDR 16
#define BIS_SB_BRICK_COEF 64
#define BIS_SB_BRICK_OFFS 64

// Lines of a brick's frame window.
__host__ __device__ static size_t brick_window(int by, int bz, int ry,
                                                int rz) {
    return (size_t)(by + 2 * ry) * (bz + 2 * rz);
}

// Ints of a level's shared part and of its part for one brick (the frame
// lines of a whole brick at most: a short brick has fewer), each a
// multiple of 4.
__host__ __device__ static int brick_shared(size_t item) {
    return BIS_SB_BRICK_HDR + BIS_SB_BRICK_COEF * (int)(item / 4)
           + BIS_SB_BRICK_OFFS;
}

__host__ __device__ static int brick_part(int by, int bz, int ry, int rz,
                                          int sy, int sz) {
    const int frame = (int)brick_window(by, bz, ry, rz) - by * bz;
    return (2 * (by / sy) * (bz / sz) + 2 + 2 * frame + 3) & ~3;
}

// Bytes of the 1/D stage (padded to 16).
__host__ __device__ static size_t brick_stage(int by, int bz, int sy, int sz,
                                               int nx, size_t item,
                                               bool drows) {
    return drows ? ((size_t)(by / sy) * (bz / sz) * nx * item + 15)
                   & ~(size_t)15 : 0;
}

// Dynamic shared memory of a brick launch: the block's tables (every
// level's shared part and its brick's part), with a per-row D (drows) a
// stage of a level's 1/D, and the framed brick.
static size_t brick_smem(int n_levels, int by, int bz, int rx, int ry,
                         int rz, int sy, int sz, int nx, size_t item,
                         bool drows) {
    return (size_t)n_levels * (brick_shared(item)
                               + brick_part(by, bz, ry, rz, sy, sz))
               * sizeof(int)
           + brick_stage(by, bz, sy, sz, nx, item, drows)
           + brick_window(by, bz, ry, rz) * (nx + 2 * rx) * item;
}

// The cross half of a level's lines of the brick: acc (the brick holds y
// there) into the row's place, a thread a row of x, lines k =
// threadIdx.y, + blockDim.y, ... (line k at lines[k].x in xs); leg l
// reads the framed brick at offs[l] from the row (a 0 outside the grid).
// (Four rows a thread at once, four chains of differences in flight, ran
// slower on the H100: it takes all 128 registers.)
template <typename T, int NCB>
__device__ __forceinline__ void brick_cross(int nx, int nc, int K,
                                            const T* coef, const int* offs,
                                            const int2* lines, T* xs) {
    // offsets in registers up to the 24-leg bucket, coefficients too in
    // float32 and up to the 16-leg bucket in float64 (more spill); the
    // rest read from shared memory
    constexpr bool HO = NCB <= 24;
    constexpr bool HC = NCB <= (sizeof(T) == 8 ? 16 : 24);
    T c[HC && NCB > 0 ? NCB : 1];
    int o[HO && NCB > 0 ? NCB : 1];
#pragma unroll
    for (int l = 0; l < NCB; ++l)
        if (l < nc) {
            if (HC) c[HC ? l : 0] = coef[l];
            if (HO) o[HO ? l : 0] = offs[l];
        }
    for (int k = threadIdx.y; k < K; k += blockDim.y) {
        T* const line = xs + lines[k].x;
        for (int gx = threadIdx.x; gx < nx; gx += blockDim.x) {
            const T* const xr = line + gx;
            T acc = *xr;
#pragma unroll
            for (int c0 = 0; c0 < NCB; c0 += 8) {
                T xv[8];
#pragma unroll
                for (int l = c0; l < c0 + 8 && l < NCB; ++l)
                    if (l < nc) xv[l - c0] = xr[HO ? o[HO ? l : 0] : offs[l]];
#pragma unroll
                for (int l = c0; l < c0 + 8 && l < NCB; ++l)
                    if (l < nc)
                        acc = sub_rn(acc, mul_rn(HC ? c[HC ? l : 0] : coef[l],
                                                 xv[l - c0]));
            }
            line[gx] = acc;
        }
    }
}

// Parity p's pass over a level's lines of the brick: thread x-lane k on
// rows p + sx*k, p + sx*(k + tl), ..., U at a time (their loads first);
// the self legs (dx sdx[l]) whose source parity is solved (`solved`),
// with HOIST (two legs or fewer) their dx and coefficients in registers,
// else read from shared memory, with no bounds test (a source outside the
// line reads the 0 of its x margin); the row's solution goes to its place
// and to global x (line k's row lines[k].y).
template <typename T, bool HOIST, int U>
__device__ __forceinline__ void brick_parity(int nx, int sx, int ns, int p,
                                             unsigned solved, const T* coef,
                                             const int* sdx, int K,
                                             const int2* lines, T* xs, T* x,
                                             const T* dstage) {
    const int step = sx * blockDim.x;
    const T* const cs = coef + BIS_SB_BRICK_COEF / 2;
    const T dinv = coef[BIS_SB_BRICK_COEF - 1];
    T c[2];
    int dx[2];
    if (HOIST)
#pragma unroll
        for (int l = 0; l < 2; ++l) {
            c[l] = cs[l];
            dx[l] = sdx[l];
        }
    for (int k = threadIdx.y; k < K; k += blockDim.y) {
        const int2 lk = lines[k];
        T* const line = xs + lk.x;
        for (int g0 = p + sx * threadIdx.x; g0 < nx; g0 += U * step) {
            T v[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (g0 + u * step < nx) v[u] = line[g0 + u * step];
            if (HOIST) {
#pragma unroll
                for (int l = 0; l < 2; ++l)
                    if (l < ns && (solved >> l & 1u))
#pragma unroll
                        for (int u = 0; u < U; ++u)
                            if (g0 + u * step < nx)
                                v[u] = sub_rn(v[u], mul_rn(
                                    c[l], line[g0 + u * step + dx[l]]));
            } else {
                for (int l = 0; l < ns; ++l)
                    if (solved >> l & 1u)
#pragma unroll
                        for (int u = 0; u < U; ++u)
                            if (g0 + u * step < nx)
                                v[u] = sub_rn(v[u], mul_rn(
                                    cs[l], line[g0 + u * step + sdx[l]]));
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int gx = g0 + u * step;
                if (gx < nx) {
                    const T w = mul_rn(v[u], dstage ? dstage[k * nx + gx]
                                                    : dinv);
                    line[gx] = w;
                    x[lk.y + gx] = w;
                }
            }
        }
    }
}

// nx values of global memory into shared memory by the threads of a line
// (threadIdx.x), asynchronously (cp.async: no registers, every copy in
// flight at once); the caller commits and waits.
template <typename T>
__device__ __forceinline__ void brick_copy_line(const T* from, T* to,
                                                int nx) {
    for (int gx = threadIdx.x; gx < nx; gx += blockDim.x)
        __pipeline_memcpy_async(to + gx, from + gx, sizeof(T));
}

// A level's per-row 1/D into the stage (line k at dstage[k * nx]),
// asynchronously.
template <typename T>
__device__ __forceinline__ void brick_stage_d(int nx, int K,
                                              const int2* lines,
                                              const T* drows, T* dstage) {
    for (int k = threadIdx.y; k < K; k += blockDim.y)
        brick_copy_line(drows + lines[k].y, dstage + k * nx, nx);
}

// Block b solves brick (b mod nby, b / nby) of by x bz lines at every
// level, framed (rx, ry, rz) deep; block (tl, lb) from
// ops/block_trisolve.brick_shape; `tables` the brick tables.  WORK false:
// the tables and the grid barriers alone (the barrier floor).
template <typename T, bool WORK>
__global__ void __launch_bounds__(BIS_SB_BRICK_THREADS, 1)
super_solve_brick_kernel(const int* tables, int n_levels, int nx, int ny,
                         int nz, int sy, int sz, int by, int bz, int rx,
                         int ry, int rz, const T* y, T* x, const T* drows) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    cg::grid_group grid = cg::this_grid();
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nt = blockDim.x * blockDim.y;
    const int nby = (ny + by - 1) / by;
    const int y0 = (blockIdx.x % nby) * by, z0 = (blockIdx.x / nby) * bz;
    const int ey = min(by, ny - y0), ez = min(bz, nz - z0);
    const int K = (ey / sy) * (ez / sz), kmax = (by / sy) * (bz / sz);
    const int fy = by + 2 * ry, ls = nx + 2 * rx;
    const int shared = brick_shared(sizeof(T));
    const int part = brick_part(by, bz, ry, rz, sy, sz);
    // shared memory: every level's shared part, then its brick's part,
    // the 1/D stage, the framed brick
    int* const tab = reinterpret_cast<int*>(smem_raw);
    int* const own = tab + n_levels * shared;
    T* const dstage = reinterpret_cast<T*>(own + n_levels * part);
    T* const xs = reinterpret_cast<T*>(
        reinterpret_cast<unsigned char*>(dstage)
        + brick_stage(by, bz, sy, sz, nx, sizeof(T), drows != nullptr));
    // every copy of the set-up in flight at once: the tables and the
    // brick's y into its place (cp.async), while the frame lines and the
    // lines' x margins are zeroed (the places y does not fill)
    for (int k = tid; k < n_levels * shared / 4; k += nt)
        __pipeline_memcpy_async(tab + 4 * k, tables + 4 * k, 16);
    {
        const int* const mine = tables + n_levels * shared
                                + blockIdx.x * n_levels * part;
        for (int k = tid; k < n_levels * part / 4; k += nt)
            __pipeline_memcpy_async(own + 4 * k, mine + 4 * k, 16);
    }
    if (WORK) {
        for (int L = threadIdx.y; L < ey * ez; L += blockDim.y) {
            const int gy = y0 + L % ey, gz = z0 + L / ey;
            brick_copy_line(y + nx * (gy + ny * gz),
                            xs + ((gz - z0 + rz) * fy + gy - y0 + ry) * ls
                               + rx, nx);
        }
        const int win = (int)brick_window(by, bz, ry, rz);
        for (int f = threadIdx.y; f < win; f += blockDim.y) {
            const int wy = f % fy - ry, wz = f / fy - rz;
            T* const line = xs + f * ls;
            if (wy >= 0 && wy < ey && wz >= 0 && wz < ez)
                for (int i = threadIdx.x; i < 2 * rx; i += blockDim.x)
                    line[i < rx ? i : nx + i] = T(0);
            else
                for (int i = threadIdx.x; i < ls; i += blockDim.x)
                    line[i] = T(0);
        }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (WORK && drows) {
        // the first level's 1/D, in flight until its frame lines are in
        brick_stage_d(nx, K, reinterpret_cast<const int2*>(own), drows,
                      dstage);
        __pipeline_commit();
    }
    for (int li = 0; li < n_levels; ++li) {
        const int* const lt = tab + li * shared;
        const int nc = lt[0], ns = lt[1], sx = lt[2], upper = lt[3];
        const T* const cf = reinterpret_cast<const T*>(lt + BIS_SB_BRICK_HDR);
        const int* const lo = lt + shared - BIS_SB_BRICK_OFFS;
        const int* const bt = own + li * part;
        const int2* const lines = reinterpret_cast<const int2*>(bt);
        if (WORK) {
            // the level's frame lines, beside its 1/D already in flight
            __syncthreads();
            const int* const fr = bt + 2 * kmax;
            const int2* const frame = reinterpret_cast<const int2*>(fr + 2);
            for (int j = threadIdx.y; j < fr[0]; j += blockDim.y)
                brick_copy_line(x + frame[j].y, xs + frame[j].x, nx);
            __pipeline_commit();
            __pipeline_wait_prior(0);
            __syncthreads();
            if (nc == 0)
                brick_cross<T, 0>(nx, 0, K, cf, lo, lines, xs);
            else if (nc <= 8)
                brick_cross<T, 8>(nx, nc, K, cf, lo, lines, xs);
            else if (nc <= 16)
                brick_cross<T, 16>(nx, nc, K, cf, lo, lines, xs);
            else if (nc <= 24)
                brick_cross<T, 24>(nx, nc, K, cf, lo, lines, xs);
            else
                brick_cross<T, 27>(nx, nc, K, cf, lo, lines, xs);
            __syncthreads();
            T* const ds = drows ? dstage : nullptr;
            const int* const sdx = lo + BIS_SB_BRICK_OFFS / 2;
            for (int step = 0; step < sx; ++step) {
                const int p = upper ? sx - 1 - step : step;
                // the self legs whose source parity (p + dx) mod sx is
                // solved
                unsigned solved = 0;
                for (int l = 0; l < ns; ++l) {
                    int q = p + sdx[l];
                    while (q < 0) q += sx;
                    while (q >= sx) q -= sx;
                    if (upper ? q > p : q < p) solved |= 1u << l;
                }
                // two rows a thread a line at most: U = 2
                const bool two = nx <= 2 * sx * (int)blockDim.x;
#define BIS_SB_PARITY(HOIST, U)                                              \
    brick_parity<T, HOIST, U>(nx, sx, ns, p, solved, cf, sdx, K, lines, xs, \
                              x, ds)
                if (ns <= 2 && two) BIS_SB_PARITY(true, 2);
                else if (ns <= 2) BIS_SB_PARITY(true, 4);
                else if (two) BIS_SB_PARITY(false, 2);
                else BIS_SB_PARITY(false, 4);
#undef BIS_SB_PARITY
                if (step + 1 < sx) __syncthreads();
            }
            if (drows && li + 1 < n_levels) {
                // the next level's 1/D, in flight across the barrier
                __syncthreads();
                brick_stage_d(nx, K,
                              reinterpret_cast<const int2*>(bt + part),
                              drows, dstage);
                __pipeline_commit();
            }
        }
        if (li + 1 < n_levels) grid.sync();
    }
}

// Split route, step 1, "direct" (the first port's): acc[line * nx + x] =
// y - sum_cross f * x.
template <typename T, int MODE>
__global__ void __launch_bounds__(256)
super_acc_kernel(const __grid_constant__ BisSuperLevelArgs a, const T* y,
                 const T* x, T* acc, const T* table, const T* vc) {
    const LevelRow r = level_row(a, blockIdx.x);
    if (!r.live) return;
    for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
        const int base = MODE == BIS_SL_TABLE ? class_base(a, gx, r.gy, r.gz)
                                              : 0;
        acc[r.slot + gx - a.slot0] = cross_sum<T, MODE>(
            a, y, x, table, vc, r.iy + gx, r.ix + gx, r.slot + gx, gx, r.gy,
            r.gz, base);
    }
}

// Split route, step 2, "direct": parity p's rows from acc (or y) and the
// self legs.
template <typename T, int MODE>
__global__ void __launch_bounds__(256)
super_parity_kernel(const __grid_constant__ BisSuperLevelArgs a, int p,
                    const T* y, const T* acc, T* x, const T* table,
                    const T* tdinv, const T* vs, const T* drows) {
    const LevelRow r = level_row(a, blockIdx.x);
    if (!r.live) return;
    for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
        if (gx % a.sx != p) continue;
        const int base = MODE == BIS_SL_TABLE ? class_base(a, gx, r.gy, r.gz)
                                              : 0;
        const T v = acc ? acc[r.slot + gx - a.slot0] : y[r.iy + gx];
        x[r.ix + gx] = parity_update<T, MODE>(a, p, v, x, table, tdinv, vs,
                                              drows, r.iy + gx, r.ix + gx,
                                              r.slot + gx, gx, base);
    }
}

// The staged split kernels walk the launch's lines persistently: the
// grid holds the blocks resident on the card at once (launch_acc_staged,
// launch_parity_staged), and block b takes the line groups b, b + grid,
// ..., line k = group * lb + threadIdx.y of each.  A line's factors stay
// staged while the next line of its slot has the same (y, z) class (every
// interior line of a superblock does): the block restages only the slots
// whose class changed, meeting at __syncthreads_or / __syncthreads (every
// thread walks the same groups).  At 384^3 a block staged per line spent
// most of its launch waiting on those table loads.

// Split route, step 1, "staged" (factor-table mode): the staged fused
// kernel's cross half, acc written once, coalesced, in slot order.  A warp
// a line, 256 / 32 lines a block (64, 128 or 256 threads a line ran up to
// 1.9x slower at 384^3: scripts/split_route_ab.py --sweep of a tree that
// took the block as a parameter); shared memory: the x-classes and each
// line slot's cross-leg factors (n_cross x proto_x values).  x is not
// written during the launch, so every read of it on the unrolled path is
// non-coherent (__ldg); y may be x and is read with plain loads.  Its
// float64 form loses to the direct route (0.59 against 0.41 ms a 384^3
// level; sized for 2 blocks an SM, 128 registers and no spills, 0.53).
template <typename T, int NCB>
__global__ void __launch_bounds__(256, BIS_SL_MIN_BLOCKS)
super_acc_staged_kernel(const __grid_constant__ BisSuperLevelArgs a,
                        const T* y, const T* x, T* acc,
                        const T* __restrict__ table) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nx = a.nx, nc = a.n_cross, lb = blockDim.y;
    int* const cls = reinterpret_cast<int*>(smem_raw);
    stage_classes(a, cls);
    T* const fac = reinterpret_cast<T*>(cls + ((nx + 3) & ~3))
                   + threadIdx.y * nc * a.proto_x;
    int staged = -1;
    for (int g = blockIdx.x; g * lb < a.lines; g += gridDim.x) {
        const LevelRow r = level_line(a, g * lb + threadIdx.y);
        const int cyz = r.live ? line_class(a, r) : staged;
        if (__syncthreads_or(cyz != staged)) {
            if (cyz != staged)
                stage_factors<T>(a, cyz, table, nullptr, fac, 0, nc,
                                 threadIdx.x, blockDim.x);
            __syncthreads();
            staged = cyz;
        }
        if (r.live)
            staged_cross_line<T, NCB>(a, r, cls, fac, y, x,
                                      acc + (r.slot - a.slot0), threadIdx.x,
                                      blockDim.x);
    }
}

// Split route, step 2, "staged" (factor-table mode): block (tl, lb) from
// the wrapper (ops/block_trisolve.parity_shape); shared memory: the
// x-classes and each line slot's self-leg factors and pivots ((n_self +
// 1) x proto_x values).  Every thread works: thread k of a line on rows
// p + sx*k, p + sx*(k + tl), ...; parity p's rows written, nothing else.
template <typename T>
__global__ void __launch_bounds__(BIS_SL_LINE_THREADS)
super_parity_staged_kernel(const __grid_constant__ BisSuperLevelArgs a, int p,
                           const T* y, const T* acc, T* x,
                           const T* __restrict__ table,
                           const T* __restrict__ tdinv) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nx = a.nx, nc = a.n_cross, ns = a.n_self, lb = blockDim.y;
    int* const cls = reinterpret_cast<int*>(smem_raw);
    stage_classes(a, cls);
    T* const fsel = reinterpret_cast<T*>(cls + ((nx + 3) & ~3))
                    + threadIdx.y * (ns + 1) * a.proto_x;
    const unsigned solved = solved_mask(a, p);
    int staged = -1;
    for (int g = blockIdx.x; g * lb < a.lines; g += gridDim.x) {
        const LevelRow r = level_line(a, g * lb + threadIdx.y);
        const int cyz = r.live ? line_class(a, r) : staged;
        if (__syncthreads_or(cyz != staged)) {
            if (cyz != staged)
                stage_factors(a, cyz, table, tdinv, fsel, nc, nc + ns,
                              threadIdx.x, blockDim.x);
            __syncthreads();
            staged = cyz;
        }
        if (r.live)
            staged_parity_rows(a, p, solved, cls, fsel, tdinv != nullptr,
                               acc ? acc + (r.slot - a.slot0) : y + r.iy,
                               x + r.ix, x + r.ix, threadIdx.x, blockDim.x);
    }
}

// Split route, step 1, "line" (plane mode): the line kernel's cross half
// on a block shaped to the launch (ops/block_trisolve.line_shape), each
// line's source offsets in shared memory (lb x 2 x n_cross ints), acc
// written once, coalesced, in slot order.
template <typename T, int NCB>
__global__ void __launch_bounds__(BIS_SL_LINE_THREADS)
super_acc_line_kernel(const __grid_constant__ BisSuperLevelArgs a,
                      const T* y, const T* x, T* acc,
                      const T* __restrict__ vc) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int k = blockIdx.x * blockDim.y + threadIdx.y;
    const LevelRow r = level_line(a, k);
    int* const src = reinterpret_cast<int*>(smem_raw)
                     + threadIdx.y * 2 * a.n_cross;
    if (r.live) line_sources(a, r, k, src, threadIdx.x, blockDim.x);
    __syncthreads();
    if (r.live)
        line_cross_rows<T, BIS_SL_PLANE, NCB>(a, r, src, y, x, vc,
                                              acc + (r.slot - a.slot0),
                                              threadIdx.x, blockDim.x);
}

// Split route, step 2, "line" (plane mode): block (tl, lb) from the
// wrapper (parity_shape), every thread on rows p + sx*k, ...; the self
// planes read at the row's slot, parity p's rows written, nothing else.
template <typename T>
__global__ void __launch_bounds__(BIS_SL_LINE_THREADS)
super_parity_line_kernel(const __grid_constant__ BisSuperLevelArgs a, int p,
                         const T* y, const T* acc, T* x,
                         const T* __restrict__ vs,
                         const T* __restrict__ drows) {
    const LevelRow r = level_line(a, blockIdx.x * blockDim.y + threadIdx.y);
    if (!r.live) return;
    line_parity_rows<T, BIS_SL_PLANE>(
        a, p, solved_mask(a, p), r,
        acc ? acc + (r.slot - a.slot0) : y + r.iy, x + r.ix, x + r.ix, vs,
        drows, threadIdx.x, blockDim.x);
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
// card, in the order the builder sorted them.  The "scalar" route (the
// first port's, kept for levels the vec route below refuses and for its
// A/B): one thread per slot; a
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

// ---------------------------------------------------------------------------
// The rank-space level's "vec" route (rank_level_vec_kernel): the same
// contract, bit for bit, for levels of at most BIS_RV_MAX_GROUPS groups.
//
// The scalar kernel above ran at ~2.4x its byte bound on band:8388608,2:
// every thread loads its group's (src, delta, plane) triple from global
// memory before the loads that depend on it, in a loop of runtime length,
// with one 4- or 8-byte load per value.  Here:
//   - the group table travels in the launch's __grid_constant__
//     parameters (BisRankVecArgs): nothing per group is loaded;
//   - the group loop is unrolled to the level's bucket (2, 4 or 8 groups,
//     a template parameter; an unused group is a uniform skip);
//   - a thread owns VEC = 16 / sizeof(T) consecutive slots a chunk (and
//     `cpt` chunks, a block's chunks consecutive): y, dinv, each value
//     plane and the x store are 16-byte loads and stores (M and the
//     pointers 16-byte aligned: the wrapper's picker checks, the launch
//     refuses otherwise);
//   - x is read once a window: the host packs a source colour's groups
//     (sorted by delta, as the JAX kernel's per-source windows) into
//     windows of at most BIS_RV_WIN aligned vectors covering
//     [t + delta_min, t + delta_max + VEC); a group reads its VEC values
//     from lanes shift .. shift + VEC - 1 of the window in registers (the
//     lane roll of the TPU kernel, one uniform compare a candidate shift).
//     A vector of the window outside [0, M) is zeros, as the scalar
//     kernel's masked reads (M is a multiple of VEC, so a vector lies
//     wholly inside or outside).
// Groups in the level's order, each product and difference rounded alone:
// x equals the scalar kernel's bit for bit.
//
// Aliasing.  y may be x (blocked_sgs's U solve runs in place).  A level
// reads y and writes x only at colour c's rows, each slot by the one
// thread that owns it, y before x; it reads x elsewhere only at source
// colours, which a proper colouring keeps apart from c (the launch refuses
// src == c), so no x it reads is written during the launch: those reads,
// and the value planes and dinv (never written), take the non-coherent
// path (__ldg).  y and x carry no __restrict__, and y is read with a plain
// load.
// ---------------------------------------------------------------------------

#define BIS_RV_MAX_GROUPS 8   // the largest bucket
#define BIS_RV_WIN 3          // 16-byte vectors a window holds
#define BIS_RV_THREADS 256    // the most threads a block

// One level's launch table (ops/block_trisolve._rank_vec_args); keep the
// field order in step with the ctypes mirror in _build.py.
struct BisRankVecArgs {
    long long M;                        // slots a colour block
    int c;                              // the level's colour
    int n_groups;
    int cpt;                            // chunks of VEC slots a thread
    int plane[BIS_RV_MAX_GROUPS];       // group g's value plane
    int src[BIS_RV_MAX_GROUPS];         // >= 0: g opens a window on this
                                        // colour; -1: g reads g - 1's
    int base[BIS_RV_MAX_GROUPS];        // the window's first vector, in
                                        // vectors from the chunk's slot t
    int nvec[BIS_RV_MAX_GROUPS];        // its vectors, 1..BIS_RV_WIN
    int shift[BIS_RV_MAX_GROUPS];       // the window lane of slot t's
                                        // source: delta - VEC * base
};

template <typename T> struct BisRv;
template <> struct BisRv<float> { using vec = float4; };
template <> struct BisRv<double> { using vec = double2; };

// VEC values at p (16-byte aligned): a plain load, or a non-coherent one
template <typename T, int VEC>
__device__ __forceinline__ void rv_load(const T* p, T (&v)[VEC]) {
    const typename BisRv<T>::vec u =
        *reinterpret_cast<const typename BisRv<T>::vec*>(p);
    memcpy(v, &u, sizeof(u));
}

template <typename T, int VEC>
__device__ __forceinline__ void rv_ldg(const T* p, T (&v)[VEC]) {
    const typename BisRv<T>::vec u =
        __ldg(reinterpret_cast<const typename BisRv<T>::vec*>(p));
    memcpy(v, &u, sizeof(u));
}

template <typename T, int VEC>
__device__ __forceinline__ void rv_store(T* p, const T (&v)[VEC]) {
    typename BisRv<T>::vec u;
    memcpy(&u, v, sizeof(u));
    *reinterpret_cast<typename BisRv<T>::vec*>(p) = u;
}

template <typename T, int NG>
__global__ void __launch_bounds__(BIS_RV_THREADS)
rank_level_vec_kernel(const __grid_constant__ BisRankVecArgs a, const T* y,
                      T* x, const T* __restrict__ vals,
                      const T* __restrict__ dinv) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int W = BIS_RV_WIN * VEC;
    const long long chunks = a.M / VEC;
    const long long row0 = (long long)a.c * a.M;
    const long long first =
        (long long)blockIdx.x * a.cpt * blockDim.x + threadIdx.x;
#pragma unroll 1
    for (int j = 0; j < a.cpt; ++j) {
        const long long k = first + (long long)j * blockDim.x;
        if (k >= chunks) break;
        const long long t = k * VEC;
        T acc[VEC];
        rv_load<T, VEC>(y + row0 + t, acc);     // y may be x: a plain load
        T v[NG][VEC];
#pragma unroll
        for (int g = 0; g < NG; ++g)
            if (g < a.n_groups)
                rv_ldg<T, VEC>(vals + (long long)a.plane[g] * a.M + t, v[g]);
        T w[W];
#pragma unroll
        for (int e = 0; e < W; ++e) w[e] = T(0);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
            if (g >= a.n_groups) continue;
            if (a.src[g] >= 0) {            // a new window
                const T* xs = x + (long long)a.src[g] * a.M;
#pragma unroll
                for (int q = 0; q < BIS_RV_WIN; ++q) {
                    const long long s = t + (long long)(a.base[g] + q) * VEC;
                    T u[VEC];
                    if (q < a.nvec[g] && s >= 0 && s < a.M) {
                        rv_ldg<T, VEC>(xs + s, u);
                    } else {
#pragma unroll
                        for (int r = 0; r < VEC; ++r) u[r] = T(0);
                    }
#pragma unroll
                    for (int r = 0; r < VEC; ++r) w[q * VEC + r] = u[r];
                }
            }
            T sh[VEC];
#pragma unroll
            for (int r = 0; r < VEC; ++r) sh[r] = w[r];
#pragma unroll
            for (int s = 1; s <= W - VEC; ++s)
                if (a.shift[g] == s) {
#pragma unroll
                    for (int r = 0; r < VEC; ++r) sh[r] = w[s + r];
                }
#pragma unroll
            for (int r = 0; r < VEC; ++r)
                acc[r] = sub_rn(acc[r], mul_rn(v[g][r], sh[r]));
        }
        T d[VEC];
        rv_ldg<T, VEC>(dinv + row0 + t, d);
#pragma unroll
        for (int r = 0; r < VEC; ++r) acc[r] = mul_rn(acc[r], d[r]);
        rv_store<T, VEC>(x + row0 + t, acc);
    }
}

template <typename T>
static int launch_level(int device, const BisSuperLevelArgs* a, const T* y,
                        T* x, const T* table, const T* tdinv, const T* vc,
                        const T* vs, const T* drows, cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
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
static int launch_level_staged(int device, const BisSuperLevelArgs* a,
                               const T* y, T* x, const T* table,
                               const T* tdinv, cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const size_t smem = staged_smem(*a);
    if (smem > BIS_SL_STAGED_SMEM_MAX) return (int)cudaErrorInvalidValue;
    const int bx = staged_bx(*a), by = 256 / bx;
    const dim3 grid((a->lines + by - 1) / by), block(bx, by);
    const int nc = a->n_cross;
#define BIS_SL_STAGED(NCB)                                                   \
    super_level_staged_kernel<T, NCB><<<grid, block, smem, stream>>>(       \
        *a, y, x, table, tdinv)
    if (nc == 0) BIS_SL_STAGED(0);
    else if (nc <= 8) BIS_SL_STAGED(8);
    else if (nc <= 16) BIS_SL_STAGED(16);
    else if (nc <= 24) BIS_SL_STAGED(24);
    else BIS_SL_STAGED(27);
#undef BIS_SL_STAGED
    return (int)cudaGetLastError();
}

template <typename T, int MODE>
static void launch_line_mode(const BisSuperLevelArgs* a, dim3 grid,
                             dim3 block, size_t smem, const T* y, T* x,
                             const T* vc, const T* vs, const T* drows,
                             cudaStream_t stream) {
    const int nc = a->n_cross;
#define BIS_SL_LINE(NCB)                                                     \
    super_level_line_kernel<T, MODE, NCB><<<grid, block, smem, stream>>>(   \
        *a, y, x, vc, vs, drows)
    if (nc == 0) BIS_SL_LINE(0);
    else if (nc <= 8) BIS_SL_LINE(8);
    else if (nc <= 16) BIS_SL_LINE(16);
    else if (nc <= 24) BIS_SL_LINE(24);
    else BIS_SL_LINE(27);
#undef BIS_SL_LINE
}

template <typename T>
static int launch_level_line(int device, const BisSuperLevelArgs* a, int tl,
                             int lb, const T* y, T* x, const T* vc,
                             const T* vs, const T* drows,
                             cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const size_t smem = line_smem(*a, lb, sizeof(T));
    if (tl < 1 || lb < 1 || tl * lb > BIS_SL_LINE_THREADS
        || smem > BIS_SL_LINE_SMEM_MAX || a->mode == BIS_SL_TABLE)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((a->lines + lb - 1) / lb), block(tl, lb);
    if (a->mode == BIS_SL_PLANE)
        launch_line_mode<T, BIS_SL_PLANE>(a, grid, block, smem, y, x, vc, vs,
                                          drows, stream);
    else
        launch_line_mode<T, BIS_SL_CONST>(a, grid, block, smem, y, x,
                                          nullptr, nullptr, drows, stream);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_acc(int device, const BisSuperLevelArgs* a, const T* y,
                      const T* x, T* acc, const T* table, const T* vc,
                      cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
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
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const dim3 block(a->block_x, a->block_y);
    if (a->mode == BIS_SL_PLANE)
        super_parity_kernel<T, BIS_SL_PLANE><<<a->grid_x, block, 0, stream>>>(
            *a, p, y, acc, x, nullptr, nullptr, vs, drows);
    else
        super_parity_kernel<T, BIS_SL_TABLE><<<a->grid_x, block, 0, stream>>>(
            *a, p, y, acc, x, table, tdinv, nullptr, nullptr);
    return (int)cudaGetLastError();
}

// The blocks of a persistent launch of `kernel` (threads a block, dynamic
// shared memory smem): those resident on the card at once, at most
// `groups`; 0 where the card cannot say.
template <typename K>
static int resident_grid(int device, K kernel, int threads, size_t smem,
                         int groups) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
            != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, threads, smem) != cudaSuccess)
        return 0;
    const long long fit = (long long)per_sm * sms;
    return (int)(fit < groups ? fit : groups);
}

// The split staged kernels' shared memory: the x-classes (padded to 16
// bytes) and `lines` lines of `rows` x proto_x factors.
static size_t split_staged_smem(const BisSuperLevelArgs& a, int lines,
                                int rows, size_t item) {
    return (size_t)((a.nx + 3) & ~3) * sizeof(int)
           + (size_t)lines * rows * a.proto_x * item;
}

template <typename T>
static int launch_acc_staged(int device, const BisSuperLevelArgs* a,
                             const T* y, const T* x, T* acc, const T* table,
                             cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const int by = 256 / BIS_SL_STAGED_BX;
    const size_t smem = split_staged_smem(*a, by, a->n_cross, sizeof(T));
    if (a->mode != BIS_SL_TABLE || a->n_cross > 27
        || smem > BIS_SL_STAGED_SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    const dim3 block(BIS_SL_STAGED_BX, by);
    const int groups = (a->lines + by - 1) / by, nc = a->n_cross;
    int grid = 0;
#define BIS_SL_ACC(NCB)                                                      \
    do {                                                                     \
        grid = resident_grid(device, super_acc_staged_kernel<T, NCB>, 256,   \
                             smem, groups);                                  \
        if (grid > 0)                                                        \
            super_acc_staged_kernel<T, NCB><<<grid, block, smem, stream>>>(  \
                *a, y, x, acc, table);                                       \
    } while (0)
    if (nc <= 8) BIS_SL_ACC(8);
    else if (nc <= 16) BIS_SL_ACC(16);
    else if (nc <= 24) BIS_SL_ACC(24);
    else BIS_SL_ACC(27);
#undef BIS_SL_ACC
    if (grid < 1) return (int)cudaErrorInvalidConfiguration;
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_acc_line(int device, const BisSuperLevelArgs* a, int tl,
                           int lb, const T* y, const T* x, T* acc,
                           const T* vc, cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const size_t smem = (size_t)lb * 2 * a->n_cross * sizeof(int);
    if (a->mode != BIS_SL_PLANE || a->n_cross > 27 || tl < 1 || lb < 1 || tl * lb > BIS_SL_LINE_THREADS
        || smem > BIS_SL_LINE_SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((a->lines + lb - 1) / lb), block(tl, lb);
    const int nc = a->n_cross;
#define BIS_SL_ACC(NCB)                                                      \
    super_acc_line_kernel<T, NCB><<<grid, block, smem, stream>>>(            \
        *a, y, x, acc, vc)
    if (nc <= 8) BIS_SL_ACC(8);
    else if (nc <= 16) BIS_SL_ACC(16);
    else if (nc <= 24) BIS_SL_ACC(24);
    else BIS_SL_ACC(27);
#undef BIS_SL_ACC
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_parity_staged(int device, const BisSuperLevelArgs* a, int p,
                                int tl, int lb, const T* y, const T* acc,
                                T* x, const T* table, const T* tdinv,
                                cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const size_t smem = split_staged_smem(*a, lb, a->n_self + 1, sizeof(T));
    if (a->mode != BIS_SL_TABLE || p < 0 || p >= a->sx || tl < 1 || lb < 1
        || tl * lb > BIS_SL_LINE_THREADS || smem > BIS_SL_STAGED_SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    const int grid = resident_grid(device, super_parity_staged_kernel<T>,
                                   tl * lb, smem, (a->lines + lb - 1) / lb);
    if (grid < 1) return (int)cudaErrorInvalidConfiguration;
    super_parity_staged_kernel<T><<<grid, dim3(tl, lb), smem, stream>>>(
        *a, p, y, acc, x, table, tdinv);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_parity_line(int device, const BisSuperLevelArgs* a, int p,
                              int tl, int lb, const T* y, const T* acc, T* x,
                              const T* vs, const T* drows,
                              cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    if (a->mode != BIS_SL_PLANE || p < 0 || p >= a->sx || tl < 1 || lb < 1
        || tl * lb > BIS_SL_LINE_THREADS)
        return (int)cudaErrorInvalidValue;
    super_parity_line_kernel<T><<<(a->lines + lb - 1) / lb, dim3(tl, lb), 0,
                                  stream>>>(*a, p, y, acc, x, vs, drows);
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
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
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

// The blocks of a brick launch (threads a block, dynamic shared memory
// smem) the card holds at once, its shared memory limit set first; 0
// where it has no cooperative launch or cannot give smem to a block (the
// query's error cleared).
template <typename T, bool WORK>
static int brick_resident(int device, int threads, size_t smem) {
    const void* kernel = (const void*)super_solve_brick_kernel<T, WORK>;
    int coop = 0, sms = 0, optin = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)
            == cudaSuccess && coop
        && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device) == cudaSuccess
        && cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  device) == cudaSuccess
        && smem <= (size_t)optin
        && cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem) == cudaSuccess
        && cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared)
               == cudaSuccess
        && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, super_solve_brick_kernel<T, WORK>, threads, smem)
               == cudaSuccess)
        return per_sm * sms;
    (void)cudaGetLastError();
    return 0;
}

// A brick launch: bricks of by x bz lines of the nx x ny x nz grid under
// (y, z) strides (sy, sz), framed (rx, ry, rz) deep (the cross legs'
// reach), block (tl, lb).  Refused (cudaErrorInvalidValue) for extents
// that are not multiples of the strides, a block above
// BIS_SB_BRICK_THREADS or rows past 32-bit offsets; and
// (cudaErrorCooperativeLaunchTooLarge) where the bricks do not fit on the
// card at once.
template <typename T, bool WORK>
static int launch_brick(int device, const int* tables, int n_levels, int nx,
                        int ny, int nz, int sy, int sz, int rx, int ry,
                        int rz, int by, int bz, int tl, int lb, const T* y,
                        T* x, const T* drows, cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    if (n_levels < 1 || nx < 1 || sy < 1 || sz < 1 || ny % sy || nz % sz
        || by < sy || bz < sz || by % sy || bz % sz || rx < 0 || ry < 0
        || rz < 0 || tl < 1 || lb < 1 || tl * lb > BIS_SB_BRICK_THREADS
        || (long long)nx * ny * nz >= 2147483647LL
        || (reinterpret_cast<uintptr_t>(tables) & 15))
        return (int)cudaErrorInvalidValue;
    const size_t smem = brick_smem(n_levels, by, bz, rx, ry, rz, sy, sz, nx,
                                   sizeof(T), drows != nullptr);
    const long long bricks = (long long)((ny + by - 1) / by)
                             * ((nz + bz - 1) / bz);
    if (bricks > brick_resident<T, WORK>(device, tl * lb, smem))
        return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {(void*)&tables, (void*)&n_levels, (void*)&nx, (void*)&ny,
                    (void*)&nz, (void*)&sy, (void*)&sz, (void*)&by,
                    (void*)&bz, (void*)&rx, (void*)&ry, (void*)&rz,
                    (void*)&y, (void*)&x, (void*)&drows};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)super_solve_brick_kernel<T, WORK>, dim3((unsigned)bricks),
        dim3(tl, lb), args, smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_rank_level(int device, const T* y, T* x, const T* vals,
                             const T* dinv, const long long* groups,
                             int n_groups, long long M, int c,
                             cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    rank_level_kernel<T><<<(unsigned)((M + 255) / 256), 256, 0, stream>>>(
        y, x, vals, dinv, groups, n_groups, M, c);
    return (int)cudaGetLastError();
}

static bool rv_aligned(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The vec route's launch: `threads` a block (a multiple of 32, at most
// BIS_RV_THREADS), a->cpt chunks a thread.  Refuses a table or operands
// it cannot take: more groups than the largest bucket, M or a pointer not
// 16-byte aligned, a window longer than BIS_RV_WIN or a shift past its
// end, a first group that opens no window, a source colour equal to c.
template <typename T>
static int launch_rank_level_vec(int device, const BisRankVecArgs* a,
                                 int threads, const T* y, T* x,
                                 const T* vals, const T* dinv,
                                 cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const int n = a->n_groups;
    if (n < 1 || n > BIS_RV_MAX_GROUPS || a->M < VEC || a->M % VEC ||
        a->cpt < 1 || threads < 32 || threads > BIS_RV_THREADS ||
        threads % 32 || a->src[0] < 0 || !rv_aligned(y) || !rv_aligned(x) ||
        !rv_aligned(vals) || !rv_aligned(dinv))
        return (int)cudaErrorInvalidValue;
    int nvec = 0;
    for (int g = 0; g < n; ++g) {
        if (a->src[g] >= 0) {
            nvec = a->nvec[g];
            if (a->src[g] == a->c || nvec < 1 || nvec > BIS_RV_WIN)
                return (int)cudaErrorInvalidValue;
        }
        if (a->plane[g] < 0 || a->shift[g] < 0 ||
            a->shift[g] > (nvec - 1) * VEC)
            return (int)cudaErrorInvalidValue;
    }
    const long long per_block = (long long)threads * a->cpt;
    const long long grid = (a->M / VEC + per_block - 1) / per_block;
    if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
    if (n <= 2)
        rank_level_vec_kernel<T, 2><<<(unsigned)grid, threads, 0, stream>>>(
            *a, y, x, vals, dinv);
    else if (n <= 4)
        rank_level_vec_kernel<T, 4><<<(unsigned)grid, threads, 0, stream>>>(
            *a, y, x, vals, dinv);
    else
        rank_level_vec_kernel<T, 8><<<(unsigned)grid, threads, 0, stream>>>(
            *a, y, x, vals, dinv);
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

// The factor-table level's staged route, float32 only (in float64 the
// direct route is the faster: ops/block_trisolve.level_route_for): table
// and tdinv (NULL for L) as above.  Refused (cudaErrorInvalidValue) where
// its shared memory exceeds BIS_SL_STAGED_SMEM_MAX.
int bis_super_level_staged_f32(int device, const BisSuperLevelArgs* a,
                               const float* y, float* x, const float* table,
                               const float* tdinv, void* stream) {
    return launch_level_staged<float>(device, a, y, x, table, tdinv,
                                      (cudaStream_t)stream);
}

// The blocks a staged launch of level a would run, or 0 where its shared
// memory exceeds BIS_SL_STAGED_SMEM_MAX.
int bis_super_level_staged_grid(const BisSuperLevelArgs* a) {
    if (staged_smem(*a) > BIS_SL_STAGED_SMEM_MAX) return 0;
    const int by = 256 / staged_bx(*a);
    return (a->lines + by - 1) / by;
}

// The plane or const level's line route on a block of tl threads a line
// and lb lines (ops/block_trisolve.line_shape); vc, vs, drows as in
// bis_super_level_*.  Refused (cudaErrorInvalidValue) in factor-table
// mode, above BIS_SL_LINE_THREADS threads a block, or where its shared
// memory exceeds BIS_SL_LINE_SMEM_MAX.
int bis_super_level_line_f32(int device, const BisSuperLevelArgs* a, int tl,
                             int lb, const float* y, float* x,
                             const float* vc, const float* vs,
                             const float* drows, void* stream) {
    return launch_level_line<float>(device, a, tl, lb, y, x, vc, vs, drows,
                                    (cudaStream_t)stream);
}

int bis_super_level_line_f64(int device, const BisSuperLevelArgs* a, int tl,
                             int lb, const double* y, double* x,
                             const double* vc, const double* vs,
                             const double* drows, void* stream) {
    return launch_level_line<double>(device, a, tl, lb, y, x, vc, vs, drows,
                                     (cudaStream_t)stream);
}

// The line route's limits, for ops/block_trisolve to check its rule
// against: threads a block, shared memory bytes a block.
void bis_super_level_line_limits(int* threads, int* smem) {
    *threads = BIS_SL_LINE_THREADS;
    *smem = BIS_SL_LINE_SMEM_MAX;
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

// The split route's staged kernels (factor-table mode), float32 and
// float64: acc, on a warp a line and 8 lines a block, and parity p, on a
// block of tl threads a line and lb lines (ops/block_trisolve.
// parity_shape); tdinv NULL for L, acc NULL where the level has no cross
// legs.  The line kernels (plane mode): acc on line_shape's block, parity
// p on parity_shape's.  Each refuses (cudaErrorInvalidValue) another
// mode, a block above BIS_SL_LINE_THREADS threads or shared memory above
// 48 KB.
int bis_super_acc_staged_f32(int device, const BisSuperLevelArgs* a,
                             const float* y, const float* x, float* acc,
                             const float* table, void* stream) {
    return launch_acc_staged<float>(device, a, y, x, acc, table,
                                    (cudaStream_t)stream);
}

int bis_super_acc_staged_f64(int device, const BisSuperLevelArgs* a,
                             const double* y, const double* x, double* acc,
                             const double* table, void* stream) {
    return launch_acc_staged<double>(device, a, y, x, acc, table,
                                     (cudaStream_t)stream);
}

int bis_super_parity_staged_f32(int device, const BisSuperLevelArgs* a, int p,
                                int tl, int lb, const float* y,
                                const float* acc, float* x,
                                const float* table, const float* tdinv,
                                void* stream) {
    return launch_parity_staged<float>(device, a, p, tl, lb, y, acc, x, table,
                                       tdinv, (cudaStream_t)stream);
}

int bis_super_parity_staged_f64(int device, const BisSuperLevelArgs* a, int p,
                                int tl, int lb, const double* y,
                                const double* acc, double* x,
                                const double* table, const double* tdinv,
                                void* stream) {
    return launch_parity_staged<double>(device, a, p, tl, lb, y, acc, x,
                                        table, tdinv, (cudaStream_t)stream);
}

int bis_super_acc_line_f32(int device, const BisSuperLevelArgs* a, int tl,
                           int lb, const float* y, const float* x, float* acc,
                           const float* vc, void* stream) {
    return launch_acc_line<float>(device, a, tl, lb, y, x, acc, vc,
                                  (cudaStream_t)stream);
}

int bis_super_acc_line_f64(int device, const BisSuperLevelArgs* a, int tl,
                           int lb, const double* y, const double* x,
                           double* acc, const double* vc, void* stream) {
    return launch_acc_line<double>(device, a, tl, lb, y, x, acc, vc,
                                   (cudaStream_t)stream);
}

int bis_super_parity_line_f32(int device, const BisSuperLevelArgs* a, int p,
                              int tl, int lb, const float* y,
                              const float* acc, float* x, const float* vs,
                              const float* drows, void* stream) {
    return launch_parity_line<float>(device, a, p, tl, lb, y, acc, x, vs,
                                     drows, (cudaStream_t)stream);
}

int bis_super_parity_line_f64(int device, const BisSuperLevelArgs* a, int p,
                              int tl, int lb, const double* y,
                              const double* acc, double* x, const double* vs,
                              const double* drows, void* stream) {
    return launch_parity_line<double>(device, a, p, tl, lb, y, acc, x, vs,
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
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return 0;
    return itemsize == 8 ? mega_grid<double>(device, threads, max_blocks)
                         : mega_grid<float>(device, threads, max_blocks);
}

// The one-launch solve's brick route: `tables` the brick tables in
// device memory (16-byte aligned), n_levels levels, the grid (nx, ny,
// nz), its (y, z) strides, the frame (rx, ry, rz), the brick extents (by,
// bz) and block (tl, lb) of ops/block_trisolve.brick_shape.  _floor_: the
// same launch with no rows (the tables and the grid barriers).
#define BIS_SB_BRICK_ENTRY(NAME, T, WORK)                                    \
    int NAME(int device, const int* tables, int n_levels, int nx, int ny,   \
             int nz, int sy, int sz, int rx, int ry, int rz, int by, int bz, \
             int tl, int lb, const T* y, T* x, const T* drows,               \
             void* stream) {                                                 \
        return launch_brick<T, WORK>(device, tables, n_levels, nx, ny, nz,  \
                                     sy, sz, rx, ry, rz, by, bz, tl, lb, y,  \
                                     x, drows, (cudaStream_t)stream);        \
    }
BIS_SB_BRICK_ENTRY(bis_super_solve_brick_f32, float, true)
BIS_SB_BRICK_ENTRY(bis_super_solve_brick_f64, double, true)
BIS_SB_BRICK_ENTRY(bis_super_solve_brick_floor_f32, float, false)
BIS_SB_BRICK_ENTRY(bis_super_solve_brick_floor_f64, double, false)
#undef BIS_SB_BRICK_ENTRY

// The brick kernel's co-resident blocks on the card for vectors of
// itemsize bytes (4 or 8), `threads` a block and smem bytes of dynamic
// shared memory: 0 where it cannot run them cooperatively.
int bis_super_solve_brick_resident(int device, int itemsize, int threads,
                                   long long smem) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess || smem < 0) return 0;
    return itemsize == 8
        ? brick_resident<double, true>(device, threads, (size_t)smem)
        : brick_resident<float, true>(device, threads, (size_t)smem);
}

// The most dynamic shared memory a block of the card may take.
int bis_super_solve_brick_smem_optin(int device) {
    int optin = 0;
    const BisOnDevice check(device);
    if (check.err != cudaSuccess
        || cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  device) != cudaSuccess)
        return 0;
    return optin;
}

// brick_smem, brick_shared, brick_part and BIS_SB_BRICK_THREADS, for
// ops/block_trisolve to check its mirror against.
long long bis_super_solve_brick_smem(int n_levels, int by, int bz, int rx,
                                     int ry, int rz, int sy, int sz, int nx,
                                     int itemsize, int drows) {
    return (long long)brick_smem(n_levels, by, bz, rx, ry, rz, sy, sz, nx,
                                 (size_t)itemsize, drows != 0);
}

int bis_super_solve_brick_threads(void) { return BIS_SB_BRICK_THREADS; }

int bis_super_solve_brick_parts(int itemsize, int by, int bz, int ry, int rz,
                                int sy, int sz, int* shared, int* part) {
    *shared = brick_shared((size_t)itemsize);
    *part = brick_part(by, bz, ry, rz, sy, sz);
    return 0;
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

// The rank-space level's vec route: bis_rank_level_vec_<type>.
int bis_rank_level_vec_f32(int device, const BisRankVecArgs* a, int threads,
                           const float* y, float* x, const float* vals,
                           const float* dinv, void* stream) {
    return launch_rank_level_vec<float>(device, a, threads, y, x, vals, dinv,
                                        (cudaStream_t)stream);
}

int bis_rank_level_vec_f64(int device, const BisRankVecArgs* a, int threads,
                           const double* y, double* x, const double* vals,
                           const double* dinv, void* stream) {
    return launch_rank_level_vec<double>(device, a, threads, y, x, vals,
                                         dinv, (cudaStream_t)stream);
}

int bis_rank_vec_limits(int* max_groups, int* win, int* threads) {
    *max_groups = BIS_RV_MAX_GROUPS;
    *win = BIS_RV_WIN;
    *threads = BIS_RV_THREADS;
    return 0;
}

int bis_rank_vec_args_size(void) { return (int)sizeof(BisRankVecArgs); }

int bis_super_level_args_size(void) { return (int)sizeof(BisSuperLevelArgs); }

}  // extern "C"
