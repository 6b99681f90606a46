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
// vector) streams from HBM.  Two routes, chosen before the launch by the
// wrapper (stencil_op.route_for):
//   * "legs", the first port's simple design: threads along x so that
//     neighbouring threads read neighbouring addresses, a grid over
//     (y-tile, z), the neighbour reads served by L1/L2, legs walked in a
//     runtime loop with a bounds check each.  That loop, not the bytes,
//     bounds it on an H100 (the same ~27 G rows/s at 128^3 and at 384^3,
//     where HBM would allow ~15x more).  Any legs.
//   * "box", for legs within the 3 x 3 x 3 box (every stencil the repo
//     builds): the legs unrolled over the box, a thread's neighbourhood
//     kept in registers as it marches along z; see "The box routes"
//     below.
//
// Dot partials go to a (n_blocks, n_dots) buffer that the caller sums, so
// the result is deterministic without atomics.  They are float64 for every
// vector type: a float32 row's product is rounded in float32 and summed in
// float64 (ops/blas1.whole_dot's rule), and the caller rounds the whole
// sum once, so a float32 dot does not hang on how the rows are cut into
// blocks or mesh shards.
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
// version's separate PyTorch operations do.  Two routes, as the SpMV's
// (stencil_op.gs_route_for): "legs" (the first port's leg loop, any legs
// and colourings) and "box" (#1's box pieces with the step's epilogue, for
// legs within the box under a parity or grid colouring; see "#3 on the
// box route" below).
//
// A dense diagonal stored in bfloat16 (the JAX package's --matrix-dtype
// bfloat16 on a stencil with one, e.g. Anderson's random potential): every
// kernel here takes a second type parameter D for `diag`.  Each diag[i] is
// widened exactly (__bfloat162float, then to T) and its product with x[i]
// rounded in T as in the T form, so the bf16 forms equal their plain
// versions (diag.to(x.dtype)) as the T forms do.  The coefficients of the
// launch table are already the values rounded to the matrix dtype, carried
// as doubles and used as T: exact.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <algorithm>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bis_device.cuh"

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
    // the box routes: group g's legs as bits (dz+1)*9 + (dy+1)*3 + (dx+1)
    // of the 3 x 3 x 3 box (0 where a leg lies outside it)
    int box_mask[BIS_MAX_LEGS];
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

// Each sum and product rounded on its own (no contraction to a fused
// multiply-add), so that the SpMV's two kernels agree bit for bit.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// A stored diagonal value as the vector type T: exact for every D.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// y for the grid row (gx, gy, gz), whose x entry is x[ix] and whose
// diagonal entry is diag[id]: each coefficient group's in-bounds legs
// summed, times the group's coefficient, plus diag[id]*x[ix].  The
// single-device kernels pass ix = id = i; a mesh shard passes its row's
// place in its x window and in its own rows.
template <typename T, typename D>
__device__ __forceinline__ T stencil_row(const BisStencilArgs& a,
                                         const T* __restrict__ x,
                                         const D* __restrict__ diag,
                                         long long ix, long long id, int gx,
                                         int gy, int gz) {
    T acc = T(0);
    for (int g = 0; g < a.n_groups; ++g) {
        T s = T(0);
        for (int l = a.group_begin[g]; l < a.group_begin[g + 1]; ++l) {
            const int px = gx + a.dx[l], py = gy + a.dy[l], pz = gz + a.dz[l];
            if (px >= 0 && px < a.nx && py >= 0 && py < a.ny &&
                pz >= 0 && pz < a.nz)
                s = add_rn(s, x[ix + a.off[l]]);
        }
        acc = add_rn(acc, mul_rn(T(a.group_coeff[g]), s));
    }
    if (diag != nullptr) acc = add_rn(acc, mul_rn(T(widen(diag[id])), x[ix]));
    return acc;
}

template <typename T, typename D>
__global__ void __launch_bounds__(256)
stencil_spmv_kernel(const __grid_constant__ BisStencilArgs a,
                    const T* __restrict__ x,
                    const D* __restrict__ diag, const T* __restrict__ aux,
                    T* __restrict__ y, double* __restrict__ partials) {
    const int gy = blockIdx.x * a.block_y + threadIdx.y;
    const int gz = blockIdx.y;
    double dsum[BIS_MAX_DOTS] = {0.0, 0.0, 0.0};
    if (gy < a.ny) {
        const long long row = (long long)a.nx * (gy + (long long)a.ny * gz);
        for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
            const long long i = row + gx;
            const T acc = stencil_row(a, x, diag, i, i, gx, gy, gz);
            y[i] = acc;
            for (int k = 0; k < a.n_dots; ++k) {
                const int kind = a.dot_kind[k];
                const T v = kind == 0 ? x[i] : (kind == 1 ? acc : aux[i]);
                dsum[k] += (double)(acc * v);
            }
        }
    }
    if (a.n_dots > 0)
        block_sums(dsum, a.n_dots,
                   partials + (long long)(blockIdx.x + gridDim.x * blockIdx.y) *
                                  a.n_dots);
}

// ---------------------------------------------------------------------------
// Kernel #2: the same SpMV with x staged in shared memory.
//
// Replaces the Pallas kernel basic_iterative_solvers_tpu/stencil_op.py:
// stencil_spmv_stream, #1's contract computed from a 3-slot VMEM ring in
// which every x block is fetched from HBM once.  Here a block owns a
// BIS_STREAM_TX x BIS_STREAM_TY tile of (x, y) and marches along a chunk
// of z.  It keeps a ring of three z-planes of x in shared memory, each the
// tile plus a halo of BIS_STREAM_HX in x and BIS_STREAM_HY in y (zeros
// outside the grid), loads one new plane a step and computes one output
// plane from the ring: step z loads plane z + 1 and computes plane z, the
// CUDA form of the ring's "step j loads block j, computes tile j - 1".
// The legs are read from shared memory with no bounds check: a leg that
// leaves the grid reads a staged zero, and s + 0 is s, so y equals #1's
// (same groups, same order, each sum and product rounded alone).  Legs
// must lie within the halo: |dx| <= BIS_STREAM_HX, |dy| <= BIS_STREAM_HY,
// |dz| <= 1; the wrapper routes any other operator to #1, and this
// entry point refuses it.
//
// What bounds it: the floor is the same as #1's (x and y, plus diag and
// aux, over HBM).  The design removes #1's per-leg bounds checks and
// serves the 27 neighbour reads from shared memory; each x element is
// read from L2/HBM (TX + 2)(TY + 4)/(TX TY) ~ 1.6 times per tile plus
// (zc + 2)/zc along z.  Its runtime leg loop and synchronous plane loads
// bound it.  This is #2's "legs" route, for any legs within its halo; the
// operators within the 3 x 3 x 3 box whose lines are whole 16-byte
// vectors take #2's "box" route below (bulk-copied planes, unrolled legs).
// ---------------------------------------------------------------------------

#define BIS_STREAM_TX 32
#define BIS_STREAM_TY 8
#define BIS_STREAM_HX 1
#define BIS_STREAM_HY 2
#define BIS_STREAM_PW (BIS_STREAM_TX + 2 * BIS_STREAM_HX)
#define BIS_STREAM_PH (BIS_STREAM_TY + 2 * BIS_STREAM_HY)
#define BIS_STREAM_PLANE (BIS_STREAM_PW * BIS_STREAM_PH)

// Stage plane z of x (tile + halo, zeros outside the grid) at `plane`.
template <typename T>
__device__ __forceinline__ void stream_load_plane(const BisStencilArgs& a,
                                                  const T* __restrict__ x,
                                                  int x0, int y0, int z,
                                                  T* plane) {
    const int tid = threadIdx.x + BIS_STREAM_TX * threadIdx.y;
    const bool z_ok = z >= 0 && z < a.nz;
    for (int e = tid; e < BIS_STREAM_PLANE;
         e += BIS_STREAM_TX * BIS_STREAM_TY) {
        const int r = e / BIS_STREAM_PW, c = e - r * BIS_STREAM_PW;
        const int px = x0 - BIS_STREAM_HX + c, py = y0 - BIS_STREAM_HY + r;
        T v = T(0);
        if (z_ok && px >= 0 && px < a.nx && py >= 0 && py < a.ny)
            v = x[(long long)a.nx * (py + (long long)a.ny * z) + px];
        plane[e] = v;
    }
}

template <typename T, typename D>
__global__ void __launch_bounds__(BIS_STREAM_TX * BIS_STREAM_TY)
stencil_spmv_stream_kernel(const __grid_constant__ BisStencilArgs a, int zc,
                           const T* __restrict__ x,
                           const D* __restrict__ diag,
                           const T* __restrict__ aux, T* __restrict__ y,
                           double* __restrict__ partials) {
    __shared__ T ring[3 * BIS_STREAM_PLANE];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int x0 = blockIdx.x * BIS_STREAM_TX, y0 = blockIdx.y * BIS_STREAM_TY;
    const int z0 = blockIdx.z * zc;
    const int z1 = min(z0 + zc, a.nz);
    const int gx = x0 + tx, gy = y0 + ty;
    const bool own = gx < a.nx && gy < a.ny;
    const int centre = (ty + BIS_STREAM_HY) * BIS_STREAM_PW + tx + BIS_STREAM_HX;
    // planes below and above the chunk are staged only where a leg reads
    // them (a 2-D operator stages one plane)
    bool need_m = false, need_p = false;
    for (int l = 0; l < a.group_begin[a.n_groups]; ++l) {
        need_m |= a.dz[l] < 0;
        need_p |= a.dz[l] > 0;
    }
    // ring slots (offsets into `ring`) of planes z - 1, z and z + 1
    int om = 0, o0 = BIS_STREAM_PLANE, op = 2 * BIS_STREAM_PLANE;
    if (need_m) stream_load_plane(a, x, x0, y0, z0 - 1, ring + om);
    stream_load_plane(a, x, x0, y0, z0, ring + o0);
    double dsum[BIS_MAX_DOTS] = {0.0, 0.0, 0.0};
    for (int z = z0; z < z1; ++z) {
        if (need_p || z + 1 < z1)
            stream_load_plane(a, x, x0, y0, z + 1, ring + op);
        __syncthreads();
        if (own) {
            T acc = T(0);
            for (int g = 0; g < a.n_groups; ++g) {
                T s = T(0);
                for (int l = a.group_begin[g]; l < a.group_begin[g + 1]; ++l) {
                    const int o = a.dz[l] < 0 ? om : (a.dz[l] > 0 ? op : o0);
                    s = add_rn(s, ring[o + centre + a.dy[l] * BIS_STREAM_PW +
                                       a.dx[l]]);
                }
                acc = add_rn(acc, mul_rn(T(a.group_coeff[g]), s));
            }
            const long long i =
                (long long)a.nx * (gy + (long long)a.ny * z) + gx;
            const T xi = ring[o0 + centre];
            if (diag != nullptr)
                acc = add_rn(acc, mul_rn(T(widen(diag[i])), xi));
            y[i] = acc;
            for (int k = 0; k < a.n_dots; ++k) {
                const int kind = a.dot_kind[k];
                const T v = kind == 0 ? xi : (kind == 1 ? acc : aux[i]);
                dsum[k] += (double)(acc * v);
            }
        }
        __syncthreads();          // plane z - 1's slot is loaded next step
        const int t = om;
        om = o0;
        o0 = op;
        op = t;
    }
    if (a.n_dots > 0)
        block_sums(dsum, a.n_dots,
                   partials + (long long)(blockIdx.x + gridDim.x *
                                          (blockIdx.y + (long long)gridDim.y *
                                           blockIdx.z)) * a.n_dots);
}

// ---------------------------------------------------------------------------
// The box routes of #1 and #2: every leg within |dx|, |dy|, |dz| <= 1.
//
// The forms above walk the launch table's legs in a runtime loop, and #1
// tests six bounds and makes one scalar load a leg: ~27 G rows/s at 128^3
// and at 384^3 alike, 15x (#1) and 10x (#2) over the byte bound at 384^3.
// The box routes keep a row's neighbourhood in registers instead:
//
//   * A thread owns a chunk of VEC consecutive x (VEC = 16 / sizeof(T)
//     where a line is a whole number of 16-byte vectors, else 1) and
//     marches a run of zr planes along z.  It keeps the 3 x (VEC + 2)
//     neighbourhood of planes z - 1, z and z + 1 in registers (arrays
//     whose roles rotate, the loop unrolled), so each step loads one
//     plane's three lines: three VEC-wide loads, their x neighbours from
//     the next lanes by shuffles (a direct load at a warp's edge).  #1
//     keeps a fourth window and loads plane z + 2 while it computes plane
//     z.  A value outside the grid is a zero in the window, set once a
//     line where it is loaded: no leg tests a bound.
//   * The legs are unrolled over the 27 positions of the box.  A group's
//     positions are the bits of box_mask[g], the same for every thread,
//     so each test is uniform; a group's sum runs over them in z, y, x
//     order, the order of its legs in the launch table.  Each sum and
//     product is rounded alone (add_rn/mul_rn) as in the forms above, and
//     a leg outside the grid adds a zero: a sum that starts at +0 in
//     round-to-nearest is never -0, so s + 0 is s, and y is bit-equal to
//     the leg loop's.
//   * #1 ("resident") loads the lines from L2/HBM through L1.  #2
//     ("stream") stages them: a producer warp copies each plane's slab,
//     the contiguous range of the plane that its block's chunks and their
//     y neighbours cover, with one cp.async.bulk into a ring of
//     BIS_BOX_STAGES slots (a full and an empty mbarrier each), up to the
//     ring's depth ahead of the eight consumer warps, which read the
//     window's new lines from shared memory and release the slot.
//   * A 2-D operator (nz = 1) comes with its y axis as z (legs (dx, dy, 0)
//     as (dx, 0, dy): the same flat offsets, masks and leg order), so the
//     march runs along y.
//
// What bounds them: bytes, at the floor.  A row needs ~27 adds and one
// multiply a group (2 groups on HPCG), ~6x under the byte bound at the
// card's float32 rate; the route's cost per row is its instructions (the
// uniform position tests, amortised over VEC rows, and the adds) and the
// loads in flight per SM: resident blocks an SM (#1 two, at ~110-128
// registers a thread; #2 three in f32, at most 72, two in f64), and a
// grid whose z runs are cut to whole waves of them
// (stencil_op._box_grid).
// ---------------------------------------------------------------------------

#define BIS_BOX_THREADS 256      // consumer threads a block, a chunk each
#define BIS_BOX_STAGES 8         // #2's ring of staged planes
#define BIS_BOX_RING_OFFSET 128  // #2's ring after its mbarriers (bytes)
#define BIS_BOX_MIN_BLOCKS 2         // #1's resident blocks an SM
#define BIS_BOX_STREAM_MIN_BLOCKS 3  // #2's in f32 (where its ring fits
                                     // three times; f64: two)
#define BIS_GS_BOX_FLAT_BLOCKS 4     // #3's on a flat plane (LINES = 1)

// #2's box blocks resident an SM: three in f32, two (#1's) in f64
template <typename T> struct BisStreamBoxBlocks {
    static constexpr int value = sizeof(T) == 4 ? BIS_BOX_STREAM_MIN_BLOCKS
                                                : BIS_BOX_MIN_BLOCKS;
};

template <typename T, int VEC> struct BisVec;
template <> struct BisVec<float, 1> { using type = float; };
template <> struct BisVec<double, 1> { using type = double; };
template <> struct BisVec<float, 4> { using type = float4; };
template <> struct BisVec<double, 2> { using type = double2; };

// VEC consecutive values at p (16-byte aligned when VEC > 1)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[VEC]) {
    const typename BisVec<T, VEC>::type u =
        *reinterpret_cast<const typename BisVec<T, VEC>::type*>(p);
    memcpy(v, &u, sizeof(u));
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[VEC]) {
    typename BisVec<T, VEC>::type u;
    memcpy(&u, v, sizeof(u));
    *reinterpret_cast<typename BisVec<T, VEC>::type*>(p) = u;
}

// a diagonal stored in T is read as vectors; a bf16 one value by value
template <typename T, int VEC>
__device__ __forceinline__ void load_diag(const T* p, T (&v)[VEC]) {
    load_vec<T, VEC>(p, v);
}
template <typename T, int VEC>
__device__ __forceinline__ void load_diag(const __nv_bfloat16* p,
                                          T (&v)[VEC]) {
#pragma unroll
    for (int r = 0; r < VEC; ++r) v[r] = T(widen(p[r]));
}

// Fetch one line of the window: w[1..VEC] the values at x0 .. x0 + VEC - 1,
// read from src at element e (the chunk's first value), and, in lanes 0
// and 31 only, w[0] at x0 - 1 and w[VEC + 1] at x0 + VEC (the other lanes
// take theirs from the lanes beside them in box_assemble); zeros where the
// line (`ok`) or the x neighbour (`has_l`, `has_r`) lies outside the
// grid.  Loads only: the values are used a plane later.
template <typename T, int VEC>
__device__ __forceinline__ void box_fetch_line(const T* src, long long e,
                                               bool ok, bool has_l,
                                               bool has_r, int lane,
                                               T (&w)[VEC + 2]) {
    T v[VEC];
    if (ok) {
        load_vec<T, VEC>(src + e, v);
    } else {
#pragma unroll
        for (int r = 0; r < VEC; ++r) v[r] = T(0);
    }
#pragma unroll
    for (int r = 0; r < VEC; ++r) w[r + 1] = v[r];
    w[0] = (lane == 0 && ok && has_l) ? src[e - 1] : T(0);
    w[VEC + 1] = (lane == 31 && ok && has_r) ? src[e + VEC] : T(0);
}

// Complete a fetched plane: the x neighbours of lanes 1..31 (left) and
// 0..30 (right) from the lanes beside them, which hold the chunks beside
// this one (a warp's chunks are consecutive; at a line's end the
// neighbour lies outside the grid and is a zero).  Every lane calls it.
template <typename T, int VEC, int LINES = 3>
__device__ __forceinline__ void box_assemble(bool has_l, bool has_r, int lane,
                                             T (&P)[3][VEC + 2]) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
        if (LINES == 1 && dy != 1) continue;  // a flat plane: one line
        const T l = __shfl_up_sync(0xffffffffu, P[dy][VEC], 1);
        const T r = __shfl_down_sync(0xffffffffu, P[dy][1], 1);
        if (lane != 0) P[dy][0] = has_l ? l : T(0);
        if (lane != 31) P[dy][VEC + 1] = has_r ? r : T(0);
    }
}

// s[r] += the positions of `m` (bits 3*dy + dx) of one plane's window, in
// y, x order, for the VEC rows of the chunk
template <typename T, int VEC>
__device__ __forceinline__ void box_plane_sum(unsigned m,
                                              const T (&P)[3][VEC + 2],
                                              T (&s)[VEC]) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
        if (!((m >> (3 * dy)) & 7u)) continue;    // a row of the box unused
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
            if (m & (1u << (3 * dy + dx))) {
#pragma unroll
                for (int r = 0; r < VEC; ++r)
                    s[r] = add_rn(s[r], P[dy][r + dx]);
            }
        }
    }
}

// A·x (without the dense diagonal) for the VEC rows of a chunk from the
// windows of planes z - 1, z, z + 1: each group's positions summed in
// z, y, x order, times its coefficient, the groups in table order
template <typename T, int VEC>
__device__ __forceinline__ void box_rows(const BisStencilArgs& a,
                                         const T (&pm)[3][VEC + 2],
                                         const T (&p0)[3][VEC + 2],
                                         const T (&pp)[3][VEC + 2],
                                         T (&acc)[VEC]) {
#pragma unroll
    for (int r = 0; r < VEC; ++r) acc[r] = T(0);
    for (int g = 0; g < a.n_groups; ++g) {
        const unsigned m = (unsigned)a.box_mask[g];
        T s[VEC];
#pragma unroll
        for (int r = 0; r < VEC; ++r) s[r] = T(0);
        box_plane_sum<T, VEC>(m, pm, s);
        box_plane_sum<T, VEC>(m >> 9, p0, s);
        box_plane_sum<T, VEC>(m >> 18, pp, s);
        const T c = T(a.group_coeff[g]);
#pragma unroll
        for (int r = 0; r < VEC; ++r) acc[r] = add_rn(acc[r], mul_rn(c, s[r]));
    }
}

// The march over planes [z0, z1): fetch(q, P) loads plane q's window into
// P (zeros for a plane outside [0, nz) or past z1), assemble(P) completes
// it, out(z, pm, p0, pp) writes plane z's rows.  The windows rotate roles
// (none is copied).  With PREFETCH (#1: global loads) four windows, and
// plane z + 2 is fetched before plane z is computed, so its loads are in
// flight meanwhile; without (#2: the planes wait in shared memory, staged
// ahead by the producer) three, each fetched just before it is used.
template <typename T, int VEC, bool PREFETCH, typename Fetch,
          typename Assemble, typename Out>
__device__ __forceinline__ void box_march(int z0, int z1, Fetch& fetch,
                                          Assemble& assemble, Out& out) {
    if constexpr (PREFETCH) {
        T W0[3][VEC + 2], W1[3][VEC + 2], W2[3][VEC + 2], W3[3][VEC + 2];
        fetch(z0 - 1, W0);
        fetch(z0, W1);
        fetch(z0 + 1, W2);
        assemble(W0);
        assemble(W1);
        assemble(W2);
        for (int z = z0; z < z1; z += 4) {
            fetch(z + 2, W3);
            out(z, W0, W1, W2);
            assemble(W3);
            if (z + 1 >= z1) break;
            fetch(z + 3, W0);
            out(z + 1, W1, W2, W3);
            assemble(W0);
            if (z + 2 >= z1) break;
            fetch(z + 4, W1);
            out(z + 2, W2, W3, W0);
            assemble(W1);
            if (z + 3 >= z1) break;
            fetch(z + 5, W2);
            out(z + 3, W3, W0, W1);
            assemble(W2);
        }
    } else {
        T W0[3][VEC + 2], W1[3][VEC + 2], W2[3][VEC + 2];
        auto load = [&](int q, T (&P)[3][VEC + 2]) {
            fetch(q, P);
            assemble(P);
        };
        load(z0 - 1, W0);
        load(z0, W1);
        for (int z = z0; z < z1; z += 3) {
            load(z + 1, W2);
            out(z, W0, W1, W2);
            if (z + 1 >= z1) break;
            load(z + 2, W0);
            out(z + 1, W1, W2, W0);
            if (z + 2 >= z1) break;
            load(z + 3, W1);
            out(z + 2, W2, W0, W1);
        }
    }
}

// A thread's chunk: its place in the plane and which neighbours exist.
struct BisBoxChunk {
    long long e0;                         // its first element in a plane
    int x0;
    bool live, has_l, has_r, ok_m, ok_p;  // ok_m, ok_p: lines gy - 1, gy + 1
};

template <int VEC>
__device__ __forceinline__ BisBoxChunk box_chunk(const BisStencilArgs& a,
                                                 long long c) {
    BisBoxChunk k;
    const long long chunks = (long long)a.nx * a.ny / VEC;
    const int cpl = a.nx / VEC;
    k.live = c < chunks;
    const int gy = k.live ? (int)(c / cpl) : 0;
    k.x0 = k.live ? (int)(c - (long long)gy * cpl) * VEC : 0;
    k.e0 = k.live ? c * VEC : 0;
    k.has_l = k.live && k.x0 > 0;
    k.has_r = k.live && k.x0 + VEC < a.nx;
    k.ok_m = k.live && gy > 0;
    k.ok_p = k.live && gy + 1 < a.ny;
    return k;
}

// Store a chunk's rows at flat row i (adding the dense diagonal) and add
// their dot terms.
template <typename T, typename D, int VEC>
__device__ __forceinline__ void box_store(const BisStencilArgs& a,
                                          const BisBoxChunk& k, long long i,
                                          T (&acc)[VEC],
                                          const T (&xc)[VEC + 2],
                                          const D* __restrict__ diag,
                                          const T* __restrict__ aux,
                                          T* __restrict__ y,
                                          double (&dsum)[BIS_MAX_DOTS]) {
    if (!k.live) return;
    if (diag != nullptr) {
        T d[VEC];
        load_diag<T, VEC>(diag + i, d);
#pragma unroll
        for (int r = 0; r < VEC; ++r)
            acc[r] = add_rn(acc[r], mul_rn(d[r], xc[r + 1]));
    }
    store_vec<T, VEC>(y + i, acc);
    if (a.n_dots > 0) {
        T av[VEC];
        if (aux != nullptr) {
            load_vec<T, VEC>(aux + i, av);
        } else {
#pragma unroll
            for (int r = 0; r < VEC; ++r) av[r] = T(0);
        }
        for (int q = 0; q < a.n_dots; ++q) {
            const int kind = a.dot_kind[q];
#pragma unroll
            for (int r = 0; r < VEC; ++r) {
                const T v = kind == 0 ? xc[r + 1]
                                      : (kind == 1 ? acc[r] : av[r]);
                dsum[q] += (double)(acc[r] * v);
            }
        }
    }
}

// #1 on the box route: grid (tiles of BIS_BOX_THREADS chunks, runs of zr
// planes); x read from global memory.
template <typename T, typename D, int VEC>
__global__ void __launch_bounds__(BIS_BOX_THREADS, BIS_BOX_MIN_BLOCKS)
stencil_spmv_box_kernel(const __grid_constant__ BisStencilArgs a, int zr,
                        const T* __restrict__ x, const D* __restrict__ diag,
                        const T* __restrict__ aux, T* __restrict__ y,
                        double* __restrict__ partials) {
    const long long plane = (long long)a.nx * a.ny;
    const BisBoxChunk k = box_chunk<VEC>(
        a, (long long)blockIdx.x * BIS_BOX_THREADS + threadIdx.x);
    const int lane = threadIdx.x & 31;
    const int z0 = blockIdx.y * zr, z1 = min(z0 + zr, a.nz);
    double dsum[BIS_MAX_DOTS] = {0.0, 0.0, 0.0};
    auto fetch = [&](int q, T (&P)[3][VEC + 2]) {
        const bool q_ok = q >= 0 && q < a.nz && q <= z1;
        const T* src = x + (q_ok ? (long long)q * plane : 0LL);
        box_fetch_line<T, VEC>(src, k.e0 - a.nx, q_ok && k.ok_m, k.has_l,
                               k.has_r, lane, P[0]);
        box_fetch_line<T, VEC>(src, k.e0, q_ok && k.live, k.has_l, k.has_r,
                               lane, P[1]);
        box_fetch_line<T, VEC>(src, k.e0 + a.nx, q_ok && k.ok_p, k.has_l,
                               k.has_r, lane, P[2]);
    };
    auto assemble = [&](T (&P)[3][VEC + 2]) {
        box_assemble<T, VEC>(k.has_l, k.has_r, lane, P);
    };
    auto out = [&](int z, const T (&pm)[3][VEC + 2],
                   const T (&p0)[3][VEC + 2], const T (&pp)[3][VEC + 2]) {
        T acc[VEC];
        box_rows<T, VEC>(a, pm, p0, pp, acc);
        box_store<T, D, VEC>(a, k, (long long)z * plane + k.e0, acc, p0[1],
                             diag, aux, y, dsum);
    };
    box_march<T, VEC, true>(z0, z1, fetch, assemble, out);
    if (a.n_dots > 0)
        block_sums(dsum, a.n_dots,
                   partials + (long long)(blockIdx.x + (long long)gridDim.x *
                                          blockIdx.y) * a.n_dots);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
    unsigned done = 0;
    while (!done) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory to shared
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// #2 on the box route: #1's grid and march, the window's lines read from a
// ring of staged slabs.  Block: BIS_BOX_THREADS consumers and one producer
// warp.  A block's slab is the elements [lo, hi) of a plane: its chunks'
// range widened by a line and a vector on each side, cut to the plane; a
// slot holds `slot` elements (the widest slab).  Its planes run from
// qa = max(z0 - 1, 0) to qb = min(z1, nz - 1); plane q takes slot
// (q - qa) % BIS_BOX_STAGES on that slot's ((q - qa) / BIS_BOX_STAGES)-th
// use.
template <typename T, typename D, int VEC>
__global__ void __launch_bounds__(BIS_BOX_THREADS + 32,
                                  BisStreamBoxBlocks<T>::value)
stencil_spmv_stream_box_kernel(const __grid_constant__ BisStencilArgs a,
                               int zr, int slot, const T* __restrict__ x,
                               const D* __restrict__ diag,
                               const T* __restrict__ aux, T* __restrict__ y,
                               double* __restrict__ partials) {
    extern __shared__ __align__(128) unsigned char box_smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(box_smem);
    uint64_t* empty = full + BIS_BOX_STAGES;
    T* ring = reinterpret_cast<T*>(box_smem + BIS_BOX_RING_OFFSET);
    const long long plane = (long long)a.nx * a.ny;
    const long long cb = (long long)blockIdx.x * BIS_BOX_THREADS;
    const long long ce = min(cb + BIS_BOX_THREADS, plane / VEC);
    const long long lo = max(0LL, cb * VEC - a.nx - VEC);
    const long long hi = min(plane, ce * VEC + a.nx + VEC);
    const int z0 = blockIdx.y * zr, z1 = min(z0 + zr, a.nz);
    const int qa = max(z0 - 1, 0), qb = min(z1, a.nz - 1);
    if (threadIdx.x == 0) {
        for (int s = 0; s < BIS_BOX_STAGES; ++s) {
            bar_init(&full[s], 1);
            bar_init(&empty[s], BIS_BOX_THREADS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    double dsum[BIS_MAX_DOTS] = {0.0, 0.0, 0.0};
    if (threadIdx.x >= BIS_BOX_THREADS) {
        if (threadIdx.x == BIS_BOX_THREADS) {     // the producer lane
            const unsigned bytes = (unsigned)((hi - lo) * sizeof(T));
            for (int q = qa; q <= qb; ++q) {
                const int j = q - qa, s = j % BIS_BOX_STAGES;
                if (j >= BIS_BOX_STAGES)
                    bar_wait(&empty[s], ((j / BIS_BOX_STAGES) - 1) & 1);
                bar_expect(&full[s], bytes);
                bulk_load(ring + (long long)s * slot,
                          x + (long long)q * plane + lo, bytes, &full[s]);
            }
        }
    } else {
        const BisBoxChunk k = box_chunk<VEC>(a, cb + threadIdx.x);
        const int lane = threadIdx.x & 31;
        auto fetch = [&](int q, T (&P)[3][VEC + 2]) {
            const bool q_ok = q >= qa && q <= qb;
            int s = 0;
            if (q_ok) {
                const int j = q - qa;
                s = j % BIS_BOX_STAGES;
                bar_wait(&full[s], (j / BIS_BOX_STAGES) & 1);
            }
            const T* src = ring + (long long)s * slot - lo;
            box_fetch_line<T, VEC>(src, k.e0 - a.nx, q_ok && k.ok_m, k.has_l,
                                   k.has_r, lane, P[0]);
            box_fetch_line<T, VEC>(src, k.e0, q_ok && k.live, k.has_l,
                                   k.has_r, lane, P[1]);
            box_fetch_line<T, VEC>(src, k.e0 + a.nx, q_ok && k.ok_p,
                                   k.has_l, k.has_r, lane, P[2]);
            if (q_ok) {                 // the slot's values are in registers
                __syncwarp();
                if (lane == 0) bar_arrive(&empty[s]);
            }
        };
        auto assemble = [&](T (&P)[3][VEC + 2]) {
            box_assemble<T, VEC>(k.has_l, k.has_r, lane, P);
        };
        auto out = [&](int z, const T (&pm)[3][VEC + 2],
                       const T (&p0)[3][VEC + 2], const T (&pp)[3][VEC + 2]) {
            T acc[VEC];
            box_rows<T, VEC>(a, pm, p0, pp, acc);
            box_store<T, D, VEC>(a, k, (long long)z * plane + k.e0, acc,
                                 p0[1], diag, aux, y, dsum);
        };
        box_march<T, VEC, false>(z0, z1, fetch, assemble, out);
    }
    if (a.n_dots > 0)
        block_sums(dsum, a.n_dots,
                   partials + (long long)(blockIdx.x + (long long)gridDim.x *
                                          blockIdx.y) * a.n_dots);
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

template <typename T, typename D>
__global__ void __launch_bounds__(256)
stencil_gs_color_step_kernel(const __grid_constant__ BisStencilArgs a,
                             const BisColorStep c, const T* __restrict__ x,
                             const D* __restrict__ diag,
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
            const T ax = stencil_row(a, x, diag, i, i, gx, gy, gz);
            xi = add_rn(xi, mul_rn(sub_rn(rhs[i], ax), dinv[i]));
        }
        out[i] = xi;
    }
}

// ---------------------------------------------------------------------------
// #3 on the box route (stencil_gs_color_step_box_kernel), one kernel for
// the single-device step and the shard form.
//
// The leg-loop kernels above run PR 3's stencil_row: runtime groups and
// legs, six bounds tests a leg, one scalar row a thread, and color_of per
// row (three % a row for a grid colouring): 2.9-3.1x the byte bound on
// fdm:2048.  The box route takes #1's box pieces (box_chunk,
// box_fetch_line / box_assemble, box_rows, box_march) and adds the step's
// epilogue:
//   - a thread owns VEC = 16 / sizeof(T) rows of a line and marches a run
//     of zr planes with its three planes in registers (a 2-D operator in
//     box_form: the march runs along y); A x of the VEC rows from
//     box_rows, the dense diagonal added as box_store adds it;
//   - the colour is worked out once a chunk and plane, as a bit per row:
//     parity from (x0 + y + z + c) & 1, the rows alternating; grid from
//     (y mod sy, z mod sz) against the colour's (y, z) part, and x0 mod sx
//     taken once a thread (the rows' x colours stepped from it).  The host
//     passes the grid's strides in box_form's axes ((sx, 1, sy) for a 2-D
//     operator).  The mod kind, which no stencil uses, stays on the legs
//     route;
//   - a chunk with no row of colour c copies x through and reads neither
//     rhs nor dinv (a grid colouring's other lines); otherwise rhs and dinv
//     are read as 16-byte vectors (under a parity colouring every 32-byte
//     sector holds rows of both colours, so the card fetches them whole)
//     and x' = x + (rhs - A x) * dinv on the colour's rows, each
//     difference, product and sum rounded alone, as stencil_row's
//     epilogue: x' equals the leg loop's bit for bit;
//   - x' is stored as 16-byte vectors (out of place);
//   - a flat plane (box_form's ny = 1: every 2-D operator, fdm:2048) has
//     one line: the kernel (LINES = 1) keeps no lines beside it, which
//     cuts its registers, and runs BIS_GS_BOX_FLAT_BLOCKS blocks an SM
//     (three lines a plane: #1's two).
//
// The shard form is the same kernel on a window.  A launch owns global
// rows [row0, row0 + rows) (whole lines) and reads x from xw (wlen
// values, global row i at xw[hneg + i - row0]); rhs, dinv, diag and out
// are the launch's own rows.  The single-device step is row0 = 0, rows = n,
// hneg = 0, wlen = n.  The grid's runs cover the box_form planes that
// hold the launch's rows; a chunk outside them does nothing, a row at or
// past n (a mesh's inert padding) copies x through.  A line is read only
// where it lies in the grid and in the window (zeros elsewhere).  The
// launch needs hneg, hpos = wlen - hneg - rows and row0 in whole vectors:
// with the halo the operator's largest leg offsets, an in-box leg's line
// then lies within the window, so every line an owned row reads is there.
// What bounds it: bytes, at the floor (x read, x' written, rhs and dinv on
// the lines holding colour c); the register march as #1's box route.
// ---------------------------------------------------------------------------

// Fetch plane q's three lines of a chunk from a shard's window: global
// row i at xw[base + i] (base = hneg - row0), a line read only where it lies
// in the grid, in planes [0, min(nz, z1 + 1)) and inside the window's wlen
// values (zeros elsewhere); LINES = 1 (a flat plane) keeps only the
// chunk's own line.
template <typename T, int VEC, int LINES>
__device__ __forceinline__ void box_fetch_window(const BisStencilArgs& a,
                                                 const BisBoxChunk& k,
                                                 int lane,
                                                 const T* __restrict__ xw,
                                                 long long base,
                                                 long long wlen, int q,
                                                 int z1,
                                                 T (&P)[3][VEC + 2]) {
    const long long plane = (long long)a.nx * a.ny;
    const bool q_ok = q >= 0 && q < a.nz && q <= z1;
    const bool ok[3] = {q_ok && k.ok_m, q_ok && k.live, q_ok && k.ok_p};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        if (LINES == 1 && j != 1) {           // no line beside a flat one
#pragma unroll
            for (int r = 0; r < VEC + 2; ++r) P[j][r] = T(0);
            continue;
        }
        const long long ew = base + (long long)q * plane + k.e0 +
                             (long long)(j - 1) * a.nx;
        const bool in = ok[j] && ew >= 0 && ew + VEC <= wlen;
        box_fetch_line<T, VEC>(xw, in ? ew : 0, in, k.has_l && ew > 0,
                               k.has_r && ew + VEC < wlen, lane, P[j]);
    }
}

// Rows of a chunk (bit r: row x0 + r) with colour c.color, for the
// chunk's line gy (box_form) at plane z; xm: the rows whose x colour is
// the target's (grid).
template <int VEC>
__device__ __forceinline__ unsigned gs_box_rows(const BisColorStep& c,
                                                int x0, int gy, int z,
                                                unsigned xm) {
    constexpr unsigned full = (1u << VEC) - 1u;
    if (c.kind == 0)
        return ((x0 + gy + z + c.color) & 1) ? (0xAAu & full)
                                             : (0x55u & full);
    const int cyz = gy % c.p[1] + c.p[1] * (z % c.p[2]);
    return cyz == c.color / c.p[0] ? xm : 0u;
}

template <typename T, typename D, int VEC, int LINES>
__global__ void __launch_bounds__(BIS_BOX_THREADS,
                                  LINES == 1 ? BIS_GS_BOX_FLAT_BLOCKS
                                             : BIS_BOX_MIN_BLOCKS)
stencil_gs_color_step_box_kernel(const __grid_constant__ BisStencilArgs a,
                                 const BisColorStep c, int zr,
                                 long long row0, long long rows,
                                 long long hneg, long long wlen,
                                 const T* __restrict__ xw,
                                 const D* __restrict__ diag,
                                 const T* __restrict__ rhs,
                                 const T* __restrict__ dinv,
                                 T* __restrict__ out) {
    const long long plane = (long long)a.nx * a.ny;
    const BisBoxChunk k = box_chunk<VEC>(
        a, (long long)blockIdx.x * BIS_BOX_THREADS + threadIdx.x);
    const int lane = threadIdx.x & 31;
    const int gy = k.live ? (int)(k.e0 / a.nx) : 0;
    const int qa = (int)(row0 / plane);
    const int qb = (int)((row0 + rows + plane - 1) / plane);
    const int z0 = qa + blockIdx.y * zr, z1 = min(z0 + zr, qb);
    unsigned xm = 0;                  // grid: the rows of the x colour
    if (c.kind == 1) {
        const int cx = c.color % c.p[0];
        int xr = k.x0 % c.p[0];
#pragma unroll
        for (int r = 0; r < VEC; ++r) {
            if (xr == cx) xm |= 1u << r;
            if (++xr == c.p[0]) xr = 0;
        }
    }
    auto fetch = [&](int q, T (&P)[3][VEC + 2]) {
        box_fetch_window<T, VEC, LINES>(a, k, lane, xw, hneg - row0, wlen, q,
                                        z1, P);
    };
    auto assemble = [&](T (&P)[3][VEC + 2]) {
        box_assemble<T, VEC, LINES>(k.has_l, k.has_r, lane, P);
    };
    // rhs and dinv of a plane's chunk; load_rd returns the bits of the
    // chunk's rows of colour c there, 0 where none or not the launch's
    // (nothing read).  Three-line planes read them a step ahead of their
    // use (the first plane's beside the march's first x loads), a flat
    // plane's kernel in the step: each the faster on the H100 (PERF.md,
    // PR 15; read ahead, the flat kernel outgrows four blocks an SM)
    T rv_n[VEC], dv_n[VEC];
    auto load_rd = [&](int z) -> unsigned {
        const long long t = (long long)z * plane + k.e0 - row0;
        if (!k.live || t < 0 || t >= rows || z >= a.nz) return 0u;
        const unsigned m = gs_box_rows<VEC>(c, k.x0, gy, z, xm);
        if (m != 0) {
            load_vec<T, VEC>(rhs + t, rv_n);
            load_vec<T, VEC>(dinv + t, dv_n);
        }
        return m;
    };
    unsigned m_n = LINES == 3 ? load_rd(z0) : 0u;
    auto step = [&](int z, const T (&pm)[3][VEC + 2],
                    const T (&p0)[3][VEC + 2], const T (&pp)[3][VEC + 2]) {
        const unsigned m = LINES == 3 ? m_n : load_rd(z);
        T rv[VEC], dv[VEC];
#pragma unroll
        for (int r = 0; r < VEC; ++r) {
            rv[r] = rv_n[r];
            dv[r] = dv_n[r];
        }
        if (LINES == 3 && z + 1 < z1) m_n = load_rd(z + 1);
        const long long t = (long long)z * plane + k.e0 - row0;
        if (!k.live || t < 0 || t >= rows) return;
        T o[VEC];
        if (z >= a.nz) {              // inert rows: x through
            load_vec<T, VEC>(xw + hneg + t, o);
            store_vec<T, VEC>(out + t, o);
            return;
        }
#pragma unroll
        for (int r = 0; r < VEC; ++r) o[r] = p0[1][r + 1];
        if (m != 0) {
            T acc[VEC];
            box_rows<T, VEC>(a, pm, p0, pp, acc);
            if (diag != nullptr) {
                T d[VEC];
                load_diag<T, VEC>(diag + t, d);
#pragma unroll
                for (int r = 0; r < VEC; ++r)
                    acc[r] = add_rn(acc[r], mul_rn(d[r], p0[1][r + 1]));
            }
#pragma unroll
            for (int r = 0; r < VEC; ++r)
                if ((m >> r) & 1u)
                    o[r] = add_rn(o[r], mul_rn(sub_rn(rv[r], acc[r]), dv[r]));
        }
        store_vec<T, VEC>(out + t, o);
    };
    box_march<T, VEC, true>(z0, z1, fetch, assemble, step);
}

template <typename T, typename D>
static int launch(int device, const BisStencilArgs* a, const T* x,
                  const D* diag, const T* aux, T* y, double* partials,
                  cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const dim3 block(a->block_x, a->block_y);
    const dim3 grid(a->grid_x, a->grid_y);
    stencil_spmv_kernel<T, D><<<grid, block, 0, stream>>>(*a, x, diag, aux, y,
                                                        partials);
    return (int)cudaGetLastError();
}

// Kernel #2's launch: grid (grid_x, grid_y, grid_z) of tiles, zc planes a
// block.  Refuses a grid that does not cover the operator and legs beyond
// the staged halo.
template <typename T, typename D>
static int launch_stream(int device, const BisStencilArgs* a, int grid_x,
                         int grid_y, int grid_z, int zc, const T* x,
                         const D* diag, const T* aux, T* y, double* partials,
                         cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    if ((long long)grid_x * BIS_STREAM_TX < a->nx ||
        (long long)grid_y * BIS_STREAM_TY < a->ny ||
        (long long)grid_z * zc < a->nz || zc < 1)
        return (int)cudaErrorInvalidValue;
    for (int l = 0; l < a->group_begin[a->n_groups]; ++l)
        if (a->dx[l] < -BIS_STREAM_HX || a->dx[l] > BIS_STREAM_HX ||
            a->dy[l] < -BIS_STREAM_HY || a->dy[l] > BIS_STREAM_HY ||
            a->dz[l] < -1 || a->dz[l] > 1)
            return (int)cudaErrorInvalidValue;
    const dim3 block(BIS_STREAM_TX, BIS_STREAM_TY);
    const dim3 grid(grid_x, grid_y, grid_z);
    stencil_spmv_stream_kernel<T, D><<<grid, block, 0, stream>>>(
        *a, zc, x, diag, aux, y, partials);
    return (int)cudaGetLastError();
}

// The box routes' launch checks: every leg within the box and in its
// group's mask, a grid that covers the operator, and 16-byte alignment of
// every vector read or written VEC-wide.
static bool aligned16(const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// every leg within the box and in its group's mask
static bool box_legs_ok(const BisStencilArgs* a) {
    for (int g = 0; g < a->n_groups; ++g)
        for (int l = a->group_begin[g]; l < a->group_begin[g + 1]; ++l) {
            if (a->dx[l] < -1 || a->dx[l] > 1 || a->dy[l] < -1 ||
                a->dy[l] > 1 || a->dz[l] < -1 || a->dz[l] > 1)
                return false;
            const int p = (a->dz[l] + 1) * 9 + (a->dy[l] + 1) * 3 + a->dx[l] + 1;
            if (!((a->box_mask[g] >> p) & 1)) return false;
        }
    return true;
}

template <typename T, typename D>
static bool box_ok(const BisStencilArgs* a, int vec, int zr, int grid_x,
                   int grid_y, const T* x, const D* diag, const T* aux,
                   const T* y) {
    if (vec < 1 || a->nx % vec != 0 || zr < 1 || grid_x < 1 || grid_y < 1 ||
        grid_y > 65535)
        return false;
    if ((long long)grid_x * BIS_BOX_THREADS * vec < (long long)a->nx * a->ny ||
        (long long)grid_y * zr < a->nz)
        return false;
    if (!box_legs_ok(a)) return false;
    if (vec > 1 && !(aligned16(x) && aligned16(aux) && aligned16(y) &&
                     (sizeof(D) != sizeof(T) || aligned16(diag))))
        return false;
    return true;
}

// #1's box route: VEC = 16 / sizeof(T) (vec > 1) or 1.
template <typename T, typename D>
static int launch_box(int device, const BisStencilArgs* a, int vec, int zr,
                      int grid_x, int grid_y, const T* x, const D* diag,
                      const T* aux, T* y, double* partials, cudaStream_t stream) {
    constexpr int V = 16 / sizeof(T);
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    if ((vec != 1 && vec != V) ||
        !box_ok(a, vec, zr, grid_x, grid_y, x, diag, aux, y))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(grid_x, grid_y);
    if (vec == V)
        stencil_spmv_box_kernel<T, D, V><<<grid, BIS_BOX_THREADS, 0, stream>>>(
            *a, zr, x, diag, aux, y, partials);
    else
        stencil_spmv_box_kernel<T, D, 1><<<grid, BIS_BOX_THREADS, 0, stream>>>(
            *a, zr, x, diag, aux, y, partials);
    return (int)cudaGetLastError();
}

// #2's box route: VEC = 16 / sizeof(T) only (the slabs are bulk copies);
// `slot` elements a ring slot, at least the widest slab.
template <typename T, typename D>
static int launch_stream_box(int device, const BisStencilArgs* a, int zr,
                             int grid_x, int grid_y, int slot, const T* x,
                             const D* diag, const T* aux, T* y, double* partials,
                             cudaStream_t stream) {
    constexpr int V = 16 / sizeof(T);
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const long long plane = (long long)a->nx * a->ny;
    const long long widest =
        std::min(plane, (long long)BIS_BOX_THREADS * V + 2LL * a->nx + 2 * V);
    if (!box_ok(a, V, zr, grid_x, grid_y, x, diag, aux, y) || slot % V != 0 ||
        slot < widest)
        return (int)cudaErrorInvalidValue;
    const size_t smem = BIS_BOX_RING_OFFSET +
                        (size_t)BIS_BOX_STAGES * slot * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            stencil_spmv_stream_box_kernel<T, D, V>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    stencil_spmv_stream_box_kernel<T, D, V>
        <<<dim3(grid_x, grid_y), BIS_BOX_THREADS + 32, smem, stream>>>(
            *a, zr, slot, x, diag, aux, y, partials);
    return (int)cudaGetLastError();
}

template <typename T, typename D>
static int launch_gs(int device, const BisStencilArgs* a, int kind, int p0,
                     int p1, int p2, int color, const T* x, const D* diag,
                     const T* rhs, const T* dinv, T* out,
                     cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const BisColorStep c = {kind, {p0, p1, p2}, color};
    const dim3 block(a->block_x, a->block_y);
    const dim3 grid(a->grid_x, a->grid_y);
    stencil_gs_color_step_kernel<T, D><<<grid, block, 0, stream>>>(
        *a, c, x, diag, rhs, dinv, out);
    return (int)cudaGetLastError();
}

// #3's box route (single-device and shard form): VEC = 16 / sizeof(T); a
// grid of grid_x tiles of BIS_BOX_THREADS chunks over a box_form plane
// and grid_y runs of zr planes over those holding rows [row0, row0 +
// rows).  Refuses the mod kind, legs outside the box or their mask, a
// line not of whole vectors, rows, row0, hneg or hpos not of whole lines
// or vectors, a grid that does not cover the rows, unaligned operands.
template <typename T, typename D>
static int launch_gs_box(int device, const BisStencilArgs* a, int kind,
                         int p0, int p1, int p2, int color, int zr,
                         int grid_x, int grid_y, long long row0,
                         long long rows, long long hneg, long long wlen,
                         const T* xw, const D* diag, const T* rhs,
                         const T* dinv, T* out, cudaStream_t stream) {
    constexpr int V = 16 / sizeof(T);
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const long long plane = (long long)a->nx * a->ny;
    const long long hpos = wlen - hneg - rows;
    if ((kind != 0 && kind != 1) || p0 < 1 || p1 < 1 || p2 < 1 ||
        a->nx % V != 0 || rows < a->nx || row0 < 0 || row0 % a->nx ||
        rows % a->nx || hneg < 0 || hpos < 0 || hneg % V || hpos % V ||
        zr < 1 || grid_x < 1 || grid_y < 1 || grid_y > 65535)
        return (int)cudaErrorInvalidValue;
    const long long qa = row0 / plane, qb = (row0 + rows + plane - 1) / plane;
    if ((long long)grid_x * BIS_BOX_THREADS * V < plane ||
        (long long)grid_y * zr < qb - qa || qb > 2147483647LL ||
        !box_legs_ok(a))
        return (int)cudaErrorInvalidValue;
    if (!(aligned16(xw) && aligned16(rhs) && aligned16(dinv) &&
          aligned16(out) && (sizeof(D) != sizeof(T) || aligned16(diag))))
        return (int)cudaErrorInvalidValue;
    const BisColorStep c = {kind, {p0, p1, p2}, color};
    if (a->ny == 1)
        stencil_gs_color_step_box_kernel<T, D, V, 1>
            <<<dim3(grid_x, grid_y), BIS_BOX_THREADS, 0, stream>>>(
                *a, c, zr, row0, rows, hneg, wlen, xw, diag, rhs, dinv, out);
    else
        stencil_gs_color_step_box_kernel<T, D, V, 3>
            <<<dim3(grid_x, grid_y), BIS_BOX_THREADS, 0, stream>>>(
                *a, c, zr, row0, rows, hneg, wlen, xw, diag, rhs, dinv, out);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Shard-local forms of #1 and #3 for a row-sharded mesh.
//
// Replace the halo/row0 forms of the Pallas kernels
// basic_iterative_solvers_tpu/stencil_op.py: stencil_spmv_resident and
// stencil_gs_color_step (the halo substitution of _resident_kernel),
// reached through parallel/mesh_ops.mesh_stencil_spmv and
// mesh_gs_color_step.  A shard owns the global rows [row0, row0 + rows),
// rows = lines * nx (whole x-lines, so every pure-x leg stays inside the
// shard), and reads x only from its window xw: hneg rows of its left
// neighbour, its own rows, hpos rows of its right neighbour (zeros at the
// global edges).  Global row i sits at xw[hneg + i - row0].  The masks and
// colours come from the global coordinates of i, so a leg that leaves the
// grid is masked exactly as in the single-device kernel, and an in-bounds
// leg lands on a row in [0, n) inside the window (|offset| <= hneg, hpos).
// Rows at or past n are inert padding (the mesh pads the row count to
// whole shards): y = 0 there and the GS step copies x through.  The row
// sum is the single-device kernel's (stencil_row, same groups, same
// order, each sum and product rounded alone), so y is bit-equal to #1's
// and x' to #3's; only the dot partials group differently.
//
// Grid: (line blocks of block_y lines, x blocks of block_x), one thread a
// row, so a shard of few long lines (fdm:2048 on 8 shards: 256 lines of
// 2048) still fills the card.  Bound: as #1 and #3, the leg loop.  Each
// has a box route beside these leg loops, for legs within the box:
// stencil_spmv_halo_box_kernel below (#1's) and
// stencil_gs_color_step_box_kernel above (#3's).
// ---------------------------------------------------------------------------

template <typename T, typename D>
__global__ void __launch_bounds__(256)
stencil_spmv_halo_kernel(const __grid_constant__ BisStencilArgs a,
                         long long row0, long long lines, long long n,
                         long long hneg, const T* __restrict__ xw,
                         const D* __restrict__ diag,
                         const T* __restrict__ aux, T* __restrict__ y,
                         double* __restrict__ partials) {
    const long long line = (long long)blockIdx.x * a.block_y + threadIdx.y;
    const int gx = blockIdx.y * a.block_x + threadIdx.x;
    double dsum[BIS_MAX_DOTS] = {0.0, 0.0, 0.0};
    if (line < lines && gx < a.nx) {
        const long long t = line * a.nx + gx;
        const long long i = row0 + t;
        T acc = T(0);
        if (i < n) {
            const long long gl = row0 / a.nx + line;
            const int gy = (int)(gl % a.ny), gz = (int)(gl / a.ny);
            acc = stencil_row(a, xw, diag, hneg + t, t, gx, gy, gz);
            for (int k = 0; k < a.n_dots; ++k) {
                const int kind = a.dot_kind[k];
                const T v = kind == 0 ? xw[hneg + t]
                                      : (kind == 1 ? acc : aux[t]);
                dsum[k] += (double)(acc * v);
            }
        }
        y[t] = acc;
    }
    if (a.n_dots > 0)
        block_sums(dsum, a.n_dots,
                   partials + (long long)(blockIdx.x + (long long)gridDim.x *
                                          blockIdx.y) * a.n_dots);
}

// #1's shard form on the box route (stencil_spmv_halo_box_kernel).
//
// The leg loop above is the shard form's first port: one scalar row a
// thread, the legs in a runtime loop, six bounds tests and one load a leg.
// On an H100 its 8 launches of a 128^3 mesh of 8 shards took ~0.13 ms
// against a ~0.005 ms byte bound, where #1's box route over the whole grid
// took ~0.016 ms (PERF.md).  This kernel is #1's box route on a window, as
// #3's box kernel is #3's:
//   - a thread owns VEC = 16 / sizeof(T) rows of a line and marches a run
//     of zr planes (box_form's: a 2-D operator marches along y) with four
//     windows of three lines in registers, the next plane's loads in
//     flight while it computes (box_march); the legs unrolled over the
//     box (box_rows); each sum and product rounded alone, so y equals the
//     leg loop's and #1's on the same rows bit for bit;
//   - the launch owns the global rows [row0, row0 + rows) (whole lines)
//     and reads x from xw (wlen values, global row i at
//     xw[hneg + i - row0]) through box_fetch_window; diag, aux and y are
//     its own rows.  The grid's runs cover the planes that hold its rows
//     (a shard of part of a plane: chunks outside its lines do nothing);
//     rows at or past n (a mesh's inert padding) are 0 and add no dot
//     term;
//   - the window's halo must be whole vectors (the mesh and GSPMD modes
//     round it up to whole x-lines, stencil_op.window_halo): a line an
//     owned row's legs read then lies inside the window, every 16-byte
//     load of it aligned;
//   - dot partials one a block, as #1's box kernel writes them.
// What bounds it: bytes, as #1's box route (x read once from the window
// with its reuse across z in registers, y written, diag and aux read);
// on a 128^3 shard of 16 planes a launch is a single wave of blocks, so
// the launch's latency counts beside the bytes.
template <typename T, typename D, int VEC>
__global__ void __launch_bounds__(BIS_BOX_THREADS, BIS_BOX_MIN_BLOCKS)
stencil_spmv_halo_box_kernel(const __grid_constant__ BisStencilArgs a, int zr,
                             long long row0, long long rows, long long hneg,
                             long long wlen, const T* __restrict__ xw,
                             const D* __restrict__ diag,
                             const T* __restrict__ aux, T* __restrict__ y,
                             double* __restrict__ partials) {
    const long long plane = (long long)a.nx * a.ny;
    const BisBoxChunk k = box_chunk<VEC>(
        a, (long long)blockIdx.x * BIS_BOX_THREADS + threadIdx.x);
    const int lane = threadIdx.x & 31;
    const int qa = (int)(row0 / plane);
    const int qb = (int)((row0 + rows + plane - 1) / plane);
    const int z0 = qa + blockIdx.y * zr, z1 = min(z0 + zr, qb);
    double dsum[BIS_MAX_DOTS] = {0.0, 0.0, 0.0};
    auto fetch = [&](int q, T (&P)[3][VEC + 2]) {
        box_fetch_window<T, VEC, 3>(a, k, lane, xw, hneg - row0, wlen, q, z1,
                                    P);
    };
    auto assemble = [&](T (&P)[3][VEC + 2]) {
        box_assemble<T, VEC>(k.has_l, k.has_r, lane, P);
    };
    auto out = [&](int z, const T (&pm)[3][VEC + 2],
                   const T (&p0)[3][VEC + 2], const T (&pp)[3][VEC + 2]) {
        const long long t = (long long)z * plane + k.e0 - row0;
        if (!k.live || t < 0 || t >= rows) return;
        T acc[VEC];
        if (z >= a.nz) {              // inert rows: y = 0
#pragma unroll
            for (int r = 0; r < VEC; ++r) acc[r] = T(0);
            store_vec<T, VEC>(y + t, acc);
            return;
        }
        box_rows<T, VEC>(a, pm, p0, pp, acc);
        box_store<T, D, VEC>(a, k, t, acc, p0[1], diag, aux, y, dsum);
    };
    box_march<T, VEC, true>(z0, z1, fetch, assemble, out);
    if (a.n_dots > 0)
        block_sums(dsum, a.n_dots,
                   partials + (long long)(blockIdx.x + (long long)gridDim.x *
                                          blockIdx.y) * a.n_dots);
}

template <typename T, typename D>
__global__ void __launch_bounds__(256)
stencil_gs_color_step_halo_kernel(const __grid_constant__ BisStencilArgs a,
                                  const BisColorStep c, long long row0,
                                  long long lines, long long n,
                                  long long hneg, const T* __restrict__ xw,
                                  const D* __restrict__ diag,
                                  const T* __restrict__ rhs,
                                  const T* __restrict__ dinv,
                                  T* __restrict__ out) {
    const long long line = (long long)blockIdx.x * a.block_y + threadIdx.y;
    const int gx = blockIdx.y * a.block_x + threadIdx.x;
    if (line >= lines || gx >= a.nx) return;
    const long long t = line * a.nx + gx;
    const long long i = row0 + t;
    T xi = xw[hneg + t];
    if (i < n) {
        const long long gl = row0 / a.nx + line;
        const int gy = (int)(gl % a.ny), gz = (int)(gl / a.ny);
        if (color_of(c, i, gx, gy, gz) == c.color) {
            const T ax = stencil_row(a, xw, diag, hneg + t, t, gx, gy, gz);
            xi = add_rn(xi, mul_rn(sub_rn(rhs[t], ax), dinv[t]));
        }
    }
    out[t] = xi;
}

// The shard forms' launch: refuses a shard that does not start on a line.
static bool halo_grid(const BisStencilArgs* a, long long row0,
                      long long lines, dim3* grid) {
    if (row0 % a->nx != 0 || lines < 0) return false;
    const long long gl = (lines + a->block_y - 1) / a->block_y;
    const long long gx = (a->nx + a->block_x - 1) / a->block_x;
    if (gl > 2147483647LL || gx > 65535) return false;
    *grid = dim3((unsigned)(gl > 0 ? gl : 1), (unsigned)gx);
    return true;
}

template <typename T, typename D>
static int launch_halo(int device, const BisStencilArgs* a, long long row0,
                       long long lines, long long n, long long hneg,
                       const T* xw, const D* diag, const T* aux, T* y,
                       double* partials, cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    dim3 grid;
    if (!halo_grid(a, row0, lines, &grid)) return (int)cudaErrorInvalidValue;
    const dim3 block(a->block_x, a->block_y);
    stencil_spmv_halo_kernel<T, D><<<grid, block, 0, stream>>>(
        *a, row0, lines, n, hneg, xw, diag, aux, y, partials);
    return (int)cudaGetLastError();
}

// #1's shard form on the box route: VEC = 16 / sizeof(T); a grid of
// grid_x tiles of BIS_BOX_THREADS chunks over a box_form plane and grid_y
// runs of zr planes over those holding rows [row0, row0 + rows).  Refuses
// legs outside the box or their mask, a line not of whole vectors, rows or
// row0 not of whole lines, hneg or hpos (= wlen - hneg - rows) not of whole
// vectors, a grid that does not cover the rows, unaligned operands.
template <typename T, typename D>
static int launch_halo_box(int device, const BisStencilArgs* a, int zr,
                           int grid_x, int grid_y, long long row0,
                           long long rows, long long hneg, long long wlen,
                           const T* xw, const D* diag, const T* aux, T* y,
                           double* partials, cudaStream_t stream) {
    constexpr int V = 16 / sizeof(T);
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const long long plane = (long long)a->nx * a->ny;
    const long long hpos = wlen - hneg - rows;
    if (a->nx % V != 0 || rows < a->nx || row0 < 0 || row0 % a->nx ||
        rows % a->nx || hneg < 0 || hpos < 0 || hneg % V || hpos % V ||
        zr < 1 || grid_x < 1 || grid_y < 1 || grid_y > 65535)
        return (int)cudaErrorInvalidValue;
    const long long qa = row0 / plane, qb = (row0 + rows + plane - 1) / plane;
    if ((long long)grid_x * BIS_BOX_THREADS * V < plane ||
        (long long)grid_y * zr < qb - qa || qb > 2147483647LL ||
        !box_legs_ok(a))
        return (int)cudaErrorInvalidValue;
    if (!(aligned16(xw) && aligned16(aux) && aligned16(y) &&
          (sizeof(D) != sizeof(T) || aligned16(diag))))
        return (int)cudaErrorInvalidValue;
    stencil_spmv_halo_box_kernel<T, D, V>
        <<<dim3(grid_x, grid_y), BIS_BOX_THREADS, 0, stream>>>(
            *a, zr, row0, rows, hneg, wlen, xw, diag, aux, y, partials);
    return (int)cudaGetLastError();
}

template <typename T, typename D>
static int launch_gs_halo(int device, const BisStencilArgs* a, int kind,
                          int p0, int p1, int p2, int color, long long row0,
                          long long lines, long long n, long long hneg,
                          const T* xw, const D* diag, const T* rhs,
                          const T* dinv, T* out, cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    dim3 grid;
    if (!halo_grid(a, row0, lines, &grid)) return (int)cudaErrorInvalidValue;
    const BisColorStep c = {kind, {p0, p1, p2}, color};
    const dim3 block(a->block_x, a->block_y);
    stencil_gs_color_step_halo_kernel<T, D><<<grid, block, 0, stream>>>(
        *a, c, row0, lines, n, hneg, xw, diag, rhs, dinv, out);
    return (int)cudaGetLastError();
}

extern "C" {

// Entry points bis_<kernel>_<vector type>[_bf16]; the suffix _bf16 takes a
// bf16 diagonal.
#define BIS_SPMV_ENTRY(NAME, T, D)                                           \
    int NAME(int device, const BisStencilArgs* a, const T* x, const D* diag,\
             const T* aux, T* y, double* partials, void* stream) {               \
        return launch<T, D>(device, a, x, diag, aux, y, partials,           \
                            (cudaStream_t)stream);                          \
    }
BIS_SPMV_ENTRY(bis_stencil_spmv_f32, float, float)
BIS_SPMV_ENTRY(bis_stencil_spmv_f64, double, double)
BIS_SPMV_ENTRY(bis_stencil_spmv_f32_bf16, float, __nv_bfloat16)
BIS_SPMV_ENTRY(bis_stencil_spmv_f64_bf16, double, __nv_bfloat16)

#define BIS_STREAM_ENTRY(NAME, T, D)                                         \
    int NAME(int device, const BisStencilArgs* a, int grid_x, int grid_y,   \
             int grid_z, int zc, const T* x, const D* diag, const T* aux,   \
             T* y, double* partials, void* stream) {                             \
        return launch_stream<T, D>(device, a, grid_x, grid_y, grid_z, zc, x,\
                                   diag, aux, y, partials,                  \
                                   (cudaStream_t)stream);                   \
    }
BIS_STREAM_ENTRY(bis_stencil_spmv_stream_f32, float, float)
BIS_STREAM_ENTRY(bis_stencil_spmv_stream_f64, double, double)
BIS_STREAM_ENTRY(bis_stencil_spmv_stream_f32_bf16, float, __nv_bfloat16)
BIS_STREAM_ENTRY(bis_stencil_spmv_stream_f64_bf16, double, __nv_bfloat16)

// The box routes: bis_stencil_spmv_box_<type>[_bf16] (#1) and
// bis_stencil_spmv_stream_box_<type>[_bf16] (#2).
#define BIS_BOX_ENTRY(NAME, T, D)                                            \
    int NAME(int device, const BisStencilArgs* a, int vec, int zr,          \
             int grid_x, int grid_y, const T* x, const D* diag,             \
             const T* aux, T* y, double* partials, void* stream) {               \
        return launch_box<T, D>(device, a, vec, zr, grid_x, grid_y, x, diag,\
                                aux, y, partials, (cudaStream_t)stream);    \
    }
BIS_BOX_ENTRY(bis_stencil_spmv_box_f32, float, float)
BIS_BOX_ENTRY(bis_stencil_spmv_box_f64, double, double)
BIS_BOX_ENTRY(bis_stencil_spmv_box_f32_bf16, float, __nv_bfloat16)
BIS_BOX_ENTRY(bis_stencil_spmv_box_f64_bf16, double, __nv_bfloat16)

#define BIS_STREAM_BOX_ENTRY(NAME, T, D)                                     \
    int NAME(int device, const BisStencilArgs* a, int zr, int grid_x,       \
             int grid_y, int slot, const T* x, const D* diag, const T* aux, \
             T* y, double* partials, void* stream) {                             \
        return launch_stream_box<T, D>(device, a, zr, grid_x, grid_y, slot, \
                                       x, diag, aux, y, partials,           \
                                       (cudaStream_t)stream);               \
    }
BIS_STREAM_BOX_ENTRY(bis_stencil_spmv_stream_box_f32, float, float)
BIS_STREAM_BOX_ENTRY(bis_stencil_spmv_stream_box_f64, double, double)
BIS_STREAM_BOX_ENTRY(bis_stencil_spmv_stream_box_f32_bf16, float,
                     __nv_bfloat16)
BIS_STREAM_BOX_ENTRY(bis_stencil_spmv_stream_box_f64_bf16, double,
                     __nv_bfloat16)

int bis_stencil_box_shape(int* threads, int* stages, int* resident,
                          int* stream_resident) {
    *threads = BIS_BOX_THREADS;
    *stages = BIS_BOX_STAGES;
    *resident = BIS_BOX_MIN_BLOCKS;
    *stream_resident = BIS_BOX_STREAM_MIN_BLOCKS;
    return 0;
}

int bis_stencil_gs_box_flat_blocks(void) { return BIS_GS_BOX_FLAT_BLOCKS; }

int bis_stencil_stream_tile(int* tx, int* ty, int* hx, int* hy) {
    *tx = BIS_STREAM_TX;
    *ty = BIS_STREAM_TY;
    *hx = BIS_STREAM_HX;
    *hy = BIS_STREAM_HY;
    return 0;
}

#define BIS_GS_ENTRY(NAME, T, D)                                             \
    int NAME(int device, const BisStencilArgs* a, int kind, int p0, int p1, \
             int p2, int color, const T* x, const D* diag, const T* rhs,    \
             const T* dinv, T* out, void* stream) {                         \
        return launch_gs<T, D>(device, a, kind, p0, p1, p2, color, x, diag, \
                               rhs, dinv, out, (cudaStream_t)stream);       \
    }
BIS_GS_ENTRY(bis_stencil_gs_color_step_f32, float, float)
BIS_GS_ENTRY(bis_stencil_gs_color_step_f64, double, double)
BIS_GS_ENTRY(bis_stencil_gs_color_step_f32_bf16, float, __nv_bfloat16)
BIS_GS_ENTRY(bis_stencil_gs_color_step_f64_bf16, double, __nv_bfloat16)

// #3's box route: bis_stencil_gs_color_step_box_<type>[_bf16] on one
// device, bis_stencil_gs_color_step_halo_box_<type>[_bf16] on a shard.
#define BIS_GS_BOX_ENTRY(NAME, T, D)                                         \
    int NAME(int device, const BisStencilArgs* a, int kind, int p0, int p1, \
             int p2, int color, int zr, int grid_x, int grid_y, const T* x, \
             const D* diag, const T* rhs, const T* dinv, T* out,            \
             void* stream) {                                                \
        const long long n = (long long)a->nx * a->ny * a->nz;               \
        return launch_gs_box<T, D>(device, a, kind, p0, p1, p2, color, zr,  \
                                   grid_x, grid_y, 0, n, 0, n, x, diag,     \
                                   rhs, dinv, out, (cudaStream_t)stream);   \
    }
BIS_GS_BOX_ENTRY(bis_stencil_gs_color_step_box_f32, float, float)
BIS_GS_BOX_ENTRY(bis_stencil_gs_color_step_box_f64, double, double)
BIS_GS_BOX_ENTRY(bis_stencil_gs_color_step_box_f32_bf16, float, __nv_bfloat16)
BIS_GS_BOX_ENTRY(bis_stencil_gs_color_step_box_f64_bf16, double,
                 __nv_bfloat16)

#define BIS_GS_HALO_BOX_ENTRY(NAME, T, D)                                    \
    int NAME(int device, const BisStencilArgs* a, int kind, int p0, int p1, \
             int p2, int color, int zr, int grid_x, int grid_y,             \
             long long row0, long long rows, long long hneg, long long wlen,\
             const T* xw, const D* diag, const T* rhs, const T* dinv,       \
             T* out, void* stream) {                                        \
        return launch_gs_box<T, D>(device, a, kind, p0, p1, p2, color, zr,  \
                                   grid_x, grid_y, row0, rows, hneg, wlen,  \
                                   xw, diag, rhs, dinv, out,                \
                                   (cudaStream_t)stream);                   \
    }
BIS_GS_HALO_BOX_ENTRY(bis_stencil_gs_color_step_halo_box_f32, float, float)
BIS_GS_HALO_BOX_ENTRY(bis_stencil_gs_color_step_halo_box_f64, double, double)
BIS_GS_HALO_BOX_ENTRY(bis_stencil_gs_color_step_halo_box_f32_bf16, float,
                      __nv_bfloat16)
BIS_GS_HALO_BOX_ENTRY(bis_stencil_gs_color_step_halo_box_f64_bf16, double,
                      __nv_bfloat16)

// The shard-local forms: bis_<kernel>_halo_<vector type>[_bf16].
#define BIS_SPMV_HALO_ENTRY(NAME, T, D)                                      \
    int NAME(int device, const BisStencilArgs* a, long long row0,           \
             long long lines, long long n, long long hneg, const T* xw,     \
             const D* diag, const T* aux, T* y, double* partials, void* stream) {\
        return launch_halo<T, D>(device, a, row0, lines, n, hneg, xw, diag, \
                                 aux, y, partials, (cudaStream_t)stream);   \
    }
BIS_SPMV_HALO_ENTRY(bis_stencil_spmv_halo_f32, float, float)
BIS_SPMV_HALO_ENTRY(bis_stencil_spmv_halo_f64, double, double)
BIS_SPMV_HALO_ENTRY(bis_stencil_spmv_halo_f32_bf16, float, __nv_bfloat16)
BIS_SPMV_HALO_ENTRY(bis_stencil_spmv_halo_f64_bf16, double, __nv_bfloat16)

// #1's shard form on the box route: bis_stencil_spmv_halo_box_<type>[_bf16]
#define BIS_SPMV_HALO_BOX_ENTRY(NAME, T, D)                                  \
    int NAME(int device, const BisStencilArgs* a, int zr, int grid_x,       \
             int grid_y, long long row0, long long rows, long long hneg,    \
             long long wlen, const T* xw, const D* diag, const T* aux,      \
             T* y, double* partials, void* stream) {                             \
        return launch_halo_box<T, D>(device, a, zr, grid_x, grid_y, row0,   \
                                     rows, hneg, wlen, xw, diag, aux, y,    \
                                     partials, (cudaStream_t)stream);       \
    }
BIS_SPMV_HALO_BOX_ENTRY(bis_stencil_spmv_halo_box_f32, float, float)
BIS_SPMV_HALO_BOX_ENTRY(bis_stencil_spmv_halo_box_f64, double, double)
BIS_SPMV_HALO_BOX_ENTRY(bis_stencil_spmv_halo_box_f32_bf16, float,
                        __nv_bfloat16)
BIS_SPMV_HALO_BOX_ENTRY(bis_stencil_spmv_halo_box_f64_bf16, double,
                        __nv_bfloat16)

#define BIS_GS_HALO_ENTRY(NAME, T, D)                                        \
    int NAME(int device, const BisStencilArgs* a, int kind, int p0, int p1, \
             int p2, int color, long long row0, long long lines,            \
             long long n, long long hneg, const T* xw, const D* diag,       \
             const T* rhs, const T* dinv, T* out, void* stream) {           \
        return launch_gs_halo<T, D>(device, a, kind, p0, p1, p2, color,     \
                                    row0, lines, n, hneg, xw, diag, rhs,    \
                                    dinv, out, (cudaStream_t)stream);       \
    }
BIS_GS_HALO_ENTRY(bis_stencil_gs_color_step_halo_f32, float, float)
BIS_GS_HALO_ENTRY(bis_stencil_gs_color_step_halo_f64, double, double)
BIS_GS_HALO_ENTRY(bis_stencil_gs_color_step_halo_f32_bf16, float, __nv_bfloat16)
BIS_GS_HALO_ENTRY(bis_stencil_gs_color_step_halo_f64_bf16, double, __nv_bfloat16)

int bis_stencil_args_size(void) { return (int)sizeof(BisStencilArgs); }

}  // extern "C"
