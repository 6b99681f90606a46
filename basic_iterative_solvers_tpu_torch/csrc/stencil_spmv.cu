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

#include <cuda_bf16.h>
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
                    T* __restrict__ y, T* __restrict__ partials) {
    const int gy = blockIdx.x * a.block_y + threadIdx.y;
    const int gz = blockIdx.y;
    T dsum[BIS_MAX_DOTS] = {T(0), T(0), T(0)};
    if (gy < a.ny) {
        const long long row = (long long)a.nx * (gy + (long long)a.ny * gz);
        for (int gx = threadIdx.x; gx < a.nx; gx += a.block_x) {
            const long long i = row + gx;
            const T acc = stencil_row(a, x, diag, i, i, gx, gy, gz);
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
// (zc + 2)/zc along z.  A runtime leg loop stays; cp.async/TMA plane
// loads, a persistent grid and a fused CG update are later work.
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
                           T* __restrict__ partials) {
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
    T dsum[BIS_MAX_DOTS] = {T(0), T(0), T(0)};
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
                dsum[k] += acc * v;
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

template <typename T, typename D>
static int launch(int device, const BisStencilArgs* a, const T* x,
                  const D* diag, const T* aux, T* y, T* partials,
                  cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
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
                         const D* diag, const T* aux, T* y, T* partials,
                         cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
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

template <typename T, typename D>
static int launch_gs(int device, const BisStencilArgs* a, int kind, int p0,
                     int p1, int p2, int color, const T* x, const D* diag,
                     const T* rhs, const T* dinv, T* out,
                     cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    const BisColorStep c = {kind, {p0, p1, p2}, color};
    const dim3 block(a->block_x, a->block_y);
    const dim3 grid(a->grid_x, a->grid_y);
    stencil_gs_color_step_kernel<T, D><<<grid, block, 0, stream>>>(
        *a, c, x, diag, rhs, dinv, out);
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
// 2048) still fills the card.  Bound: as #1 and #3, the leg loop.
// ---------------------------------------------------------------------------

template <typename T, typename D>
__global__ void __launch_bounds__(256)
stencil_spmv_halo_kernel(const __grid_constant__ BisStencilArgs a,
                         long long row0, long long lines, long long n,
                         long long hneg, const T* __restrict__ xw,
                         const D* __restrict__ diag,
                         const T* __restrict__ aux, T* __restrict__ y,
                         T* __restrict__ partials) {
    const long long line = (long long)blockIdx.x * a.block_y + threadIdx.y;
    const int gx = blockIdx.y * a.block_x + threadIdx.x;
    T dsum[BIS_MAX_DOTS] = {T(0), T(0), T(0)};
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
                dsum[k] += acc * v;
            }
        }
        y[t] = acc;
    }
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
                       T* partials, cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    dim3 grid;
    if (!halo_grid(a, row0, lines, &grid)) return (int)cudaErrorInvalidValue;
    const dim3 block(a->block_x, a->block_y);
    stencil_spmv_halo_kernel<T, D><<<grid, block, 0, stream>>>(
        *a, row0, lines, n, hneg, xw, diag, aux, y, partials);
    return (int)cudaGetLastError();
}

template <typename T, typename D>
static int launch_gs_halo(int device, const BisStencilArgs* a, int kind,
                          int p0, int p1, int p2, int color, long long row0,
                          long long lines, long long n, long long hneg,
                          const T* xw, const D* diag, const T* rhs,
                          const T* dinv, T* out, cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
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
             const T* aux, T* y, T* partials, void* stream) {               \
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
             T* y, T* partials, void* stream) {                             \
        return launch_stream<T, D>(device, a, grid_x, grid_y, grid_z, zc, x,\
                                   diag, aux, y, partials,                  \
                                   (cudaStream_t)stream);                   \
    }
BIS_STREAM_ENTRY(bis_stencil_spmv_stream_f32, float, float)
BIS_STREAM_ENTRY(bis_stencil_spmv_stream_f64, double, double)
BIS_STREAM_ENTRY(bis_stencil_spmv_stream_f32_bf16, float, __nv_bfloat16)
BIS_STREAM_ENTRY(bis_stencil_spmv_stream_f64_bf16, double, __nv_bfloat16)

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

// The shard-local forms: bis_<kernel>_halo_<vector type>[_bf16].
#define BIS_SPMV_HALO_ENTRY(NAME, T, D)                                      \
    int NAME(int device, const BisStencilArgs* a, long long row0,           \
             long long lines, long long n, long long hneg, const T* xw,     \
             const D* diag, const T* aux, T* y, T* partials, void* stream) {\
        return launch_halo<T, D>(device, a, row0, lines, n, hneg, xw, diag, \
                                 aux, y, partials, (cudaStream_t)stream);   \
    }
BIS_SPMV_HALO_ENTRY(bis_stencil_spmv_halo_f32, float, float)
BIS_SPMV_HALO_ENTRY(bis_stencil_spmv_halo_f64, double, double)
BIS_SPMV_HALO_ENTRY(bis_stencil_spmv_halo_f32_bf16, float, __nv_bfloat16)
BIS_SPMV_HALO_ENTRY(bis_stencil_spmv_halo_f64_bf16, double, __nv_bfloat16)

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
