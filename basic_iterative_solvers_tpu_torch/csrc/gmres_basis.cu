// The two basis passes of fused-mode GMRES for Hopper (sm_90a).
//
// Replaces the Pallas kernels of basic_iterative_solvers_tpu/ops/
// gmres_basis.py:
//
//   project_gram   (gmres_basis.project_gram, gmres_basis.py:135)
//       Pw[i] = <V_i, w>,  Pv[i] = <V_i, vc>   for rows i = 0..j
//   correct_write  (gmres_basis.correct_write, gmres_basis.py:203)
//       acc = w - sum_{i<=j} ht[i] * V_i      (float32, rows in order)
//       V[j+1] = round(acc) in the basis dtype (in place),
//       vnext = float32(V[j+1]),  |vnext|^2
//
// V is (rows, n), row-major, float or __nv_bfloat16; w, vc, vnext and ht
// are float.  j comes by value: the solver knows each iteration's index
// within its restart cycle, so nothing is read back from the device.
//
// What bounds them on the card: HBM bytes.  Each pass streams rows 0..j of
// V once, plus one or two float vectors.  For the 128^3 HPCG shape
// (n = 2,097,152, GMRES(50), bf16 basis) a row is 4.2 MB, so at j = 49 a
// pass moves 50 rows (210 MB) plus w and vc (16.8 MB) for project_gram, or
// plus w, vnext and the written row (21 MB) for correct_write: ~68 us and
// ~69 us at the 3.35 TB/s peak (twice the row bytes with a float basis).
// The flops (2 or 4 per element, 2 per byte) are far below the rate at
// which the tensor cores would bind, so only the bytes matter.
//
// Two routes, chosen by shape on the host (ops/gmres_basis.route_for):
//
// * ring (every row and vector 16-byte aligned: n % 8 == 0 for bf16,
//   n % 4 == 0 for float, aligned base pointers): a persistent grid sized
//   to the card's resident blocks (one wave), each block owning one
//   contiguous range of the row's 16-byte vectors, starting on a 128-byte
//   boundary (unaligned ranges measured ~10% slower), and walking it in
//   stages of BIS_RING_STAGE_VECS vectors.  Row stages reach shared memory
//   through a BIS_RING_STAGES-deep ring of 1-D bulk copies (cp.async.bulk
//   ... mbarrier::complete_tx), issued by one lane of a producer warp while
//   eight consumer warps read the stage that has landed as 16-byte
//   vectors; a full and an empty mbarrier per stage, no block barrier per
//   row.  That keeps 48 KB of a block in flight whatever the registers
//   allow -- the Hopper form of the TPU kernel's cross-step DMA prefetch.
//   project_gram keeps the thread's slice of w and vc in registers; each
//   warp reduces a row's two products by shuffles into its own shared
//   slot, and the block reduces across warps once per group of
//   BIS_RING_GROUP rows.  correct_write keeps acc in registers, writes
//   V[j+1] and vnext with 16-byte stores, and reduces |vnext|^2.  The
//   cross-block sums are done in the kernel, in two levels so that no one
//   block reads every partial (finish_sums): the last block of each group
//   of blocks, then the last group, found by ticket counters that those
//   blocks reset for the next launch.  The sums go in block order, so the
//   result is deterministic, and no second launch is needed.
// * strided (any other shape): a grid over chunks of BIS_GB_THREADS *
//   BIS_GB_ELEMS entries, each thread reading BIS_GB_ELEMS scalars strided
//   by the block width; the partials go to a buffer the caller sums.
//
// Both routes round each product and difference of correct_write on its
// own (__fmul_rn, __fsub_rn, no FMA contraction), in row order, as the
// plain PyTorch version does, so all three write the same bits.
//
// Not here: one launch for both passes.  correct_write's weights
// ht = h * s depend on all of project_gram's Pw through G @ h1, and the
// SpMV sits between a correct_write and the next project_gram, so that
// needs a grid-wide sync and the small G update inside the kernel.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bis_device.cuh"
#include <stdint.h>

#define BIS_GB_THREADS 256
#define BIS_GB_ELEMS 8
#define BIS_GB_WARPS (BIS_GB_THREADS / 32)

// the ring route: eight consumer warps and one producer warp; a consumer
// thread takes BIS_RING_VECS 16-byte vectors of each staged row chunk
#define BIS_RING_WARPS 8
#define BIS_RING_THREADS ((BIS_RING_WARPS + 1) * 32)
#define BIS_RING_VECS 2
#define BIS_RING_STAGE_VECS (BIS_RING_WARPS * 32 * BIS_RING_VECS)
#define BIS_RING_STAGE_BYTES (BIS_RING_STAGE_VECS * 16)
#define BIS_RING_STAGES 6
#define BIS_RING_SMEM (BIS_RING_STAGES * BIS_RING_STAGE_BYTES)
#define BIS_RING_GROUP 64
#define BIS_RING_MIN_BLOCKS 2
// the blocks' sums go in groups of BIS_RING_GROUP_BLOCKS, then across the
// groups, each a 16-byte vector a lane: at most 32 groups
#define BIS_RING_GROUP_BLOCKS 16
#define BIS_RING_MAX_GRID 512

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// ---------------------------------------------------------------------------
// The strided route
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BIS_GB_THREADS)
project_gram_kernel_strided(const T* __restrict__ V,
                            const float* __restrict__ w,
                            const float* __restrict__ vc, long long n,
                            int rows, int j, float* __restrict__ partials) {
    // two buffers by row parity: one __syncthreads per row
    __shared__ float part[2][BIS_GB_WARPS][2];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long base =
        (long long)blockIdx.x * (BIS_GB_THREADS * BIS_GB_ELEMS) + threadIdx.x;
    float wr[BIS_GB_ELEMS], vr[BIS_GB_ELEMS];
#pragma unroll
    for (int e = 0; e < BIS_GB_ELEMS; ++e) {
        const long long k = base + (long long)e * BIS_GB_THREADS;
        wr[e] = k < n ? w[k] : 0.0f;
        vr[e] = k < n ? vc[k] : 0.0f;
    }
    float* out = partials + (long long)blockIdx.x * rows * 2;
    for (int i = 0; i <= j; ++i) {
        const T* row = V + (long long)i * n;
        float pw = 0.0f, pv = 0.0f;
#pragma unroll
        for (int e = 0; e < BIS_GB_ELEMS; ++e) {
            const long long k = base + (long long)e * BIS_GB_THREADS;
            if (k < n) {
                const float v = to_f32(row[k]);
                pw += v * wr[e];
                pv += v * vr[e];
            }
        }
        pw = warp_sum(pw);
        pv = warp_sum(pv);
        if (lane == 0) {
            part[i & 1][warp][0] = pw;
            part[i & 1][warp][1] = pv;
        }
        __syncthreads();
        if (warp == 0) {
            float a = lane < BIS_GB_WARPS ? part[i & 1][lane][0] : 0.0f;
            float b = lane < BIS_GB_WARPS ? part[i & 1][lane][1] : 0.0f;
            a = warp_sum(a);
            b = warp_sum(b);
            if (lane == 0) {
                out[2 * i] = a;
                out[2 * i + 1] = b;
            }
        }
    }
    for (int r = j + 1 + threadIdx.x; r < rows; r += BIS_GB_THREADS) {
        out[2 * r] = 0.0f;
        out[2 * r + 1] = 0.0f;
    }
}

template <typename T>
__global__ void __launch_bounds__(BIS_GB_THREADS)
correct_write_kernel_strided(T* __restrict__ V, const float* __restrict__ w,
                             const float* __restrict__ ht, long long n, int j,
                             float* __restrict__ vnext,
                             float* __restrict__ partials) {
    extern __shared__ float sh_ht[];
    __shared__ float part[BIS_GB_WARPS];
    for (int i = threadIdx.x; i <= j; i += BIS_GB_THREADS) sh_ht[i] = ht[i];
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long base =
        (long long)blockIdx.x * (BIS_GB_THREADS * BIS_GB_ELEMS) + threadIdx.x;
    float acc[BIS_GB_ELEMS];
#pragma unroll
    for (int e = 0; e < BIS_GB_ELEMS; ++e) {
        const long long k = base + (long long)e * BIS_GB_THREADS;
        acc[e] = k < n ? w[k] : 0.0f;
    }
    for (int i = 0; i <= j; ++i) {
        const T* row = V + (long long)i * n;
        const float h = sh_ht[i];
#pragma unroll
        for (int e = 0; e < BIS_GB_ELEMS; ++e) {
            const long long k = base + (long long)e * BIS_GB_THREADS;
            if (k < n) acc[e] = __fsub_rn(acc[e], __fmul_rn(h, to_f32(row[k])));
        }
    }
    T* out_row = V + (long long)(j + 1) * n;
    float sq = 0.0f;
#pragma unroll
    for (int e = 0; e < BIS_GB_ELEMS; ++e) {
        const long long k = base + (long long)e * BIS_GB_THREADS;
        if (k < n) {
            const T r = from_f32<T>(acc[e]);
            out_row[k] = r;
            const float v = to_f32(r);
            vnext[k] = v;
            sq += v * v;
        }
    }
    sq = warp_sum(sq);
    if (lane == 0) part[warp] = sq;
    __syncthreads();
    if (warp == 0) {
        float s = lane < BIS_GB_WARPS ? part[lane] : 0.0f;
        s = warp_sum(s);
        if (lane == 0) partials[blockIdx.x] = s;
    }
}

// ---------------------------------------------------------------------------
// The ring route: mbarriers, bulk copies, 16-byte vectors
// ---------------------------------------------------------------------------

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

// the eight consumer warps only (the producer warp runs ahead)
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;" :: "n"(BIS_RING_WARPS * 32) : "memory");
}

// a 16-byte vector of the basis as floats: 4 floats or 8 bf16 values (a
// bf16 value is the high half of its float)
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        f[2 * k] = __uint_as_float(u[k] << 16);
        f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
}

// the floats of a float vector at 16-byte vector index `v`
template <int VEC>
__device__ __forceinline__ void load_floats(const float* __restrict__ x,
                                            long long v, float (&f)[VEC]) {
    const float4* p = reinterpret_cast<const float4*>(x) + v * (VEC / 4);
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
        const float4 t = __ldg(p + q);
        f[4 * q] = t.x;
        f[4 * q + 1] = t.y;
        f[4 * q + 2] = t.z;
        f[4 * q + 3] = t.w;
    }
}

// round acc to the basis dtype; the 16-byte vector of the rounded values
// and, in f, the rounded values as floats
__device__ __forceinline__ uint4 pack(const float (&acc)[4], float (&f)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = acc[k];
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&acc)[8], float (&f)[8]) {
    unsigned u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * k]));
        const unsigned hi =
            __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * k + 1]));
        u[k] = lo | (hi << 16);
        f[2 * k] = __uint_as_float(lo << 16);
        f[2 * k + 1] = __uint_as_float(hi << 16);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < BIS_RING_STAGES; ++s) {
            bar_init(&full[s], 1);
            bar_init(&empty[s], BIS_RING_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
}

// The producer lane: for each row chunk in the consumers' order, wait for
// its stage to be released and issue the copy.  Chunks go group by group
// of `group` rows, within a group range stage by range stage, within a
// stage row by row.
__device__ __forceinline__ void ring_produce(
        const uint4* __restrict__ V, long long n_vec, int n_rows, int group,
        long long lo, long long hi, unsigned char* ring, uint64_t* full,
        uint64_t* empty) {
    int stage = 0;
    unsigned phase = 0;
    long long k = 0;
    for (int g0 = 0; g0 < n_rows; g0 += group) {
        const int g1 = min(g0 + group, n_rows);
        for (long long c = lo; c < hi; c += BIS_RING_STAGE_VECS) {
            const unsigned bytes =
                (unsigned)(min(hi - c, (long long)BIS_RING_STAGE_VECS) * 16);
            for (int r = g0; r < g1; ++r, ++k) {
                if (k >= BIS_RING_STAGES) bar_wait(&empty[stage], phase ^ 1);
                bar_expect(&full[stage], bytes);
                bulk_load(ring + stage * BIS_RING_STAGE_BYTES,
                          V + r * n_vec + c, bytes, &full[stage]);
                if (++stage == BIS_RING_STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
    }
}

// Every thread of the block: store(p, sum) for pairs p < n_pairs, the sum
// of src[p * stride + b] over b < count in a fixed order.  L lanes take a
// pair, one 16-byte vector each, then add across the L lanes in a fixed
// tree; count <= 4 * L.  The entries of a vector at b >= count are read but
// not added: nothing writes them, so they may hold anything.
template <int L, typename Store>
__device__ __forceinline__ void sum_rows(const float* src, int n_pairs,
                                         int stride, int count, Store store) {
    const int part = threadIdx.x % L, slots = blockDim.x / L;
    const int rest = count - 4 * part;   // this lane's entries that count
    for (int p0 = 0; p0 < n_pairs; p0 += slots) {   // uniform: shuffles
        const int p = p0 + (int)threadIdx.x / L;
        float s = 0.0f;
        if (p < n_pairs && rest > 0) {
            const float4 v = __ldcg(
                reinterpret_cast<const float4*>(src + (long long)p * stride) +
                part);
            s = (v.x + (rest > 1 ? v.y : 0.0f)) +
                ((rest > 2 ? v.z : 0.0f) + (rest > 3 ? v.w : 0.0f));
        }
#pragma unroll
        for (int o = 1; o < L; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (part == 0 && p < n_pairs) store(p, s);
    }
}

// The blocks' sums in two levels, after every writer of this block's
// partials[p * gp + blockIdx.x] has fenced its writes: the last block to
// finish in each group of BIS_RING_GROUP_BLOCKS blocks adds the group's
// partials in block order into gpart[p * gq + group]; the last group to
// finish adds those in group order and stores each pair's sum.  Each level
// finds its last block by a ticket (tickets[1 + group], tickets[0]), which
// that block sets back to 0 for the next launch.  Returns true in the block
// that stored the sums.  Each level adds only the columns written in this
// launch (the group's blocks, then the groups), never a row's pads: a group
// synchronises with its own blocks only.
template <typename Store>
__device__ __forceinline__ bool finish_sums(const float* partials, int gp,
                                            float* gpart, int gq, int n_pairs,
                                            unsigned* tickets, Store store) {
    __shared__ int is_last;
    const int group = blockIdx.x / BIS_RING_GROUP_BLOCKS;
    const int n_groups = (gridDim.x + BIS_RING_GROUP_BLOCKS - 1) /
                         BIS_RING_GROUP_BLOCKS;
    const int in_group = min(BIS_RING_GROUP_BLOCKS,
                             (int)gridDim.x - group * BIS_RING_GROUP_BLOCKS);
    __syncthreads();
    if (threadIdx.x == 0)
        is_last = atomicAdd(&tickets[1 + group], 1u) == (unsigned)in_group - 1;
    __syncthreads();
    if (!is_last) return false;
    __threadfence();
    sum_rows<BIS_RING_GROUP_BLOCKS / 4>(
        partials + group * BIS_RING_GROUP_BLOCKS, n_pairs, gp, in_group,
        [&](int p, float v) { gpart[(long long)p * gq + group] = v; });
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        tickets[1 + group] = 0;
        is_last = atomicAdd(&tickets[0], 1u) == (unsigned)n_groups - 1;
    }
    __syncthreads();
    if (!is_last) return false;
    __threadfence();
    sum_rows<BIS_RING_MAX_GRID / BIS_RING_GROUP_BLOCKS / 4>(
        gpart, n_pairs, gq, n_groups, store);
    if (threadIdx.x == 0) tickets[0] = 0;
    return true;
}

// block b's first 16-byte vector of a row of n_vec: the blocks' ranges are
// contiguous, in block order, and start on 128-byte boundaries
__device__ __forceinline__ long long range_start(long long n_vec,
                                                 unsigned b) {
    return b == gridDim.x ? n_vec : (n_vec / 8) * b / gridDim.x * 8;
}

template <typename T>
__global__ void __launch_bounds__(BIS_RING_THREADS, BIS_RING_MIN_BLOCKS)
project_gram_kernel_ring(const T* __restrict__ V, const float* __restrict__ w,
                         const float* __restrict__ vc, long long n_vec,
                         int rows, int j, float* __restrict__ partials, int gp,
                         float* __restrict__ gpart, int gq,
                         float* __restrict__ out,
                         unsigned* __restrict__ tickets) {
    constexpr int VEC = 16 / sizeof(T);
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ uint64_t full[BIS_RING_STAGES], empty[BIS_RING_STAGES];
    __shared__ float slot[BIS_RING_GROUP][BIS_RING_WARPS][2];
    ring_init(full, empty);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long lo = range_start(n_vec, blockIdx.x);
    const long long hi = range_start(n_vec, blockIdx.x + 1);
    const int n_rows = j + 1;
    if (warp == BIS_RING_WARPS) {
        if (lane == 0)
            ring_produce(reinterpret_cast<const uint4*>(V), n_vec, n_rows,
                         BIS_RING_GROUP, lo, hi, ring, full, empty);
    } else {
        const int t = threadIdx.x;
        int stage = 0;
        unsigned phase = 0;
        for (int g0 = 0; g0 < n_rows; g0 += BIS_RING_GROUP) {
            const int g1 = min(g0 + BIS_RING_GROUP, n_rows);
            for (long long c = lo; c < hi; c += BIS_RING_STAGE_VECS) {
                const int cnt = (int)min(hi - c, (long long)BIS_RING_STAGE_VECS);
                float wr[BIS_RING_VECS][VEC], vr[BIS_RING_VECS][VEC];
#pragma unroll
                for (int u = 0; u < BIS_RING_VECS; ++u) {
                    const int idx = t + u * BIS_RING_WARPS * 32;
                    if (idx < cnt) {
                        load_floats<VEC>(w, c + idx, wr[u]);
                        load_floats<VEC>(vc, c + idx, vr[u]);
                    }
                }
                for (int r = g0; r < g1; ++r) {
                    bar_wait(&full[stage], phase);
                    const uint4* sv = reinterpret_cast<const uint4*>(
                        ring + stage * BIS_RING_STAGE_BYTES);
                    float pw = 0.0f, pv = 0.0f;
#pragma unroll
                    for (int u = 0; u < BIS_RING_VECS; ++u) {
                        const int idx = t + u * BIS_RING_WARPS * 32;
                        if (idx < cnt) {
                            float v[VEC];
                            unpack(sv[idx], v);
#pragma unroll
                            for (int e = 0; e < VEC; ++e) {
                                pw = fmaf(v[e], wr[u][e], pw);
                                pv = fmaf(v[e], vr[u][e], pv);
                            }
                        }
                    }
                    __syncwarp();
                    if (lane == 0) bar_arrive(&empty[stage]);
                    if (++stage == BIS_RING_STAGES) {
                        stage = 0;
                        phase ^= 1;
                    }
                    pw = warp_sum(pw);
                    pv = warp_sum(pv);
                    if (lane == 0) {
                        float* s = slot[r - g0][warp];
                        if (c == lo) {
                            s[0] = pw;
                            s[1] = pv;
                        } else {
                            s[0] += pw;
                            s[1] += pv;
                        }
                    }
                }
            }
            consumer_sync();
            for (int p = t; p < 2 * (g1 - g0); p += BIS_RING_WARPS * 32) {
                float s = 0.0f;
#pragma unroll
                for (int q = 0; q < BIS_RING_WARPS; ++q) s += slot[p >> 1][q][p & 1];
                partials[(long long)(2 * g0 + p) * gp + blockIdx.x] = s;
            }
            __threadfence();
            consumer_sync();
        }
    }
    // pair p = 2 i + c is <V_i, w> (c = 0) or <V_i, vc> (c = 1)
    if (!finish_sums(partials, gp, gpart, gq, 2 * n_rows, tickets,
                     [&](int p, float v) { out[(p & 1) * rows + (p >> 1)] = v; }))
        return;
    for (int r = n_rows + threadIdx.x; r < rows; r += blockDim.x) {
        out[r] = 0.0f;
        out[rows + r] = 0.0f;
    }
}

template <typename T>
__global__ void __launch_bounds__(BIS_RING_THREADS, BIS_RING_MIN_BLOCKS)
correct_write_kernel_ring(T* __restrict__ V, const float* __restrict__ w,
                          const float* __restrict__ ht, long long n_vec, int j,
                          float* __restrict__ vnext,
                          float* __restrict__ partials, int gp,
                          float* __restrict__ gpart, int gq,
                          float* __restrict__ nrm2,
                          unsigned* __restrict__ tickets) {
    constexpr int VEC = 16 / sizeof(T);
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ uint64_t full[BIS_RING_STAGES], empty[BIS_RING_STAGES];
    __shared__ float part[BIS_RING_WARPS];
    ring_init(full, empty);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long lo = range_start(n_vec, blockIdx.x);
    const long long hi = range_start(n_vec, blockIdx.x + 1);
    const int n_rows = j + 1;
    if (warp == BIS_RING_WARPS) {
        if (lane == 0)
            ring_produce(reinterpret_cast<const uint4*>(V), n_vec, n_rows,
                         n_rows, lo, hi, ring, full, empty);
    } else {
        const int t = threadIdx.x;
        uint4* out_row = reinterpret_cast<uint4*>(V) + (j + 1) * n_vec;
        float4* vout = reinterpret_cast<float4*>(vnext);
        int stage = 0;
        unsigned phase = 0;
        float sq = 0.0f;
        for (long long c = lo; c < hi; c += BIS_RING_STAGE_VECS) {
            const int cnt = (int)min(hi - c, (long long)BIS_RING_STAGE_VECS);
            float acc[BIS_RING_VECS][VEC];
#pragma unroll
            for (int u = 0; u < BIS_RING_VECS; ++u) {
                const int idx = t + u * BIS_RING_WARPS * 32;
                if (idx < cnt) load_floats<VEC>(w, c + idx, acc[u]);
            }
            for (int r = 0; r < n_rows; ++r) {
                const float h = __ldg(ht + r);
                bar_wait(&full[stage], phase);
                const uint4* sv = reinterpret_cast<const uint4*>(
                    ring + stage * BIS_RING_STAGE_BYTES);
#pragma unroll
                for (int u = 0; u < BIS_RING_VECS; ++u) {
                    const int idx = t + u * BIS_RING_WARPS * 32;
                    if (idx < cnt) {
                        float v[VEC];
                        unpack(sv[idx], v);
#pragma unroll
                        for (int e = 0; e < VEC; ++e)
                            acc[u][e] = __fsub_rn(acc[u][e], __fmul_rn(h, v[e]));
                    }
                }
                __syncwarp();
                if (lane == 0) bar_arrive(&empty[stage]);
                if (++stage == BIS_RING_STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
#pragma unroll
            for (int u = 0; u < BIS_RING_VECS; ++u) {
                const int idx = t + u * BIS_RING_WARPS * 32;
                if (idx < cnt) {
                    float f[VEC];
                    out_row[c + idx] = pack(acc[u], f);
#pragma unroll
                    for (int q = 0; q < VEC / 4; ++q)
                        vout[(c + idx) * (VEC / 4) + q] =
                            make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2],
                                        f[4 * q + 3]);
#pragma unroll
                    for (int e = 0; e < VEC; ++e) sq += f[e] * f[e];
                }
            }
        }
        sq = warp_sum(sq);
        if (lane == 0) part[warp] = sq;
        consumer_sync();
        if (t == 0) {
            float s = 0.0f;
#pragma unroll
            for (int q = 0; q < BIS_RING_WARPS; ++q) s += part[q];
            partials[blockIdx.x] = s;
            __threadfence();
        }
    }
    finish_sums(partials, gp, gpart, gq, 1, tickets,
                [&](int, float v) { *nrm2 = v; });
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T>
static int launch_project_strided(int device, const T* V, const float* w,
                                  const float* vc, long long n, int rows,
                                  int j, float* partials, int n_blocks,
                                  cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    project_gram_kernel_strided<T><<<n_blocks, BIS_GB_THREADS, 0, stream>>>(
        V, w, vc, n, rows, j, partials);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_correct_strided(int device, T* V, const float* w,
                                  const float* ht, long long n, int j,
                                  float* vnext, float* partials, int n_blocks,
                                  cudaStream_t stream) {
    const BisOnDevice check(device);
    if (check.err != cudaSuccess) return (int)check.err;
    const size_t shmem = (size_t)(j + 1) * sizeof(float);
    correct_write_kernel_strided<T><<<n_blocks, BIS_GB_THREADS, shmem,
                                      stream>>>(V, w, ht, n, j, vnext,
                                                partials);
    return (int)cudaGetLastError();
}

// the ring kernels take more than 48 KB of shared memory in all
template <typename K>
static cudaError_t allow_ring_smem(K kernel) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                BIS_RING_SMEM);
}

template <typename T>
static int launch_project_ring(int device, const T* V, const float* w,
                               const float* vc, long long n, int rows, int j,
                               float* partials, int gp, float* gpart, int gq,
                               float* out, unsigned* tickets, int grid,
                               cudaStream_t stream) {
    const BisOnDevice check(device);
    cudaError_t err = check.err;
    if (err == cudaSuccess) err = allow_ring_smem(project_gram_kernel_ring<T>);
    if (err != cudaSuccess) return (int)err;
    project_gram_kernel_ring<T><<<grid, BIS_RING_THREADS, BIS_RING_SMEM,
                                  stream>>>(V, w, vc, n / (16 / sizeof(T)),
                                            rows, j, partials, gp, gpart, gq,
                                            out, tickets);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_correct_ring(int device, T* V, const float* w,
                               const float* ht, long long n, int j,
                               float* vnext, float* partials, int gp,
                               float* gpart, int gq, float* nrm2,
                               unsigned* tickets, int grid,
                               cudaStream_t stream) {
    const BisOnDevice check(device);
    cudaError_t err = check.err;
    if (err == cudaSuccess) err = allow_ring_smem(correct_write_kernel_ring<T>);
    if (err != cudaSuccess) return (int)err;
    correct_write_kernel_ring<T><<<grid, BIS_RING_THREADS, BIS_RING_SMEM,
                                   stream>>>(V, w, ht, n / (16 / sizeof(T)),
                                             j, vnext, partials, gp, gpart,
                                             gq, nrm2, tickets);
    return (int)cudaGetLastError();
}

template <typename K>
static int ring_blocks(int device, K kernel, int* blocks) {
    const BisOnDevice check(device);
    cudaError_t err = check.err;
    if (err == cudaSuccess) err = allow_ring_smem(kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, kernel, BIS_RING_THREADS, BIS_RING_SMEM);
    return (int)err;
}

extern "C" {

int bis_gmres_project_gram_strided_f32(int device, const float* V,
                                       const float* w, const float* vc,
                                       long long n, int rows, int j,
                                       float* partials, int n_blocks,
                                       void* stream) {
    return launch_project_strided<float>(device, V, w, vc, n, rows, j,
                                         partials, n_blocks,
                                         (cudaStream_t)stream);
}

int bis_gmres_project_gram_strided_bf16(int device, const __nv_bfloat16* V,
                                        const float* w, const float* vc,
                                        long long n, int rows, int j,
                                        float* partials, int n_blocks,
                                        void* stream) {
    return launch_project_strided<__nv_bfloat16>(device, V, w, vc, n, rows,
                                                 j, partials, n_blocks,
                                                 (cudaStream_t)stream);
}

int bis_gmres_correct_write_strided_f32(int device, float* V, const float* w,
                                        const float* ht, long long n, int j,
                                        float* vnext, float* partials,
                                        int n_blocks, void* stream) {
    return launch_correct_strided<float>(device, V, w, ht, n, j, vnext,
                                         partials, n_blocks,
                                         (cudaStream_t)stream);
}

int bis_gmres_correct_write_strided_bf16(int device, __nv_bfloat16* V,
                                         const float* w, const float* ht,
                                         long long n, int j, float* vnext,
                                         float* partials, int n_blocks,
                                         void* stream) {
    return launch_correct_strided<__nv_bfloat16>(device, V, w, ht, n, j,
                                                 vnext, partials, n_blocks,
                                                 (cudaStream_t)stream);
}

// ..., partials, gp, gpart, gq, out, tickets, grid, stream: the blocks'
// and the groups' partials (rows of gp and gq floats a pair, 16-byte
// aligned, left as the caller gave them past the grid's blocks and
// groups), the sums, 1 + BIS_RING_MAX_GRID / BIS_RING_GROUP_BLOCKS zeroed
// tickets (left zeroed), the grid
int bis_gmres_project_gram_ring_f32(int device, const float* V,
                                    const float* w, const float* vc,
                                    long long n, int rows, int j,
                                    float* partials, int gp, float* gpart,
                                    int gq, float* out, unsigned* tickets,
                                    int grid, void* stream) {
    return launch_project_ring<float>(device, V, w, vc, n, rows, j, partials,
                                      gp, gpart, gq, out, tickets, grid,
                                      (cudaStream_t)stream);
}

int bis_gmres_project_gram_ring_bf16(int device, const __nv_bfloat16* V,
                                     const float* w, const float* vc,
                                     long long n, int rows, int j,
                                     float* partials, int gp, float* gpart,
                                     int gq, float* out, unsigned* tickets,
                                     int grid, void* stream) {
    return launch_project_ring<__nv_bfloat16>(device, V, w, vc, n, rows, j,
                                              partials, gp, gpart, gq, out,
                                              tickets, grid,
                                              (cudaStream_t)stream);
}

int bis_gmres_correct_write_ring_f32(int device, float* V, const float* w,
                                     const float* ht, long long n, int j,
                                     float* vnext, float* partials, int gp,
                                     float* gpart, int gq, float* nrm2,
                                     unsigned* tickets, int grid,
                                     void* stream) {
    return launch_correct_ring<float>(device, V, w, ht, n, j, vnext, partials,
                                      gp, gpart, gq, nrm2, tickets, grid,
                                      (cudaStream_t)stream);
}

int bis_gmres_correct_write_ring_bf16(int device, __nv_bfloat16* V,
                                      const float* w, const float* ht,
                                      long long n, int j, float* vnext,
                                      float* partials, int gp, float* gpart,
                                      int gq, float* nrm2, unsigned* tickets,
                                      int grid, void* stream) {
    return launch_correct_ring<__nv_bfloat16>(device, V, w, ht, n, j, vnext,
                                              partials, gp, gpart, gq, nrm2,
                                              tickets, grid,
                                              (cudaStream_t)stream);
}

// The resident blocks an SM of a ring kernel: which = 0 project_gram f32,
// 1 project_gram bf16, 2 correct_write f32, 3 correct_write bf16.
int bis_gmres_ring_blocks_per_sm(int device, int which, int* blocks) {
    switch (which) {
        case 0: return ring_blocks(device, project_gram_kernel_ring<float>,
                                   blocks);
        case 1: return ring_blocks(
                    device, project_gram_kernel_ring<__nv_bfloat16>, blocks);
        case 2: return ring_blocks(device, correct_write_kernel_ring<float>,
                                   blocks);
        case 3: return ring_blocks(
                    device, correct_write_kernel_ring<__nv_bfloat16>, blocks);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The ring route's shape, for the wrapper to check its mirror of it.
void bis_gmres_ring_shape(int* consumers, int* stage_vecs, int* stages,
                          int* max_grid, int* group_blocks) {
    *consumers = BIS_RING_WARPS * 32;
    *stage_vecs = BIS_RING_STAGE_VECS;
    *stages = BIS_RING_STAGES;
    *max_grid = BIS_RING_MAX_GRID;
    *group_blocks = BIS_RING_GROUP_BLOCKS;
}

}  // extern "C"
