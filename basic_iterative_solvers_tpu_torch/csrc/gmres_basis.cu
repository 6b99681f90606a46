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
//       vnext = float32(V[j+1]),  partials of |vnext|^2
//
// V is (rows, n), row-major, float or __nv_bfloat16; w, vc, vnext and ht
// are float.  j comes by value: the solver knows each iteration's index
// within its restart cycle, so nothing is read back from the device.
//
// What bounds it on the card: HBM bytes.  Each pass streams rows 0..j of V
// once, plus one or two float vectors.  For the 128^3 HPCG shape
// (n = 2,097,152, GMRES(50), bf16 basis) a row is 4.2 MB, so at j = 49 a
// pass moves 50 rows (210 MB) plus w and vc (16.8 MB) for project_gram, or
// plus w, vnext and the written row (21 MB) for correct_write: ~68 us and
// ~69 us at the 3.35 TB/s peak (twice the row bytes with a float basis).
// The flops (2 or 4 per element) are far below the card's rate.
//
// Design: a grid over chunks of the vector index, each block owning
// BIS_GB_THREADS * BIS_GB_ELEMS entries, each thread BIS_GB_ELEMS of them
// strided by the block width, so a warp's loads are contiguous.  A block
// keeps its slice of w (and vc) in registers and walks the rows, so V is
// read once per pass and w, vc once.  project_gram reduces both products of
// a row over the block (warp shuffles, then shared memory) into a
// (n_blocks, rows, 2) buffer; correct_write reduces |vnext|^2 into
// (n_blocks,).  The caller sums the partials with torch.sum: deterministic,
// no atomics.  correct_write rounds each product and difference on its own
// (__fmul_rn, __fsub_rn, no FMA contraction), as the plain PyTorch version
// does, so the two write the same bits.  Not yet: vector loads, TMA
// pipelines, one launch for both passes.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define BIS_GB_THREADS 256
#define BIS_GB_ELEMS 8
#define BIS_GB_WARPS (BIS_GB_THREADS / 32)

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

template <typename T>
__global__ void __launch_bounds__(BIS_GB_THREADS)
project_gram_kernel(const T* __restrict__ V, const float* __restrict__ w,
                    const float* __restrict__ vc, long long n, int rows,
                    int j, float* __restrict__ partials) {
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
correct_write_kernel(T* __restrict__ V, const float* __restrict__ w,
                     const float* __restrict__ ht, long long n, int j,
                     float* __restrict__ vnext, float* __restrict__ partials) {
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

template <typename T>
static int launch_project(int device, const T* V, const float* w,
                          const float* vc, long long n, int rows, int j,
                          float* partials, int n_blocks, cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    project_gram_kernel<T><<<n_blocks, BIS_GB_THREADS, 0, stream>>>(
        V, w, vc, n, rows, j, partials);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_correct(int device, T* V, const float* w, const float* ht,
                          long long n, int j, float* vnext, float* partials,
                          int n_blocks, cudaStream_t stream) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    const size_t shmem = (size_t)(j + 1) * sizeof(float);
    correct_write_kernel<T><<<n_blocks, BIS_GB_THREADS, shmem, stream>>>(
        V, w, ht, n, j, vnext, partials);
    return (int)cudaGetLastError();
}

extern "C" {

int bis_gmres_project_gram_f32(int device, const float* V, const float* w,
                               const float* vc, long long n, int rows, int j,
                               float* partials, int n_blocks, void* stream) {
    return launch_project<float>(device, V, w, vc, n, rows, j, partials,
                                 n_blocks, (cudaStream_t)stream);
}

int bis_gmres_project_gram_bf16(int device, const __nv_bfloat16* V,
                                const float* w, const float* vc, long long n,
                                int rows, int j, float* partials,
                                int n_blocks, void* stream) {
    return launch_project<__nv_bfloat16>(device, V, w, vc, n, rows, j,
                                         partials, n_blocks,
                                         (cudaStream_t)stream);
}

int bis_gmres_correct_write_f32(int device, float* V, const float* w,
                                const float* ht, long long n, int j,
                                float* vnext, float* partials, int n_blocks,
                                void* stream) {
    return launch_correct<float>(device, V, w, ht, n, j, vnext, partials,
                                 n_blocks, (cudaStream_t)stream);
}

int bis_gmres_correct_write_bf16(int device, __nv_bfloat16* V,
                                 const float* w, const float* ht, long long n,
                                 int j, float* vnext, float* partials,
                                 int n_blocks, void* stream) {
    return launch_correct<__nv_bfloat16>(device, V, w, ht, n, j, vnext,
                                         partials, n_blocks,
                                         (cudaStream_t)stream);
}

}  // extern "C"
