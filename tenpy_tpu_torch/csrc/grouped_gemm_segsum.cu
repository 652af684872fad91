// Fused gather -> grouped GEMM -> segment sum for the packed tensordot.
//
//     out[s] = sum_{t in seg_ptr[s] .. seg_ptr[s+1]-1}  a_src[ia[t]] @ b_src[ib[t]]
//
// a_src (Na, m, k), b_src (Nb, k, n) and out (n_seg, m, n) are row-major and
// contiguous; seg_ptr (n_seg + 1), ia and ib (B) are int32.  The entries of
// one segment are the charge-sector products that land in the same output
// block (the fan-in of the contracted legs).
//
// Replaces the TPU kernel tenpy_tpu/linalg/pallas_gemm.py:_kernel /
// _grouped_gemm_segsum (the one pl.pallas_call of tenpy_tpu).  That kernel
// walks the segment-sorted entries on a sequential grid and carries the sum
// in VMEM scratch from one grid step to the next.  Blocks on a GPU run in no
// order, so here each block owns one (TM x TN) output tile of one segment and
// loops over that segment's entries itself: the sum stays in registers, every
// output tile is written exactly once, no atomics are needed, and the result
// is the same from run to run.
//
// What bounds it on an H100: at DMRG block sizes (m, k, n of 8 .. a few
// hundred) the bucket GEMMs are small and many, and the unfused chain would
// write and re-read the gathered operands and the per-entry products in
// device memory; bytes bound it there.  The fusion removes those round trips:
// operands are read straight from the source stacks through the gather
// indices, staged in shared memory, and only the segment sums reach device
// memory.  On the large buckets of chi >= 256 the f64 FMA rate of the SMs
// bounds it; this first version uses the CUDA cores (no f64 tensor-core
// DMMA, no wgmma/TMA), with a 64 x 64 tile per block and a 4 x 4
// register tile per thread to reuse each shared-memory load 4 times.
//
// Every ragged edge (m, k or n not a multiple of the tile) is masked, so any
// m, k, n >= 1 works.  Sums accumulate in the input type (f64 or f32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;          // output rows per block
constexpr int TN = 64;          // output columns per block
constexpr int TK = 16;          // depth of one shared-memory stage
constexpr int TX = 16;          // threads along n
constexpr int TY = 16;          // threads along m
constexpr int RM = TM / TY;     // rows per thread
constexpr int RN = TN / TX;     // columns per thread
constexpr int THREADS = TX * TY;
constexpr int MAX_GRID_Z = 65535;

__device__ __forceinline__ double fused_madd(double a, double b, double c) {
    return fma(a, b, c);
}
__device__ __forceinline__ float fused_madd(float a, float b, float c) {
    return fmaf(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_segsum_kernel(const T* __restrict__ a_src,
                           const T* __restrict__ b_src,
                           const int* __restrict__ seg_ptr,
                           const int* __restrict__ ia,
                           const int* __restrict__ ib,
                           T* __restrict__ out,
                           int m, int k, int n, int seg0) {
    // A is staged transposed (k-major) so the inner loop reads a column of
    // the tile as a broadcast; the +1 pad keeps the transposing store free
    // of bank conflicts.
    __shared__ T As[TK][TM + 1];
    __shared__ T Bs[TK][TN];

    const int seg = seg0 + blockIdx.z;
    const int row0 = blockIdx.y * TM;
    const int col0 = blockIdx.x * TN;
    const int tx = threadIdx.x % TX;
    const int ty = threadIdx.x / TX;

    T acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = T(0);

    const int t_end = seg_ptr[seg + 1];
    for (int t = seg_ptr[seg]; t < t_end; ++t) {
        const T* A = a_src + static_cast<size_t>(ia[t]) * m * k;
        const T* B = b_src + static_cast<size_t>(ib[t]) * k * n;
        for (int k0 = 0; k0 < k; k0 += TK) {
            // neighbouring threads read neighbouring addresses of one row
            for (int e = threadIdx.x; e < TM * TK; e += THREADS) {
                const int r = e / TK, c = e % TK;
                const int gr = row0 + r, gc = k0 + c;
                As[c][r] = (gr < m && gc < k)
                    ? A[static_cast<size_t>(gr) * k + gc] : T(0);
            }
            for (int e = threadIdx.x; e < TK * TN; e += THREADS) {
                const int r = e / TN, c = e % TN;
                const int gr = k0 + r, gc = col0 + c;
                Bs[r][c] = (gr < k && gc < n)
                    ? B[static_cast<size_t>(gr) * n + gc] : T(0);
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < TK; ++kk) {
                T a_reg[RM], b_reg[RN];
#pragma unroll
                for (int i = 0; i < RM; ++i) a_reg[i] = As[kk][ty + TY * i];
#pragma unroll
                for (int j = 0; j < RN; ++j) b_reg[j] = Bs[kk][tx + TX * j];
#pragma unroll
                for (int i = 0; i < RM; ++i)
#pragma unroll
                    for (int j = 0; j < RN; ++j)
                        acc[i][j] = fused_madd(a_reg[i], b_reg[j], acc[i][j]);
            }
            __syncthreads();
        }
    }

    T* O = out + static_cast<size_t>(seg) * m * n;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int r = row0 + ty + TY * i;
        if (r >= m) continue;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int c = col0 + tx + TX * j;
            if (c < n) O[static_cast<size_t>(r) * n + c] = acc[i][j];
        }
    }
}

template <typename T>
int launch(const void* a_src, const void* b_src, const void* seg_ptr,
           const void* ia, const void* ib, void* out,
           int n_seg, int m, int k, int n, void* stream) {
    const dim3 block(THREADS);
    const unsigned gx = (n + TN - 1) / TN;
    const unsigned gy = (m + TM - 1) / TM;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int seg0 = 0; seg0 < n_seg; seg0 += MAX_GRID_Z) {
        const int nz = (n_seg - seg0 < MAX_GRID_Z) ? n_seg - seg0 : MAX_GRID_Z;
        grouped_gemm_segsum_kernel<T><<<dim3(gx, gy, nz), block, 0, s>>>(
            static_cast<const T*>(a_src), static_cast<const T*>(b_src),
            static_cast<const int*>(seg_ptr), static_cast<const int*>(ia),
            static_cast<const int*>(ib), static_cast<T*>(out), m, k, n, seg0);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int grouped_gemm_segsum_f64(const void* a_src, const void* b_src,
                            const void* seg_ptr, const void* ia,
                            const void* ib, void* out, int n_seg, int m, int k,
                            int n, void* stream) {
    return launch<double>(a_src, b_src, seg_ptr, ia, ib, out, n_seg, m, k, n,
                          stream);
}

int grouped_gemm_segsum_f32(const void* a_src, const void* b_src,
                            const void* seg_ptr, const void* ia,
                            const void* ib, void* out, int n_seg, int m, int k,
                            int n, void* stream) {
    return launch<float>(a_src, b_src, seg_ptr, ia, ib, out, n_seg, m, k, n,
                         stream);
}

const char* grouped_gemm_segsum_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
