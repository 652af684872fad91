// The split's one-sided Jacobi SVD: fixed sweeps of round-robin Givens
// rotations on a ragged batch of matrices, every bucket group of a split
// in one launch.
//
// Each matrix m of the batch is a tall R x C matrix A (C even) and its
// C x C rotation V, both stored column by column (column j of A is R
// contiguous elements) in two workspaces; an int64 table of (A offset,
// V offset, R, C) rows, in elements, says where (linalg/jacobi_svd.py,
// ragged_table).  A sweep is C - 1 rounds; round r pairs the columns
// (p, q) of the round-robin schedule (column 0 fixed, positions 1 .. C-1
// shifted by r: linalg/jacobi_svd.py, jacobi_schedule) and rotates each
// of its C / 2 disjoint pairs by
//     app = |A_p|^2,  aqq = |A_q|^2,  apq = conj(A_p) . A_q,
//     tiny = |apq| <= 1e-300 + 1e-18 sqrt(app aqq),
//     tau = clamp((aqq - app) / (2 |apq|), +-1e18)   (1 in the denominator
//           where tiny),
//     t = sign(tau) / (|tau| + sqrt(1 + tau^2))      (sign(0) = +1; 0 where
//           tiny),  c = 1 / sqrt(1 + t^2),  s = t c apq / |apq|,
//     new_p = c X_p - conj(s) X_q,   new_q = s X_p + c X_q
// for X = A and X = V.  A matrix sweeps until a sweep finds it converged
// (no pair with |apq| > R eps |A|_F max(|A_p|, |A_q|), eps of the type;
// |A|_F does not change under the rotations) or max_sweeps have run; the
// caller takes S from A's column norms, U = A / S, and V as it is.
//
// Replaces tenpy_tpu/linalg/packed_split.py:487, _decomp_jacobi (with
// _jacobi_schedule:417): a JAX device program, not a Pallas kernel, that
// XLA compiles per bucket group into (14 sweeps x rounds) steps of gathers,
// reductions and scatters over the whole batch, on split re/im f64 channels
// (the TPU has no complex128).  Here one launch covers every group of a
// split, complex128 is native (interleaved re/im, read as double2), a
// block stops when its matrix has converged (14 fixed sweeps left a chi=256
// Hubbard split's smallest singular values wrong by up to 3.4e-6 of their
// matrix's largest; it took 19), and the launch neither allocates nor
// synchronises with the host.
//
// What bounds it on an H100: operations, on the CUDA cores (the rotations
// are FMAs, not products a tensor core takes).  A pair costs 12R + 6C
// flops a round (three dots of length R, 6R; the rotation of two columns
// of A, 6R, and of V, 6C; in complex 16R, 20R and 20C), so 14 sweeps of a
// 192 x 192 f64 matrix are about 0.89 GFLOP, against 0.6 MB of M, U and V:
// at 33.5 TFLOP/s of f64 on 132 SMs that is 3.5 ms on one SM.  The design,
// right and simple first:
//   - one thread block per matrix; the C / 2 pairs of a round spread over
//     the block's warps, one warp per pair at a time; the lanes run along
//     the rows of both columns (coalesced: a column is contiguous), the
//     three dots are summed in FP64 FMA and reduced by an xor butterfly of
//     warp shuffles, so that every lane holds the same sums and the same
//     rotation; each lane then rotates the rows it read;
//   - one __syncthreads() per round: a round's pairs are disjoint, so the
//     warps never touch each other's columns within it; the last round's is
//     a __syncthreads_or() of the sweep's convergence test;
//   - A and V stay in the device-memory workspace (10.6 MB for a chi=256
//     iDMRG split, within the 50 MB L2); rows of the table come largest
//     first, so the longest blocks start first.
// Left for later: staging a block's columns in shared memory, a thread
// block cluster per large matrix, blocked Jacobi on the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_THREADS = 1024;

// real T, or complex T2 (interleaved re, im)
template <typename T> struct Vec2;
template <> struct Vec2<double> { using type = double2; };
template <> struct Vec2<float> { using type = float2; };
template <typename T, bool CPLX>
using Elem = typename std::conditional<CPLX, typename Vec2<T>::type,
                                       T>::type;

__device__ __forceinline__ double fma_(double a, double b, double c) {
    return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double clamp_(double x, double b) {
    return fmin(fmax(x, -b), b);
}
__device__ __forceinline__ float clamp_(float x, float b) {
    return fminf(fmaxf(x, -b), b);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// |A_p|^2, |A_q|^2 and conj(A_p) . A_q (re, im) of one column pair over
// the rows lane, lane + 32, ... of this lane
template <typename T>
__device__ __forceinline__ void sums_real(const T* Ap, const T* Aq, int R,
                                          int lane, T& app, T& aqq, T& re) {
#pragma unroll 4
    for (int i = lane; i < R; i += 32) {
        const T x = Ap[i], y = Aq[i];
        app = fma_(x, x, app);
        aqq = fma_(y, y, aqq);
        re = fma_(x, y, re);
    }
}

template <typename T, typename T2>
__device__ __forceinline__ void sums_cplx(const T2* Ap, const T2* Aq, int R,
                                          int lane, T& app, T& aqq, T& re,
                                          T& im) {
#pragma unroll 4
    for (int i = lane; i < R; i += 32) {
        const T2 x = Ap[i], y = Aq[i];
        app = fma_(x.x, x.x, fma_(x.y, x.y, app));
        aqq = fma_(y.x, y.x, fma_(y.y, y.y, aqq));
        re = fma_(x.x, y.x, fma_(x.y, y.y, re));
        im = fma_(x.x, y.y, fma_(-x.y, y.x, im));
    }
}

// new_p = c x_p - conj(s) x_q, new_q = s x_p + c x_q on the rows of this
// lane of two columns of n rows
template <typename T>
__device__ __forceinline__ void rotate_real(T* Xp, T* Xq, int n, int lane,
                                            T c, T s) {
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {
        const T x = Xp[i], y = Xq[i];
        Xp[i] = c * x - s * y;
        Xq[i] = s * x + c * y;
    }
}

template <typename T, typename T2>
__device__ __forceinline__ void rotate_cplx(T2* Xp, T2* Xq, int n, int lane,
                                            T c, T sr, T si) {
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {
        const T2 x = Xp[i], y = Xq[i];
        T2 np_, nq;
        np_.x = c * x.x - (sr * y.x + si * y.y);
        np_.y = c * x.y - (sr * y.y - si * y.x);
        nq.x = sr * x.x - si * x.y + c * y.x;
        nq.y = sr * x.y + si * x.x + c * y.y;
        Xp[i] = np_;
        Xq[i] = nq;
    }
}

template <typename T> __device__ __forceinline__ T eps_();
template <> __device__ __forceinline__ double eps_<double>() {
    return 2.220446049250313e-16;
}
template <> __device__ __forceinline__ float eps_<float>() {
    return 1.1920928955078125e-07f;
}

// |A|_F^2 of the block's matrix (n elements), in every thread
template <typename T, bool CPLX>
__device__ T frobenius_sq(const Elem<T, CPLX>* Am, long long n, T* red) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    T acc = T(0);
    for (long long i = tid; i < n; i += blockDim.x) {
        if constexpr (CPLX) {
            acc = fma_(Am[i].x, Am[i].x, fma_(Am[i].y, Am[i].y, acc));
        } else {
            acc = fma_(Am[i], Am[i], acc);
        }
    }
    acc = warp_sum(acc);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
        acc = warp_sum(acc);
        if (lane == 0) red[0] = acc;
    }
    __syncthreads();
    return red[0];
}

template <typename T, bool CPLX>
__global__ void __launch_bounds__(MAX_THREADS)
jacobi_kernel(Elem<T, CPLX>* A, Elem<T, CPLX>* V,
              const long long* __restrict__ table, int max_sweeps,
              int init_v, int* sweeps_out) {
    using E = Elem<T, CPLX>;
    __shared__ T red[MAX_THREADS / 32];
    const long long* row = table + 4 * (long long)blockIdx.x;
    E* Am = A + row[0];
    E* Vm = V + row[1];
    const int R = (int)row[2], C = (int)row[3];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5, half = C >> 1, m = C - 1;
    // a pair is still active while |apq| > thr max(|A_p|, |A_q|)
    const T thr = T(R) * eps_<T>() *
        sqrt_(frobenius_sq<T, CPLX>(Am, (long long)R * C, red));

    if (init_v) {
        for (int i = tid; i < C * C; i += blockDim.x) {
            const T d = i / C == i % C ? T(1) : T(0);
            if constexpr (CPLX) {
                Vm[i].x = d;
                Vm[i].y = T(0);
            } else {
                Vm[i] = d;
            }
        }
        __syncthreads();
    }
    int sweeps = 0;
    while (sweeps < max_sweeps) {
        int active = 0;
        for (int r = 0; r < m; ++r) {
            for (int i = warp; i < half; i += nwarps) {
                // positions i and C - 1 - i of round r (position 0 holds
                // column 0; position k >= 1 holds ((k - 1 - r) mod m) + 1)
                int a = i == 0 ? 0 : ((i - 1 - r) % m + m) % m + 1;
                int b = ((C - 2 - i - r) % m + m) % m + 1;
                int p = min(a, b), q = max(a, b);
                E* Ap = Am + (long long)p * R;
                E* Aq = Am + (long long)q * R;
                T app = T(0), aqq = T(0), re = T(0), im = T(0), abs_apq;
                if constexpr (CPLX) {
                    sums_cplx(Ap, Aq, R, lane, app, aqq, re, im);
                    im = warp_sum(im);
                } else {
                    sums_real(Ap, Aq, R, lane, app, aqq, re);
                }
                app = warp_sum(app);
                aqq = warp_sum(aqq);
                re = warp_sum(re);
                if constexpr (CPLX) {
                    abs_apq = sqrt_(re * re + im * im);
                } else {
                    abs_apq = abs_(re);
                }
                active |= abs_apq > thr * sqrt_(app > aqq ? app : aqq);
                const bool nz = abs_apq > T(0);
                const T denom = nz ? abs_apq : T(1);
                const T ph_re = nz ? re / denom : T(1);
                const T ph_im = nz ? im / denom : T(0);
                const bool tiny =
                    abs_apq <= T(1e-300) + T(1e-18) * sqrt_(app * aqq);
                T tau = (aqq - app) / (tiny ? T(1) : T(2) * abs_apq);
                tau = clamp_(tau, T(1e18));
                const T sgn = tau >= T(0) ? T(1) : T(-1);
                T t = sgn / (abs_(tau) + sqrt_(T(1) + tau * tau));
                if (tiny) t = T(0);
                const T c = T(1) / sqrt_(T(1) + t * t);
                const T tc = t * c;
                const T sr = tc * ph_re, si = tc * ph_im;
                E* Vp = Vm + (long long)p * C;
                E* Vq = Vm + (long long)q * C;
                if constexpr (CPLX) {
                    rotate_cplx(Ap, Aq, R, lane, c, sr, si);
                    rotate_cplx(Vp, Vq, C, lane, c, sr, si);
                } else {
                    rotate_real(Ap, Aq, R, lane, c, sr);
                    rotate_real(Vp, Vq, C, lane, c, sr);
                }
            }
            if (r < m - 1) __syncthreads();
        }
        ++sweeps;
        if (!__syncthreads_or(active)) break;
    }
    if (sweeps_out != nullptr && tid == 0) sweeps_out[blockIdx.x] = sweeps;
}

template <typename T, bool CPLX>
int launch(void* A, void* V, const void* table, int n, int max_sweeps,
           int init_v, int threads, int* sweeps_out, void* stream) {
    using E = Elem<T, CPLX>;
    jacobi_kernel<T, CPLX><<<n, threads, 0, (cudaStream_t)stream>>>(
        (E*)A, (E*)V, (const long long*)table, max_sweeps, init_v,
        sweeps_out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int jacobi_svd_max_threads() { return MAX_THREADS; }

// mode 0: float64, 1: complex128, 2: float32, 3: complex64 (interleaved
// re/im).  A, V: the workspaces; table: int64 (n, 4) rows (A offset, V
// offset, R, C) on the device, C even; each matrix sweeps until converged
// or max_sweeps have run; threads: a multiple of 32 up to MAX_THREADS.
// init_v sets every V to the identity first; sweeps_out (int32, n entries,
// or null) receives the sweeps each matrix ran.  Launches on `stream` and
// returns a cudaError_t code (0 on success).
int jacobi_svd_sweeps(int mode, void* A, void* V, const void* table, int n,
                      int max_sweeps, int init_v, int threads,
                      void* sweeps_out, void* stream) {
    if (n <= 0) return 0;
    if (threads <= 0 || threads > MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    int* so = (int*)sweeps_out;
    switch (mode) {
        case 0: return launch<double, false>(A, V, table, n, max_sweeps,
                                             init_v, threads, so, stream);
        case 1: return launch<double, true>(A, V, table, n, max_sweeps,
                                            init_v, threads, so, stream);
        case 2: return launch<float, false>(A, V, table, n, max_sweeps,
                                            init_v, threads, so, stream);
        case 3: return launch<float, true>(A, V, table, n, max_sweeps,
                                           init_v, threads, so, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* jacobi_svd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
