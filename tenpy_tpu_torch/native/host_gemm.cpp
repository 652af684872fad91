// The GEMM tasks of the host block-sparse tensordot, in one C++ loop.
//
// A tensordot of charge-conserving tensors is many small independent
// GEMMs whose products add up into shared output blocks (the plan of
// tenpy_tpu_torch/linalg/np_conserved.py, `_tensordot_plan`).  Run from
// Python, each task costs microseconds of interpreter time; this loop runs
// the same tasks, in the same order and with the same accumulation, at the
// cost of the BLAS calls alone.  It replaces no TPU kernel: it is the
// counterpart of the JAX package's host executor
// (tenpy_tpu/native/batched_gemm.cpp), which is host code too.
//
// The BLAS is the one the process already runs: the caller hands over
// the addresses of dgemm_/zgemm_ (torch's MKL), so nothing is linked.
// Matrices are row-major and contiguous; BLAS is column-major, so
// C = A B is computed as C^T = B^T A^T: gemm('N', 'N', n, m, k, ...).

#include <algorithm>
#include <cstdint>

extern "C" {

// dgemm_ and zgemm_ share this signature: alpha and beta point to one
// double (real) or two (complex: re, im); passing two serves both.
typedef void (*gemm_t)(const char* transa, const char* transb, const int* m,
                       const int* n, const int* k, const double* alpha,
                       const void* a, const int* lda, const void* b,
                       const int* ldb, const double* beta, void* c,
                       const int* ldc);

// Task t multiplies a_ptrs[t] (m x k) by b_ptrs[t] (k x n) into c_ptrs[t]
// (m x n), with (m, k, n) = dims[3t .. 3t+2]; first[t] = 1 writes the
// product (the first task of its output block), 0 adds it.  Returns 0, or
// 1 + the index of a task with a negative dimension.
int64_t host_gemm_run(void* gemm_fn, int64_t n_tasks, const int64_t* a_ptrs,
                      const int64_t* b_ptrs, const int64_t* c_ptrs,
                      const int32_t* dims, const uint8_t* first) {
    gemm_t gemm = reinterpret_cast<gemm_t>(gemm_fn);
    const double one[2] = {1.0, 0.0};
    const double zero[2] = {0.0, 0.0};
    for (int64_t t = 0; t < n_tasks; ++t) {
        const int m = dims[3 * t], k = dims[3 * t + 1], n = dims[3 * t + 2];
        if (m < 0 || k < 0 || n < 0) return t + 1;
        if (m == 0 || n == 0) continue;
        // leading dimensions at least 1, as BLAS requires (k may be 0:
        // then C is set to 0 or left as it is)
        const int ldb = std::max(n, 1), lda = std::max(k, 1),
                  ldc = std::max(n, 1);
        gemm("N", "N", &n, &m, &k, one,
             reinterpret_cast<const void*>(b_ptrs[t]), &ldb,
             reinterpret_cast<const void*>(a_ptrs[t]), &lda,
             first[t] ? zero : one, reinterpret_cast<void*>(c_ptrs[t]), &ldc);
    }
    return 0;
}

}  // extern "C"
