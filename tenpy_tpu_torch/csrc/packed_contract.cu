// The packed tensordot in one launch: every bucket GEMM of a contraction,
// gathered, multiplied, summed per output row and written into the output
// buckets.
//
//     out[so][r] = sum over the entries e of output row (so, r) of
//                  a[ab_e][ablk_e] (m x k_e)  @  b[bb_e][bblk_e] (k_e x n)
//
// Every output bucket so holds blocks of one shape (m, n); every block is
// row-major and contiguous inside its bucket, and every bucket is
// contiguous.  The bucket base pointers travel by value in a
// __grid_constant__ parameter struct, so a call copies nothing to the
// device.  Two int32 tables, built on the host once per contraction
// structure (linalg/grouped_gemm.py, build_tables), say what to do:
//   tasks   (n_tasks, 8): class, out bucket, out row, tile origin (2),
//                         entry range (begin, end), unused;
//   entries (n_entries, 5): a bucket, a block, b bucket, b block, k;
// the entries of one output row are contiguous, and tasks are sorted by
// their work, largest first, so that long tasks start first.
//
// Replaces the TPU kernel tenpy_tpu/linalg/pallas_gemm.py:_kernel /
// _grouped_gemm_segsum (its pl.pallas_call): that kernel does one bucket
// pair per call, walks the segment-sorted entries on a sequential grid and
// carries the sum in VMEM scratch; the sums of different bucket pairs are
// then gathered and added by XLA.  Here one warp owns one output tile and
// loops over all of its entries, across bucket pairs, with the sum in
// registers: every output element has exactly one writer, there are no
// atomics, the result is the same from run to run, and rows that no entry
// reaches are written as zeros.
//
// What bounds it on an H100: bytes.  At DMRG sector sizes (8..64) a block
// product does at most 2 * 64 flops per 8-byte element of its operands, and
// the contraction with an MPO tensor (k = n = 1) does 2 flops per element it
// streams, so device memory (3.35 TB/s) and not the f64 tensor cores
// (67 TFLOP/s) or CUDA cores (34 TFLOP/s) set the floor.  At chi = 256
// (Hubbard cylinder) one two-site matvec is four calls: the thin class must
// move about 127 MB per MPO contraction (38 us at 3.35 TB/s, against 0.12
// GFLOP), the block class about 71 MB per virtual-leg contraction (21 us,
// against 0.51 GFLOP = 7.6 us on the f64 tensor cores): operands and output
// once, and 12 bytes of index per block product.  What the design does
// about it:
//   - thin class (min(m, n, k) < 8, chiefly the MPO contractions): lanes run
//     along the m * n elements of an output row with 16-byte loads of each
//     entry's A block, B's factors are read once per entry, the sum stays in
//     registers; no shared memory and no tensor cores, nothing is padded.
//     Tables whose tasks are all thin (every MPO contraction) run a kernel
//     of their own, thin_kernel, without the block class's registers and
//     shared memory, so that more warps per SM keep loads in flight;
//   - block class (m, n, k >= 8): one warp owns a WM x WN tile (8, 16 or 32
//     each, chosen per output bucket so that small blocks are not padded to
//     a large tile), stages A and B chunks of depth 8 in shared memory with
//     16-byte cp.async, double-buffered across the entry loop so that the
//     next chunk loads while this one is multiplied, and multiplies on the
//     f64 tensor cores (mma.sync m8n8k4; f32 runs FFMA on the CUDA cores,
//     never TF32).  Ragged edges (m, n or k not a multiple of the tile or
//     of the mma depth) are zero-filled by cp.async and masked on store.
// In packed_contract_kernel, the kernel for any tables, four independent
// warps share a block; they never synchronise with each other, so a block
// may mix classes.  Block products are computed in the
// compute type C and summed over entries in the data type T: f64 for f64
// data, f32 for f32 data, and under the f32 matmul mode (f64 data, C = f32)
// f32 products summed in f64, as tenpy_tpu's f32 mode does.
//
// Complex128 (mode 3) runs kernels of its own beside the real ones, on
// native complex storage: an element is 16 bytes, (re, im) interleaved, read
// as a double2 (tenpy_tpu splits re and im into two f64 channels and
// multiplies them with three real GEMMs outside its Pallas kernel; the TPU
// has no complex128).  It is bound by bytes as the real modes are (a
// complex multiply-add is 8 real flops on 32 bytes of operands).  The thin
// class multiplies on the CUDA cores (complex FMA, one 16-byte load per
// element).  The block class stages one complex element per 16-byte
// cp.async, splits re and im when it loads the fragments, and computes
//     Cre += Are Bre - Aim Bim,   Cim += Are Bim + Aim Bre
// with four real f64 mma.sync m8n8k4 per k step into two accumulators: four
// products and not Karatsuba's three, whose (Are + Aim)(Bre + Bim) term
// loses the relative accuracy of a small imaginary part.  A complex stage
// is twice a real one, so the kernel for any tables runs two warps a block
// (43 KB of static shared memory) where the real one runs four.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int WARPS = 4;                 // warps (= tasks) per block
constexpr int THREADS = 32 * WARPS;
constexpr int THIN_WARPS = 8;            // per block of the thin kernel
constexpr int THIN_THREADS = 32 * THIN_WARPS;
constexpr int MAX_BUCKETS = 64;          // per operand and for the output
constexpr int TASK_COLS = 8;
constexpr int ENTRY_COLS = 5;
constexpr int THIN_TILE = 256;           // output elements of a thin task
constexpr int KC = 8;                    // depth of one staged chunk
constexpr int MAX_W = 32;                // largest warp tile side
constexpr int SA = KC + 4;               // A chunk row stride (elements)
constexpr int STAGE = MAX_W * SA + KC * (MAX_W + 4);   // elements per stage

struct Params {
    const void* a[MAX_BUCKETS];
    const void* b[MAX_BUCKETS];
    void* o[MAX_BUCKETS];
    int om[MAX_BUCKETS];                 // rows of an output block
    int on[MAX_BUCKETS];                 // columns of an output block
    const int* tasks;
    const int* entries;
    int n_tasks;
};

__device__ __forceinline__ double madd(double a, double b, double c) {
    return fma(a, b, c);
}
__device__ __forceinline__ float madd(float a, float b, float c) {
    return fmaf(a, b, c);
}

template <typename T> struct Vec16;
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<float> { using type = float4; };

template <typename T>
__device__ __forceinline__ bool aligned16(const T* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// ------------------------------------------------------------- thin class
template <typename P>
__device__ __forceinline__ P shfl_ptr(P ptr, int src) {
    return reinterpret_cast<P>(__shfl_sync(
        0xffffffffu, reinterpret_cast<unsigned long long>(ptr), src));
}

// One warp sums THIN_TILE elements [x0, x0 + THIN_TILE) of one output row
// (its m * n elements in row-major order) over the row's entries.  The
// entries are taken 32 at a time: lane j reads entry j's table row, block
// addresses and (for k = n = 1) its weight, and the warp then walks them
// with shuffles, so no table load sits in the chain of loads of a block.
// The scaled vector adds (k = n = 1) keep two entries' 16-byte loads in
// flight.
template <typename T, typename C>
__device__ __forceinline__ void thin_task(const Params& p, const int* tk,
                                          int lane) {
    constexpr int V = 16 / sizeof(T);
    constexpr int U = THIN_TILE / (32 * V);
    using VT = typename Vec16<T>::type;
    const int so = __ldg(tk + 1), row = __ldg(tk + 2), x0 = __ldg(tk + 3);
    const int e0 = __ldg(tk + 5), e1 = __ldg(tk + 6);
    const int m = p.om[so], n = p.on[so];
    const int mn = m * n;
    T acc[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[u][v] = T(0);

    for (int base = e0; base < e1; base += 32) {
        const int cnt = min(32, e1 - base);
        const T* Aj = nullptr;
        const T* Bj = nullptr;
        int kj = 1;
        C wj = C(0);
        if (lane < cnt) {
            const int* en = p.entries
                + static_cast<size_t>(base + lane) * ENTRY_COLS;
            kj = __ldg(en + 4);
            Aj = static_cast<const T*>(p.a[__ldg(en)])
                + static_cast<size_t>(__ldg(en + 1)) * m * kj;
            Bj = static_cast<const T*>(p.b[__ldg(en + 2)])
                + static_cast<size_t>(__ldg(en + 3)) * kj * n;
            if (kj == 1 && n == 1) wj = static_cast<C>(__ldg(Bj));
        }
        const bool vec = __all_sync(0xffffffffu, lane >= cnt
                                    || (kj == 1 && aligned16(Aj)))
                         && n == 1 && mn % V == 0;
        if (vec) {
            // out[x] += w * A[x]: scaled vector adds, two entries at a time
            for (int i = 0; i < cnt; i += 2) {
                const bool two = i + 1 < cnt;
                const T* A0 = shfl_ptr(Aj, i);
                const T* A1 = shfl_ptr(Aj, two ? i + 1 : i);
                const C w0 = __shfl_sync(0xffffffffu, wj, i);
                const C w1 = __shfl_sync(0xffffffffu, wj, two ? i + 1 : i);
                VT r0[U], r1[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int x = x0 + (u * 32 + lane) * V;
                    if (x < mn) {
                        r0[u] = __ldg(reinterpret_cast<const VT*>(A0 + x));
                        if (two)
                            r1[u] = __ldg(reinterpret_cast<const VT*>(A1 + x));
                    }
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int x = x0 + (u * 32 + lane) * V;
                    if (x < mn) {
                        const T* a0 = reinterpret_cast<const T*>(&r0[u]);
                        const T* a1 = reinterpret_cast<const T*>(&r1[u]);
#pragma unroll
                        for (int v = 0; v < V; ++v) {
                            acc[u][v] += static_cast<T>(
                                w0 * static_cast<C>(a0[v]));
                            if (two)
                                acc[u][v] += static_cast<T>(
                                    w1 * static_cast<C>(a1[v]));
                        }
                    }
                }
            }
        } else {
            for (int i = 0; i < cnt; ++i) {
                const T* A = shfl_ptr(Aj, i);
                const T* B = shfl_ptr(Bj, i);
                const int k = __shfl_sync(0xffffffffu, kj, i);
#pragma unroll
                for (int u = 0; u < U; ++u)
#pragma unroll
                    for (int v = 0; v < V; ++v) {
                        const int x = x0 + (u * 32 + lane) * V + v;
                        if (x >= mn) continue;
                        const int r = x / n, c = x % n;
                        const T* Ar = A + static_cast<size_t>(r) * k;
                        C s = C(0);
                        for (int kk = 0; kk < k; ++kk)
                            s += static_cast<C>(__ldg(Ar + kk))
                                 * static_cast<C>(__ldg(B + kk * n + c));
                        acc[u][v] += static_cast<T>(s);
                    }
            }
        }
    }

    T* O = static_cast<T*>(p.o[so]) + static_cast<size_t>(row) * mn;
    const bool vec_out = mn % V == 0 && aligned16(O);
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int x = x0 + (u * 32 + lane) * V;
        if (vec_out) {
            if (x < mn) {
                VT raw;
                T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
                for (int v = 0; v < V; ++v) o[v] = acc[u][v];
                *reinterpret_cast<VT*>(O + x) = raw;
            }
        } else {
#pragma unroll
            for (int v = 0; v < V; ++v)
                if (x + v < mn) O[x + v] = acc[u][v];
        }
    }
}

// ------------------------------------------------------------ block class
// Stage rows [row0, row0 + R) x columns [col0, col0 + CC) of a row-major
// matrix g (row stride ld) into shared memory s (row stride S); rv rows and
// cv columns of the tile are valid, the rest is zero-filled.  With vec the
// copies are 16 bytes (ld, col0 and cv multiples of the vector width, g
// 16-byte aligned), else one element each.
template <typename T, int R, int CC>
__device__ __forceinline__ void stage_tile(T* s, int S, const T* g, int ld,
                                           int row0, int col0, int rv, int cv,
                                           bool vec, int lane) {
    constexpr int V = 16 / sizeof(T);
    if (vec) {
        constexpr int PER_ROW = CC / V;
        for (int i = lane; i < R * PER_ROW; i += 32) {
            const int r = i / PER_ROW, c = (i % PER_ROW) * V;
            const bool ok = r < rv && c < cv;
            const T* src = ok ? g + static_cast<size_t>(row0 + r) * ld
                                    + col0 + c
                              : g;
            ptx::cp_async_zfill<16>(s + r * S + c, src, ok);
        }
    } else {
        for (int i = lane; i < R * CC; i += 32) {
            const int r = i / CC, c = i % CC;
            const bool ok = r < rv && c < cv;
            const T* src = ok ? g + static_cast<size_t>(row0 + r) * ld
                                    + col0 + c
                              : g;
            ptx::cp_async_zfill<sizeof(T)>(s + r * S + c, src, ok);
        }
    }
}

// acc[i][j][v] is D[8 i + lane / 4][8 j + 2 (lane % 4) + v] of the warp
// tile, the accumulator layout of mma m8n8k4 (also used by the FFMA path).
template <typename T, typename C, int WM, int WN>
__device__ __forceinline__ void multiply_chunk(const T* As, const T* Bs,
                                               C (&acc)[WM / 8][WN / 8][2],
                                               int lane) {
    constexpr int SB = WN + 4;
    const int r = lane / 4, q = lane % 4;
    if constexpr (sizeof(T) == 8 && sizeof(C) == 8) {
#pragma unroll
        for (int kk = 0; kk < KC; kk += 4) {
            double af[WM / 8], bf[WN / 8];
#pragma unroll
            for (int i = 0; i < WM / 8; ++i)
                af[i] = As[(8 * i + r) * SA + kk + q];
#pragma unroll
            for (int j = 0; j < WN / 8; ++j)
                bf[j] = Bs[(kk + q) * SB + 8 * j + r];
#pragma unroll
            for (int i = 0; i < WM / 8; ++i)
#pragma unroll
                for (int j = 0; j < WN / 8; ++j)
                    ptx::mma_m8n8k4_f64(acc[i][j][0], acc[i][j][1], af[i],
                                        bf[j]);
        }
    } else {
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
            C af[WM / 8], bf[WN / 8][2];
#pragma unroll
            for (int i = 0; i < WM / 8; ++i)
                af[i] = static_cast<C>(As[(8 * i + r) * SA + kk]);
#pragma unroll
            for (int j = 0; j < WN / 8; ++j)
#pragma unroll
                for (int v = 0; v < 2; ++v)
                    bf[j][v] = static_cast<C>(Bs[kk * SB + 8 * j + 2 * q + v]);
#pragma unroll
            for (int i = 0; i < WM / 8; ++i)
#pragma unroll
                for (int j = 0; j < WN / 8; ++j)
#pragma unroll
                    for (int v = 0; v < 2; ++v)
                        acc[i][j][v] = madd(af[i], bf[j][v], acc[i][j][v]);
        }
    }
}

template <typename X, int WM, int WN>
__device__ __forceinline__ void zero(X (&acc)[WM / 8][WN / 8][2]) {
#pragma unroll
    for (int i = 0; i < WM / 8; ++i)
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) acc[i][j][0] = acc[i][j][1] = X(0);
}

// One warp computes the WM x WN tile at (r0, c0) of one output block.
template <typename T, typename C, int WM, int WN>
__device__ __forceinline__ void block_task(const Params& p, const int* tk,
                                           int lane, T* sbuf) {
    constexpr int V = 16 / sizeof(T);
    constexpr int SB = WN + 4;
    // products in C, summed over entries in T: a separate product
    // accumulator only when the two differ (the f32 matmul mode)
    constexpr bool SPLIT = !std::is_same<T, C>::value;
    const int so = tk[1], row = tk[2], r0 = tk[3], c0 = tk[4];
    const int e1 = tk[6];
    const int m = p.om[so], n = p.on[so];
    T acc[WM / 8][WN / 8][2];
    C part[WM / 8][WN / 8][2];
    zero<T, WM, WN>(acc);
    zero<C, WM, WN>(part);

    // producer cursor: entry t, chunk origin kc within its k
    int t = tk[5], kc = 0, k = 0;
    const T* A = nullptr;
    const T* B = nullptr;
    bool va = false, vb = false;
    int ends = 0;                       // bit s: stage s ends its entry
    auto open_entry = [&]() {
        const int* en = p.entries + static_cast<size_t>(t) * ENTRY_COLS;
        const int ab = __ldg(en), ablk = __ldg(en + 1);
        const int bb = __ldg(en + 2), bblk = __ldg(en + 3);
        k = __ldg(en + 4);
        A = static_cast<const T*>(p.a[ab])
            + static_cast<size_t>(ablk) * m * k;
        B = static_cast<const T*>(p.b[bb])
            + static_cast<size_t>(bblk) * k * n;
        va = k % V == 0 && aligned16(A);
        vb = n % V == 0 && aligned16(B);
    };
    auto load_chunk = [&](int stage) {  // stage the chunk under the cursor
        T* As = sbuf + stage * STAGE;
        T* Bs = As + MAX_W * SA;
        stage_tile<T, WM, KC>(As, SA, A, k, r0, kc, m - r0, k - kc, va, lane);
        stage_tile<T, KC, WN>(Bs, SB, B, n, kc, c0, k - kc, n - c0, vb, lane);
        kc += KC;
        ends &= ~(1 << stage);
        if (kc >= k) {
            ends |= 1 << stage;
            kc = 0;
            if (++t < e1) open_entry();
        }
    };

    bool have = t < e1;
    if (have) {
        open_entry();
        load_chunk(0);
    }
    ptx::cp_async_commit();
    int stage = 0;
    while (have) {
        const bool next = t < e1;
        if (next) load_chunk(stage ^ 1);  // the next chunk loads meanwhile
        ptx::cp_async_commit();
        ptx::cp_async_wait<1>();        // this stage's copies have landed
        __syncwarp();
        const T* As = sbuf + stage * STAGE;
        if constexpr (SPLIT) {
            multiply_chunk<T, C, WM, WN>(As, As + MAX_W * SA, part, lane);
            if (ends >> stage & 1) {
#pragma unroll
                for (int i = 0; i < WM / 8; ++i)
#pragma unroll
                    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
                        for (int v = 0; v < 2; ++v)
                            acc[i][j][v] += static_cast<T>(part[i][j][v]);
                zero<C, WM, WN>(part);
            }
        } else {
            multiply_chunk<T, T, WM, WN>(As, As + MAX_W * SA, acc, lane);
        }
        __syncwarp();                   // read before it is refilled
        stage ^= 1;
        have = next;
    }

    T* O = static_cast<T*>(p.o[so]) + static_cast<size_t>(row) * m * n;
    const int r = lane / 4, q = lane % 4;
#pragma unroll
    for (int i = 0; i < WM / 8; ++i) {
        const int gr = r0 + 8 * i + r;
        if (gr >= m) continue;
#pragma unroll
        for (int j = 0; j < WN / 8; ++j)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                const int gc = c0 + 8 * j + 2 * q + v;
                if (gc < n)
                    O[static_cast<size_t>(gr) * n + gc] = acc[i][j][v];
            }
    }
}

// ------------------------------------------------ complex128 (mode 3)
constexpr int ZWARPS = 2;                // warps (= tasks) per block
constexpr int ZTHREADS = 32 * ZWARPS;

// c + a * b
__device__ __forceinline__ double2 cmadd(double2 a, double2 b, double2 c) {
    c.x = fma(a.x, b.x, c.x);
    c.x = fma(-a.y, b.y, c.x);
    c.y = fma(a.x, b.y, c.y);
    c.y = fma(a.y, b.x, c.y);
    return c;
}

// thin_task on complex data: lane j owns elements x0 + 32 u + j of the
// row; each entry is a complex scaled vector add (k = n = 1) or a complex
// dot product of length k per element, summed per entry and then added.
__device__ __forceinline__ void thin_task_z(const Params& p, const int* tk,
                                            int lane) {
    constexpr int U = THIN_TILE / 32;
    const int so = __ldg(tk + 1), row = __ldg(tk + 2), x0 = __ldg(tk + 3);
    const int e0 = __ldg(tk + 5), e1 = __ldg(tk + 6);
    const int m = p.om[so], n = p.on[so];
    const int mn = m * n;
    double2 acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = make_double2(0., 0.);

    for (int base = e0; base < e1; base += 32) {
        const int cnt = min(32, e1 - base);
        const double2* Aj = nullptr;
        const double2* Bj = nullptr;
        int kj = 1;
        if (lane < cnt) {
            const int* en = p.entries
                + static_cast<size_t>(base + lane) * ENTRY_COLS;
            kj = __ldg(en + 4);
            Aj = static_cast<const double2*>(p.a[__ldg(en)])
                + static_cast<size_t>(__ldg(en + 1)) * m * kj;
            Bj = static_cast<const double2*>(p.b[__ldg(en + 2)])
                + static_cast<size_t>(__ldg(en + 3)) * kj * n;
        }
        for (int i = 0; i < cnt; ++i) {
            const double2* A = shfl_ptr(Aj, i);
            const double2* B = shfl_ptr(Bj, i);
            const int k = __shfl_sync(0xffffffffu, kj, i);
            if (k == 1 && n == 1) {
                const double2 w = __ldg(B);
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int x = x0 + u * 32 + lane;
                    if (x < mn) acc[u] = cmadd(w, __ldg(A + x), acc[u]);
                }
            } else {
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int x = x0 + u * 32 + lane;
                    if (x >= mn) continue;
                    const int r = x / n, c = x % n;
                    const double2* Ar = A + static_cast<size_t>(r) * k;
                    double2 s = make_double2(0., 0.);
                    for (int kk = 0; kk < k; ++kk)
                        s = cmadd(__ldg(Ar + kk), __ldg(B + kk * n + c), s);
                    acc[u].x += s.x;
                    acc[u].y += s.y;
                }
            }
        }
    }

    double2* O = static_cast<double2*>(p.o[so])
        + static_cast<size_t>(row) * mn;
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int x = x0 + u * 32 + lane;
        if (x < mn) O[x] = acc[u];
    }
}

// One staged complex chunk into the re and im accumulators: per k step of
// 4, the A and B fragments of multiply_chunk split into re and im, and four
// real products per fragment pair on the f64 tensor cores.
template <int WM, int WN>
__device__ __forceinline__ void multiply_chunk_z(
        const double2* As, const double2* Bs, double (&cr)[WM / 8][WN / 8][2],
        double (&ci)[WM / 8][WN / 8][2], int lane) {
    constexpr int SB = WN + 4;
    const int r = lane / 4, q = lane % 4;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
        double ar[WM / 8], ai[WM / 8], nai[WM / 8], br[WN / 8], bi[WN / 8];
#pragma unroll
        for (int i = 0; i < WM / 8; ++i) {
            const double2 a = As[(8 * i + r) * SA + kk + q];
            ar[i] = a.x;
            ai[i] = a.y;
            nai[i] = -a.y;
        }
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) {
            const double2 b = Bs[(kk + q) * SB + 8 * j + r];
            br[j] = b.x;
            bi[j] = b.y;
        }
#pragma unroll
        for (int i = 0; i < WM / 8; ++i)
#pragma unroll
            for (int j = 0; j < WN / 8; ++j) {
                ptx::mma_m8n8k4_f64(cr[i][j][0], cr[i][j][1], ar[i], br[j]);
                ptx::mma_m8n8k4_f64(cr[i][j][0], cr[i][j][1], nai[i], bi[j]);
                ptx::mma_m8n8k4_f64(ci[i][j][0], ci[i][j][1], ar[i], bi[j]);
                ptx::mma_m8n8k4_f64(ci[i][j][0], ci[i][j][1], ai[i], br[j]);
            }
    }
}

// block_task on complex data: the same cursor over the row's entries and
// the same double-buffered cp.async staging (one element per 16-byte copy),
// with multiply_chunk_z in place of multiply_chunk.
template <int WM, int WN>
__device__ __forceinline__ void block_task_z(const Params& p, const int* tk,
                                             int lane, double2* sbuf) {
    constexpr int SB = WN + 4;
    const int so = tk[1], row = tk[2], r0 = tk[3], c0 = tk[4];
    const int e1 = tk[6];
    const int m = p.om[so], n = p.on[so];
    double cr[WM / 8][WN / 8][2], ci[WM / 8][WN / 8][2];
    zero<double, WM, WN>(cr);
    zero<double, WM, WN>(ci);

    int t = tk[5], kc = 0, k = 0;
    const double2* A = nullptr;
    const double2* B = nullptr;
    bool va = false, vb = false;
    auto open_entry = [&]() {
        const int* en = p.entries + static_cast<size_t>(t) * ENTRY_COLS;
        const int ab = __ldg(en), ablk = __ldg(en + 1);
        const int bb = __ldg(en + 2), bblk = __ldg(en + 3);
        k = __ldg(en + 4);
        A = static_cast<const double2*>(p.a[ab])
            + static_cast<size_t>(ablk) * m * k;
        B = static_cast<const double2*>(p.b[bb])
            + static_cast<size_t>(bblk) * k * n;
        va = aligned16(A);
        vb = aligned16(B);
    };
    auto load_chunk = [&](int stage) {
        double2* As = sbuf + stage * STAGE;
        double2* Bs = As + MAX_W * SA;
        stage_tile<double2, WM, KC>(As, SA, A, k, r0, kc, m - r0, k - kc, va,
                                    lane);
        stage_tile<double2, KC, WN>(Bs, SB, B, n, kc, c0, k - kc, n - c0, vb,
                                    lane);
        kc += KC;
        if (kc >= k) {
            kc = 0;
            if (++t < e1) open_entry();
        }
    };

    bool have = t < e1;
    if (have) {
        open_entry();
        load_chunk(0);
    }
    ptx::cp_async_commit();
    int stage = 0;
    while (have) {
        const bool next = t < e1;
        if (next) load_chunk(stage ^ 1);
        ptx::cp_async_commit();
        ptx::cp_async_wait<1>();
        __syncwarp();
        const double2* As = sbuf + stage * STAGE;
        multiply_chunk_z<WM, WN>(As, As + MAX_W * SA, cr, ci, lane);
        __syncwarp();
        stage ^= 1;
        have = next;
    }

    double2* O = static_cast<double2*>(p.o[so])
        + static_cast<size_t>(row) * m * n;
    const int r = lane / 4, q = lane % 4;
#pragma unroll
    for (int i = 0; i < WM / 8; ++i) {
        const int gr = r0 + 8 * i + r;
        if (gr >= m) continue;
#pragma unroll
        for (int j = 0; j < WN / 8; ++j)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                const int gc = c0 + 8 * j + 2 * q + v;
                if (gc < n)
                    O[static_cast<size_t>(gr) * n + gc] =
                        make_double2(cr[i][j][v], ci[i][j][v]);
            }
    }
}

__global__ void __launch_bounds__(THIN_THREADS, 2)
thin_kernel_z(const __grid_constant__ Params p) {
    const int task = blockIdx.x * THIN_WARPS + threadIdx.x / 32;
    if (task >= p.n_tasks) return;
    thin_task_z(p, p.tasks + static_cast<size_t>(task) * TASK_COLS,
                threadIdx.x % 32);
}

__global__ void __launch_bounds__(ZTHREADS)
packed_contract_kernel_z(const __grid_constant__ Params p) {
    __shared__ __align__(16) double2 smem[ZWARPS * 2 * STAGE];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int task = blockIdx.x * ZWARPS + warp;
    if (task >= p.n_tasks) return;
    const int* tk = p.tasks + static_cast<size_t>(task) * TASK_COLS;
    double2* sbuf = smem + warp * 2 * STAGE;
    switch (__ldg(tk)) {
        case 0: thin_task_z(p, tk, lane); break;
        case 1: block_task_z<8, 8>(p, tk, lane, sbuf); break;
        case 2: block_task_z<8, 16>(p, tk, lane, sbuf); break;
        case 3: block_task_z<8, 32>(p, tk, lane, sbuf); break;
        case 4: block_task_z<16, 8>(p, tk, lane, sbuf); break;
        case 5: block_task_z<16, 16>(p, tk, lane, sbuf); break;
        case 6: block_task_z<16, 32>(p, tk, lane, sbuf); break;
        case 7: block_task_z<32, 8>(p, tk, lane, sbuf); break;
        case 8: block_task_z<32, 16>(p, tk, lane, sbuf); break;
        case 9: block_task_z<32, 32>(p, tk, lane, sbuf); break;
        default: break;
    }
}

// Tables whose tasks are all thin: no shared memory, and registers for
// enough resident warps to keep loads in flight.
template <typename T, typename C>
__global__ void __launch_bounds__(THIN_THREADS, 2)
thin_kernel(const __grid_constant__ Params p) {
    const int task = blockIdx.x * THIN_WARPS + threadIdx.x / 32;
    if (task >= p.n_tasks) return;
    thin_task<T, C>(p, p.tasks + static_cast<size_t>(task) * TASK_COLS,
                    threadIdx.x % 32);
}

// Any tables.  Class 0: thin; 1 + 3 * log2(WM / 8) + log2(WN / 8): block
// WM x WN.
template <typename T, typename C>
__global__ void __launch_bounds__(THREADS)
packed_contract_kernel(const __grid_constant__ Params p) {
    __shared__ __align__(16) T smem[WARPS * 2 * STAGE];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int task = blockIdx.x * WARPS + warp;
    if (task >= p.n_tasks) return;
    const int* tk = p.tasks + static_cast<size_t>(task) * TASK_COLS;
    T* sbuf = smem + warp * 2 * STAGE;
    switch (__ldg(tk)) {
        case 0: thin_task<T, C>(p, tk, lane); break;
        case 1: block_task<T, C, 8, 8>(p, tk, lane, sbuf); break;
        case 2: block_task<T, C, 8, 16>(p, tk, lane, sbuf); break;
        case 3: block_task<T, C, 8, 32>(p, tk, lane, sbuf); break;
        case 4: block_task<T, C, 16, 8>(p, tk, lane, sbuf); break;
        case 5: block_task<T, C, 16, 16>(p, tk, lane, sbuf); break;
        case 6: block_task<T, C, 16, 32>(p, tk, lane, sbuf); break;
        case 7: block_task<T, C, 32, 8>(p, tk, lane, sbuf); break;
        case 8: block_task<T, C, 32, 16>(p, tk, lane, sbuf); break;
        case 9: block_task<T, C, 32, 32>(p, tk, lane, sbuf); break;
        default: break;
    }
}

Params make_params(const long long* ptrs, const int* dims, int na, int nb,
                   int no, const void* tasks, const void* entries,
                   int n_tasks) {
    Params p = {};
    for (int i = 0; i < na; ++i)
        p.a[i] = reinterpret_cast<const void*>(ptrs[i]);
    for (int i = 0; i < nb; ++i)
        p.b[i] = reinterpret_cast<const void*>(ptrs[MAX_BUCKETS + i]);
    for (int i = 0; i < no; ++i) {
        p.o[i] = reinterpret_cast<void*>(ptrs[2 * MAX_BUCKETS + i]);
        p.om[i] = dims[2 * i];
        p.on[i] = dims[2 * i + 1];
    }
    p.tasks = static_cast<const int*>(tasks);
    p.entries = static_cast<const int*>(entries);
    p.n_tasks = n_tasks;
    return p;
}

template <typename T, typename C>
int launch(bool thin, const long long* ptrs, const int* dims, int na, int nb,
           int no, const void* tasks, const void* entries, int n_tasks,
           void* stream) {
    const Params p = make_params(ptrs, dims, na, nb, no, tasks, entries,
                                 n_tasks);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (thin)
        thin_kernel<T, C><<<(n_tasks + THIN_WARPS - 1) / THIN_WARPS,
                            THIN_THREADS, 0, s>>>(p);
    else
        packed_contract_kernel<T, C><<<(n_tasks + WARPS - 1) / WARPS,
                                       THREADS, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
}

int launch_complex(bool thin, const long long* ptrs, const int* dims, int na,
                   int nb, int no, const void* tasks, const void* entries,
                   int n_tasks, void* stream) {
    const Params p = make_params(ptrs, dims, na, nb, no, tasks, entries,
                                 n_tasks);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (thin)
        thin_kernel_z<<<(n_tasks + THIN_WARPS - 1) / THIN_WARPS,
                        THIN_THREADS, 0, s>>>(p);
    else
        packed_contract_kernel_z<<<(n_tasks + ZWARPS - 1) / ZWARPS,
                                   ZTHREADS, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int packed_contract_max_buckets() { return MAX_BUCKETS; }

int packed_contract_thin_tile() { return THIN_TILE; }

// mode 0: f64 data, f64 sums (tensor cores); 1: f32 data, f32 sums;
// 2: f64 data, f32 sums (the f32 matmul mode), f64 output; 3: complex128
// data and sums (interleaved re/im, tensor cores).  thin: every
// task is of the thin class (the host knows each output bucket's class), so
// the thin kernel runs; else the kernel for any tables.
// ptrs: 3 * MAX_BUCKETS device addresses (a, b, out); dims: (m, n) per
// output bucket.  Returns a cudaError_t code (0 on success).
int packed_contract(int mode, int thin, const long long* ptrs,
                    const int* dims, int na, int nb, int no,
                    const void* tasks, const void* entries, int n_tasks,
                    void* stream) {
    if (na > MAX_BUCKETS || nb > MAX_BUCKETS || no > MAX_BUCKETS)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_tasks <= 0) return 0;
    switch (mode) {
        case 0: return launch<double, double>(thin, ptrs, dims, na, nb, no,
                                              tasks, entries, n_tasks, stream);
        case 1: return launch<float, float>(thin, ptrs, dims, na, nb, no,
                                            tasks, entries, n_tasks, stream);
        case 2: return launch<double, float>(thin, ptrs, dims, na, nb, no,
                                             tasks, entries, n_tasks, stream);
        case 3: return launch_complex(thin, ptrs, dims, na, nb, no, tasks,
                                      entries, n_tasks, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

const char* packed_contract_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
