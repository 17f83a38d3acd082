// Mamba2 SSD chunk scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel kernels/ssd/kernel.py::ssd_scan (body
// _ssd_body) of the JAX package, and also returns the final state, which the
// Pallas kernel keeps only in VMEM scratch and a prefill needs for decode.
// Per chunk c of Q steps, with the state h [P, N] carried in f32 from h = 0:
//   a = dt * A, Sa = inclusive cumsum(a)
//   y = (C B^T . [i >= j] exp(Sa_i - Sa_j) . dt_j) @ x + exp(Sa) (C h^T) + D x
//   h <- exp(Sa_Q) h + s_c,  s_c = sum_j exp(Sa_Q - Sa_j) dt_j x_j^T B_j
// All sums are f32; y is rounded once to x's dtype.
//
// Layouts, read in place through strides (no transpose to the Pallas
// kernel's [B, H, S, P] layout): x [B, S, H, P] with its head and p axes
// contiguous; dt [B, S, H] f32 (head axis contiguous); Bm/Cm [B, S, G, N]
// with the group and n axes contiguous; A, D [H] f32.  y is a contiguous
// [B, S, H, P] in x's dtype, h_final a contiguous [B, H, P, N] f32.  Head h
// reads group h / (H / G) of B and C, so groups are never repeated in memory.
// Rows that start 16-byte aligned (the serving path's views do) are read
// 16 B per load, others element by element, so any element-aligned start
// is taken.
//
// What bounds it at the serving slice's shape (B 1, S 1024, H 48, P 64, G 1,
// N 128, Q 128, bf16): x and y at 6.29 MB each, B and C at 0.26 MB each, dt
// at 0.20 MB and h_final at 1.57 MB are 14.88 MB, 4.4 us at 3.35 TB/s.  The
// products the algorithm needs are C B^T (lower triangle, once per group and
// chunk), M x (lower triangle), C h^T and x^T (B . decay), per head and
// chunk: 2.03 GFLOP, 2.1 us on the bf16 tensor cores (989 TFLOP/s).  So the
// function is bound by its bytes.  Between the passes below, the chunk
// states (12.6 MB of f32 at the slice shape) go through device memory twice
// more, mostly from L2; that is the price of taking the chunk axis out of
// the critical path.
//
// What this design does about it.  The TPU grid (B, H, chunks) runs its
// chunk axis in order and carries h in scratch; Hopper blocks run in no
// order, and one block per (b, h) walking its chunks leaves most of the 132
// SMs idle (96 blocks at the slice shape).  So the scan is split into the
// chunk-parallel passes of ssd_chunked's own algebra, three launches on the
// caller's stream:
//   1. states (one block per (b, chunk, head, 64-column tile of P)): Sa, the
//      chunk's log-decay Sa_Q, and its own state contribution s_c [P, N];
//      plus one block per (b, chunk, group) that computes C B^T [Q, Q] once
//      for every head of the group.  384 + 8 blocks at the slice shape.
//   2. pass (one thread per element of [B, H, P, N]): the only sequential
//      walk, h_c = exp(Sa_Q^c) h_{c-1} + s_c elementwise in f32; it leaves
//      the state entering each chunk where s_c was, and writes h_final.
//   3. outputs (one block per (b, chunk, head, 64-column tile of P)):
//      y = M x + exp(Sa) (C h_{c-1}^T) + D x, with M = C B^T . L . dt built
//      in shared memory from pass 1's C B^T.  384 blocks at the slice shape.
// The workspace (chunk states, C B^T, log-decays) is allocated by the
// caller: ssd_scan_workspace_bytes gives its size.
//
// Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), with fragments from shared memory by ldmatrix (rows padded by
// 16 B against bank conflicts).  bf16 x bf16 products are exact in f32, so
// C B^T of bf16 inputs is exact; an f32 operand (M, the carried state,
// x . decay . dt, and in the f32 path x, B and C too) is split into a bf16
// high part and a bf16 low part, hi = bf16(v), lo = bf16(v - hi), which
// represents v to about 2^-17 of its size, and its product is the sum of
// the hi and lo products (for two split operands hi.hi + lo.hi + hi.lo; the
// lo.lo term is below 2^-17).  One bf16 rounding (2^-9) of those operands
// would not hold the final state to 1e-4 of its size.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block: 8 warps
constexpr int NWARPS = NT / 32;
constexpr int MAXQ = 128;      // largest chunk
constexpr int MAXN = 128;      // largest state size
constexpr int PT = 64;         // columns of P per block
constexpr int SMEM_MAX = 232448;

typedef __nv_bfloat16 bf16_t;

template <typename T>
struct Io;
template <>
struct Io<float> {
  static constexpr bool F32 = true;  // operands need a low part too
  __device__ static float get(float v) { return v; }
  __device__ static void put(float* p, float v) { *p = v; }
};
template <>
struct Io<bf16_t> {
  static constexpr bool F32 = false;
  __device__ static float get(bf16_t v) { return __bfloat162float(v); }
  __device__ static void put(bf16_t* p, float v) {
    *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
  }
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// v = hi + lo to about 2^-17 of |v|
__device__ __forceinline__ void split(float v, bf16_t* hi, bf16_t* lo) {
  const bf16_t h = __float2bfloat16(v);
  *hi = h;
  *lo = __float2bfloat16(v - __bfloat162float(h));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[16 x 8*nnb] += A[m0.., 0..kend) @ B[0..kend), n0..) for one warp, from
// bf16 tiles in shared memory.  A is stored A[m][k] (lda), or At[k][m] with
// AT; B is stored Bt[n][k] (ldb), or B[k][n] with BT.  kend is a multiple of
// 16, nnb of 2 and at most 8.  ldmatrix lane l gives the row address of
// matrix l / 8; in the mma fragment layout (lane = 4g + c) matrix i is
//   A: a0 rows 0-7 k 0-7, a1 rows 8-15 k 0-7, a2 rows 0-7 k 8-15, a3 rows
//      8-15 k 8-15 (the transposed load of At's 8x8 blocks gives the same)
//   B: b0 k 0-7, b1 k 8-15 of n-block nb, then the same of nb + 1.
template <bool AT, bool BT>
__device__ __forceinline__ void mma_tile(float (&acc)[8][4], const bf16_t* A,
                                         int lda, const bf16_t* B, int ldb,
                                         int m0, int n0, int nnb, int kend) {
  const int lane = threadIdx.x % 32;
  const int lm = lane / 8, lr = lane % 8;
  for (int k0 = 0; k0 < kend; k0 += 16) {
    uint32_t a[4];
    if (AT)
      ldsm_x4_trans(a, &A[(k0 + (lm >> 1) * 8 + lr) * lda + m0 + (lm & 1) * 8]);
    else
      ldsm_x4(a, &A[(m0 + (lm & 1) * 8 + lr) * lda + k0 + (lm >> 1) * 8]);
#pragma unroll
    for (int nb = 0; nb < 8; nb += 2) {
      if (nb < nnb) {
        uint32_t b[4];
        if (BT)
          ldsm_x4_trans(b, &B[(k0 + (lm & 1) * 8 + lr) * ldb + n0 +
                              (nb + (lm >> 1)) * 8]);
        else
          ldsm_x4(b, &B[(n0 + (nb + (lm >> 1)) * 8 + lr) * ldb + k0 +
                        (lm & 1) * 8]);
        mma_bf16(acc[nb], a, b[0], b[1]);
        mma_bf16(acc[nb + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc += A @ B with A and B split into high and low bf16 parts; a null low
// part is an operand that bf16 holds exactly
template <bool AT, bool BT>
__device__ __forceinline__ void mma_split(float (&acc)[8][4], const bf16_t* Ah,
                                          const bf16_t* Al, int lda,
                                          const bf16_t* Bh, const bf16_t* Bl,
                                          int ldb, int m0, int n0, int nnb,
                                          int kend) {
  mma_tile<AT, BT>(acc, Ah, lda, Bh, ldb, m0, n0, nnb, kend);
  if (Al) mma_tile<AT, BT>(acc, Al, lda, Bh, ldb, m0, n0, nnb, kend);
  if (Bl) mma_tile<AT, BT>(acc, Ah, lda, Bl, ldb, m0, n0, nnb, kend);
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Sa[j] = inclusive cumsum over the chunk of dt[j] * Ah, j < Q, by warp 0:
// each lane sums up to 4 consecutive steps, then the lanes' totals are
// scanned across the warp.  Reads dts[0..Q), writes Sa[0..Q).
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* Sa, int Q,
                                             float Ah) {
  const int tid = threadIdx.x;
  if (tid >= 32) return;
  const int per = (Q + 31) / 32;
  const int j0 = tid * per;
  float loc[MAXQ / 32];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < MAXQ / 32; ++k) {
    const int j = j0 + k;
    if (k < per && j < Q) s += dts[j] * Ah;
    loc[k] = s;
  }
  float inc = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, off);
    if (tid >= off) inc += v;
  }
  const float excl = inc - s;
#pragma unroll
  for (int k = 0; k < MAXQ / 32; ++k)
    if (k < per && j0 + k < Q) Sa[j0 + k] = excl + loc[k];
}

// st(r, col, v) for every element v of rows [0, R) x columns [0, C) of the
// row-major matrix at src (row stride ss elements), reading 0 outside rows
// [0, nr) and columns [0, ncols), and with LOWER right of the diagonal
// (16-byte vectors that start right of it).  Rows that start 16-byte aligned, with
// ncols and C multiples of a 16-byte vector, are read 16 B per load (the
// serving path's views are); anything else element by element.  Each
// thread issues several loads before it stores any result, so that their
// latency overlaps.
template <typename T, bool LOWER = false, class St>
__device__ __forceinline__ void load_rows(const T* src, long long ss, int nr,
                                          int ncols, int R, int C, St st) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = 4;                       // loads in flight per thread
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   ss % VEC == 0 && ncols % VEC == 0 && C % VEC == 0;
  if (vec) {
    const int CV = C / VEC, n = R * CV;
    for (int e0 = threadIdx.x; e0 < n; e0 += NT * U) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NT;
        const int r = e / CV, col = (e - r * CV) * VEC;
        raw[u] = e < n && r < nr && col < ncols && (!LOWER || col <= r)
                     ? *reinterpret_cast<const uint4*>(src + r * ss + col)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NT;
        if (e >= n) continue;
        const int r = e / CV, col = (e - r * CV) * VEC;
        const T* vals = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) st(r, col + k, Io<T>::get(vals[k]));
      }
    }
  } else {
    const int n = R * C;
    for (int e0 = threadIdx.x; e0 < n; e0 += NT * 2 * U) {
      float v[2 * U];
#pragma unroll
      for (int u = 0; u < 2 * U; ++u) {
        const int e = e0 + u * NT;
        const int r = e / C, col = e - r * C;
        v[u] = e < n && r < nr && col < ncols && (!LOWER || col <= r)
                   ? Io<T>::get(src[r * ss + col])
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 2 * U; ++u) {
        const int e = e0 + u * NT;
        if (e < n) st(e / C, e % C, v[u]);
      }
    }
  }
}

// rows [0, Qp) x columns [0, Np) of B or C for chunk t0 into hi (and lo
// for f32) with row stride ld; rows >= Q and columns >= N are zero
template <typename T>
__device__ __forceinline__ void load_bc(const T* src, long long ss, int t0,
                                        int Q, int N, int Qp, int Np, int ld,
                                        bf16_t* hi, bf16_t* lo) {
  load_rows<T>(src + t0 * ss, ss, Q, N, Qp, Np, [&](int j, int n, float v) {
    if (Io<T>::F32)
      split(v, &hi[j * ld + n], &lo[j * ld + n]);
    else
      hi[j * ld + n] = __float2bfloat16(v);  // exact: v came from bf16
  });
}

struct Dims {
  int S, H, P, G, N, Q, nc, ptiles;
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

// workspace, in floats: chunk states [B][nc][H][P][N], C B^T [B][nc][G][Q][Q],
// log-decays Sa_Q [B][nc][H]
struct Work {
  float* states;
  float* cb;
  float* ldec;
};

// shared memory of pass 1 and pass 3, in bytes
__host__ __device__ inline size_t smem_states(int Qp, int Np, bool f32) {
  const int parts = f32 ? 2 : 1;
  const size_t xw = 2 * (size_t)Qp * (PT + 8);            // x . w, hi and lo
  const size_t bm = (size_t)parts * Qp * (Np + 8);        // B
  const size_t cb = (size_t)2 * parts * Qp * (Np + 8);    // C and B
  return 3 * sizeof(float) * Qp + sizeof(bf16_t) * (xw + bm > cb ? xw + bm : cb);
}
__host__ __device__ inline size_t smem_outputs(int Qp, int Np, bool f32) {
  const int parts = f32 ? 2 : 1;
  return 2 * sizeof(float) * Qp +
         sizeof(bf16_t) * (2 * (size_t)Qp * (Qp + 8) +         // M
                           (size_t)parts * Qp * (PT + 8) +     // x
                           (size_t)parts * Qp * (Np + 8) +     // C
                           2 * (size_t)PT * (Np + 8));         // h_{c-1}
}

// ---------------------------------------------------------------------------
// pass 1: chunk states and C B^T
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_states(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, Work w, Dims d, int n_state_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = d.Q, N = d.N, P = d.P, H = d.H, G = d.G, nc = d.nc;
  const int Qp = round16(Q), Np = round16(N);
  const int LX = PT + 8, LN = Np + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, c4 = lane % 4;
  float* dts = reinterpret_cast<float*>(smem_raw);
  float* Sa = dts + Qp;
  float* wj = Sa + Qp;
  bf16_t* sm = reinterpret_cast<bf16_t*>(wj + Qp);
  constexpr bool F32 = Io<T>::F32;

  if ((int)blockIdx.x >= n_state_blocks) {
    // C B^T [Q, Q] of one (b, chunk, group); tiles wholly above the
    // diagonal are never read and not computed
    const int e = blockIdx.x - n_state_blocks;
    const int g = e % G, c = (e / G) % nc, b = e / (G * nc);
    const long long t0 = (long long)c * Q;
    bf16_t* sCh = sm;
    bf16_t* sCl = F32 ? sCh + Qp * LN : nullptr;
    bf16_t* sBh = sCh + (F32 ? 2 : 1) * Qp * LN;
    bf16_t* sBl = F32 ? sBh + Qp * LN : nullptr;
    load_bc<T>(Cm + b * d.c_sb + (long long)g * N, d.c_ss, t0, Q, N, Qp, Np,
               LN, sCh, sCl);
    load_bc<T>(Bm + b * d.b_sb + (long long)g * N, d.b_ss, t0, Q, N, Qp, Np,
               LN, sBh, sBl);
    __syncthreads();
    float* out = w.cb + (((long long)b * nc + c) * G + g) * Q * Q;
    const int ngroups = (Qp + 63) / 64;
    for (int tile = warp; tile < (Qp / 16) * ngroups; tile += NWARPS) {
      const int m0 = (tile / ngroups) * 16, n0 = (tile % ngroups) * 64;
      if (n0 > m0 + 15) continue;
      const int nnb = min(8, (Qp - n0) / 8);
      float acc[8][4];
      zero(acc);
      // CB[i][j] = sum_n C[i][n] B[j][n]: B's rows are Bt[j][n]
      mma_split<false, false>(acc, sCh, sCl, LN, sBh, sBl, LN, m0, n0, nnb, Np);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (nb >= nnb) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = m0 + g4 + 8 * r, j = n0 + nb * 8 + 2 * c4;
          if (i < Q && j < Q) out[(long long)i * Q + j] = acc[nb][2 * r];
          if (i < Q && j + 1 < Q) out[(long long)i * Q + j + 1] = acc[nb][2 * r + 1];
        }
      }
    }
    return;
  }

  // s_c [P-tile, N] of one (b, chunk, head, P-tile)
  const int pt = blockIdx.x % d.ptiles;
  const int h = (blockIdx.x / d.ptiles) % H;
  const int c = (blockIdx.x / (d.ptiles * H)) % nc;
  const int b = blockIdx.x / (d.ptiles * H * nc);
  const int g = h / (H / G);
  const int p0 = pt * PT;
  const long long t0 = (long long)c * Q;
  bf16_t* sXh = sm;
  bf16_t* sXl = sXh + Qp * LX;
  bf16_t* sBh = sXl + Qp * LX;
  bf16_t* sBl = F32 ? sBh + Qp * LN : nullptr;

  const float* dtb = dt + b * d.dt_sb + h;
  for (int j = threadIdx.x; j < Q; j += NT) dts[j] = dtb[(t0 + j) * d.dt_ss];
  __syncthreads();
  chunk_cumsum(dts, Sa, Q, A[h]);
  __syncthreads();
  for (int j = threadIdx.x; j < Qp; j += NT)
    wj[j] = j < Q ? expf(Sa[Q - 1] - Sa[j]) * dts[j] : 0.f;
  if (pt == 0 && threadIdx.x == 0)
    w.ldec[((long long)b * nc + c) * H + h] = Sa[Q - 1];
  __syncthreads();
  const T* xb = x + b * d.x_sb + t0 * d.x_ss + (long long)h * P + p0;
  load_rows<T>(xb, d.x_ss, Q, min(PT, P - p0), Qp, PT, [&](int j, int p, float v) {
    split(v * wj[j], &sXh[j * LX + p], &sXl[j * LX + p]);
  });
  load_bc<T>(Bm + b * d.b_sb + (long long)g * N, d.b_ss, t0, Q, N, Qp, Np, LN,
             sBh, sBl);
  __syncthreads();

  // s[p][n] = sum_j xw[j][p] B[j][n]: A is stored At[j][p], B as B[j][n]
  float* out = w.states + ((((long long)b * nc + c) * H + h) * P + p0) * N;
  const int ngroups = (Np + 63) / 64;
  for (int tile = warp; tile < (PT / 16) * ngroups; tile += NWARPS) {
    const int m0 = (tile / ngroups) * 16, n0 = (tile % ngroups) * 64;
    if (p0 + m0 >= P) continue;
    const int nnb = min(8, (Np - n0) / 8);
    float acc[8][4];
    zero(acc);
    mma_split<true, true>(acc, sXh, sXl, LX, sBh, sBl, LN, m0, n0, nnb, Qp);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      if (nb >= nnb) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = m0 + g4 + 8 * r, n = n0 + nb * 8 + 2 * c4;
        if (p0 + p >= P) continue;
        if (n < N) out[(long long)p * N + n] = acc[nb][2 * r];
        if (n + 1 < N) out[(long long)p * N + n + 1] = acc[nb][2 * r + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: the walk over chunks, one thread per state element
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
ssd_pass(Work w, float* __restrict__ h_final, int B, int H, int P, int N,
         int nc) {
  const long long per_b = (long long)H * P * N;
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  if (e >= B * per_b) return;
  const int b = (int)(e / per_b);
  const long long r = e - b * per_b;        // (h, p, n) within the batch row
  const int h = (int)(r / ((long long)P * N));
  float* slot = w.states + (long long)b * nc * per_b + r;
  const float* ldec = w.ldec + (long long)b * nc * H + h;
  constexpr int UNROLL = 8;
  float hv = 0.f;
  // UNROLL chunks' loads go out before their stores, so the walk waits on
  // device memory once per UNROLL chunks, not once per chunk
  for (int c0 = 0; c0 < nc; c0 += UNROLL) {
    float sv[UNROLL], dv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c0 + u < nc) {
        sv[u] = slot[(c0 + u) * per_b];
        dv[u] = ldec[(long long)(c0 + u) * H];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c0 + u < nc) {
        slot[(c0 + u) * per_b] = hv;         // the state entering chunk c
        hv = expf(dv[u]) * hv + sv[u];
      }
    }
  }
  h_final[e] = hv;
}

// ---------------------------------------------------------------------------
// pass 3: outputs
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_outputs(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Cm,
            const float* __restrict__ Dsk, T* __restrict__ y, Work w, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = d.Q, N = d.N, P = d.P, H = d.H, G = d.G, nc = d.nc;
  const int Qp = round16(Q), Np = round16(N);
  const int LX = PT + 8, LN = Np + 8, LQ = Qp + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, c4 = lane % 4;
  constexpr bool F32 = Io<T>::F32;

  const int pt = blockIdx.x % d.ptiles;
  const int h = (blockIdx.x / d.ptiles) % H;
  const int c = (blockIdx.x / (d.ptiles * H)) % nc;
  const int b = blockIdx.x / (d.ptiles * H * nc);
  const int g = h / (H / G);
  const int p0 = pt * PT;
  const long long t0 = (long long)c * Q;

  float* dts = reinterpret_cast<float*>(smem_raw);
  float* Sa = dts + Qp;
  bf16_t* sMh = reinterpret_cast<bf16_t*>(Sa + Qp);
  bf16_t* sMl = sMh + Qp * LQ;
  bf16_t* sXh = sMl + Qp * LQ;
  bf16_t* sXl = F32 ? sXh + Qp * LX : nullptr;
  bf16_t* sCh = sXh + (F32 ? 2 : 1) * Qp * LX;
  bf16_t* sCl = F32 ? sCh + Qp * LN : nullptr;
  bf16_t* sHh = sCh + (F32 ? 2 : 1) * Qp * LN;
  bf16_t* sHl = sHh + PT * LN;

  const float* dtb = dt + b * d.dt_sb + h;
  for (int j = threadIdx.x; j < Q; j += NT) dts[j] = dtb[(t0 + j) * d.dt_ss];
  __syncthreads();
  chunk_cumsum(dts, Sa, Q, A[h]);
  // x, C and the entering state do not need Sa
  const T* xb = x + b * d.x_sb + t0 * d.x_ss + (long long)h * P + p0;
  load_rows<T>(xb, d.x_ss, Q, min(PT, P - p0), Qp, PT, [&](int j, int p, float v) {
    if (F32)
      split(v, &sXh[j * LX + p], &sXl[j * LX + p]);
    else
      sXh[j * LX + p] = __float2bfloat16(v);
  });
  load_bc<T>(Cm + b * d.c_sb + (long long)g * N, d.c_ss, t0, Q, N, Qp, Np, LN,
             sCh, sCl);
  const float* hin = w.states + ((((long long)b * nc + c) * H + h) * P + p0) * N;
  if (c > 0)
    load_rows<float>(hin, N, min(PT, P - p0), N, PT, Np, [&](int p, int n, float v) {
      split(v, &sHh[p * LN + n], &sHl[p * LN + n]);
    });
  __syncthreads();  // Sa is ready
  // M[i][j] = CB[i][j] exp(Sa_i - Sa_j) dt_j for j <= i < Q, else 0
  const float* cb = w.cb + (((long long)b * nc + c) * G + g) * Q * Q;
  load_rows<float, true>(cb, Q, Q, Q, Qp, Qp, [&](int i, int j, float v) {
    split(j <= i ? v * expf(Sa[i] - Sa[j]) * dts[j] : 0.f, &sMh[i * LQ + j],
          &sMl[i * LQ + j]);
  });
  __syncthreads();

  // warp w owns rows [16w, 16w + 16) of the chunk and all PT columns
  const int m0 = warp * 16;
  if (m0 >= Qp) return;
  const int nnb = min(8, round16(min(PT, P - p0)) / 8);
  float intra[8][4], inter[8][4];
  zero(intra);
  zero(inter);
  // M is lower triangular: k-steps past this warp's rows are zero
  mma_split<false, true>(intra, sMh, sMl, LQ, sXh, sXl, LX, m0, 0, nnb,
                         min(Qp, m0 + 16));
  if (c > 0)  // C h^T: h's rows are Bt[p][n]
    mma_split<false, false>(inter, sCh, sCl, LN, sHh, sHl, LN, m0, 0, nnb, Np);
  const float Dh = Dsk[h];
  T* yb = y + ((long long)b * d.S + t0) * H * P + (long long)h * P + p0;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    if (nb >= nnb) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = m0 + g4 + 8 * r;
      if (i >= Q) continue;
      const float e = expf(Sa[i]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = nb * 8 + 2 * c4 + u;
        if (p0 + p >= P) continue;
        float xv = __bfloat162float(sXh[i * LX + p]);
        if (F32) xv += __bfloat162float(sXl[i * LX + p]);
        Io<T>::put(yb + (long long)i * H * P + p,
                   intra[nb][2 * r + u] + e * inter[nb][2 * r + u] + Dh * xv);
      }
    }
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)SMEM_MAX) return -1;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* h_final, void* work,
           int B, const Dims& d, cudaStream_t stream) {
  const int Qp = round16(d.Q), Np = round16(d.N);
  const bool f32 = Io<T>::F32;
  const size_t sm1 = smem_states(Qp, Np, f32), sm3 = smem_outputs(Qp, Np, f32);
  static bool attr_set = false;
  if (!attr_set) {
    int rc = allow_smem(ssd_states<T>, sm1);
    if (rc == 0) rc = allow_smem(ssd_outputs<T>, sm3);
    if (rc != 0) return rc;
    attr_set = true;
  }
  if (sm1 > (size_t)SMEM_MAX || sm3 > (size_t)SMEM_MAX) return -1;
  Work w;
  w.states = static_cast<float*>(work);
  w.cb = w.states + (long long)B * d.nc * d.H * d.P * d.N;
  w.ldec = w.cb + (long long)B * d.nc * d.G * d.Q * d.Q;
  const long long n_state = (long long)B * d.nc * d.H * d.ptiles;
  const long long n_cb = (long long)B * d.nc * d.G;
  const long long n_pass = ((long long)B * d.H * d.P * d.N + NT - 1) / NT;
  if (n_state + n_cb > 0x7fffffffLL || n_pass > 0x7fffffffLL) return -1;
  ssd_states<T><<<(unsigned)(n_state + n_cb), NT, sm1, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), w, d, (int)n_state);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_pass<<<(unsigned)n_pass, NT, 0, stream>>>(
      w, static_cast<float*>(h_final), B, d.H, d.P, d.N, d.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_outputs<T><<<(unsigned)n_state, NT, sm3, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Cm),
      static_cast<const float*>(D), static_cast<T*>(y), w, d);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int S, int H, int P, int G, int N, int Q) {
  return B >= 1 && S >= 1 && H >= 1 && P >= 1 && G >= 1 && H % G == 0 &&
         N >= 1 && N <= MAXN && Q >= 1 && Q <= MAXQ && S % Q == 0;
}

}  // namespace

// Bytes of f32 workspace ssd_scan needs for this shape (chunk states, C B^T,
// log-decays), or -1 for a shape it does not take.
extern "C" long long ssd_scan_workspace_bytes(int B, int S, int H, int P,
                                              int G, int N, int Q) {
  if (!shape_ok(B, S, H, P, G, N, Q)) return -1;
  const long long nc = S / Q;
  return 4LL * B * nc * ((long long)H * P * N + (long long)G * Q * Q + H);
}

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16; dt, A, D float32.
// strides (elements): x, dt, Bm, Cm over their batch and seq axes, in that
// order.  work: ssd_scan_workspace_bytes of device memory, 16-byte aligned,
// no contents needed.  Launches three kernels on `stream`.  Returns
// cudaGetLastError() after the launches (0 on success), or -1 for a shape or
// dtype it does not take.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* D, void* y,
                        void* h_final, int B, int S, int H, int P, int G, int N,
                        int Q, int dtype, long long x_sb, long long x_ss,
                        long long dt_sb, long long dt_ss, long long b_sb,
                        long long b_ss, long long c_sb, long long c_ss,
                        void* work, void* stream) {
  if (!shape_ok(B, S, H, P, G, N, Q)) return -1;
  Dims d;
  d.S = S; d.H = H; d.P = P; d.G = G; d.N = N; d.Q = Q;
  d.nc = S / Q;
  d.ptiles = (P + PT - 1) / PT;
  d.x_sb = x_sb; d.x_ss = x_ss; d.dt_sb = dt_sb; d.dt_ss = dt_ss;
  d.b_sb = b_sb; d.b_ss = b_ss; d.c_sb = c_sb; d.c_ss = c_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A, Bm, Cm, D, y, h_final, work, B, d, s);
  if (dtype == 1) return launch<bf16_t>(x, dt, A, Bm, Cm, D, y, h_final, work, B, d, s);
  return -1;
}
