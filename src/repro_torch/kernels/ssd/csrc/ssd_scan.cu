// Mamba2 SSD chunk scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel kernels/ssd/kernel.py::ssd_scan (body
// _ssd_body) of the JAX package, and also returns the final state, which the
// Pallas kernel keeps only in VMEM scratch and a prefill needs for decode.
// Per chunk of Q steps, with the state h [P, N] carried in f32 from h = 0:
//   a = dt * A, Sa = inclusive cumsum(a)
//   y = (C B^T . [i >= j] exp(Sa_i - Sa_j) . dt_j) @ x + exp(Sa) (C h^T) + D x
//   h <- exp(Sa_Q) h + sum_j exp(Sa_Q - Sa_j) dt_j x_j^T B_j
// All arithmetic is f32; y is rounded once to x's dtype.
//
// Layouts, read in place through strides (no transpose to the Pallas
// kernel's [B, H, S, P] layout): x [B, S, H, P] with its head and p axes
// contiguous; dt [B, S, H] f32 (head axis contiguous); Bm/Cm [B, S, G, N]
// with the group and n axes contiguous; A, D [H] f32.  y is a contiguous
// [B, S, H, P] in x's dtype, h_final a contiguous [B, H, P, N] f32.  Head h
// reads group h / (H / G) of B and C, so groups are never repeated in memory.
// Loads are element by element, so any element-aligned start is taken.
//
// What bounds it at the serving slice's shape (B 1, S 1024, H 48, P 64, G 1,
// N 128, Q 128, bf16): x and y at 6.29 MB each, B and C at 0.26 MB each, dt
// at 0.20 MB and h_final at 1.57 MB are 14.88 MB, 4.4 us at 3.35 TB/s.  The
// products the algorithm needs are C B^T (lower triangle, once per group and
// chunk), M x (lower triangle), C h^T and x^T (B . decay), per head and
// chunk: 2.03 GFLOP, 2.1 us on the bf16 tensor cores (989 TFLOP/s) and 30 us
// on the CUDA cores in f32 (67 TFLOP/s).  So with f32 products, as here,
// the kernel is bound by its operations, and at best some 7x from the bytes.
//
// What this design does about it.  The TPU grid (B, H, chunks) runs its
// chunk axis in order and carries h in scratch; Hopper blocks run in no order.
// Row p of h and column p of y depend on column p of x only, so one block
// per (b, h, tile of PT columns of P) loops over the chunks itself with no
// communication between blocks: 96 blocks at the slice shape (PT = 32).  One
// chunk's B and C (f32), its M = C B^T . L . dt [Q, Q] and x tile, and h^T
// [N, PT] live in shared memory (up to 227 KB, one block per SM).  Each
// product is tiled in registers (8 x 8 for C B^T, 4 x 4 for M x, C h^T and
// the state update), so a thread reads shared memory about once for every
// two FMAs.  The price of the column split is that every block recomputes
// C B^T for its head (P / PT times per head and H / G times per group).
//
// Still to come for speed: C B^T once per group, the products on the tensor
// cores (bf16 mma / wgmma: the bf16 x bf16 products are exact in f32), and
// TMA loads of the next chunk behind the current one's products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int MAXQ = 128;      // largest chunk
constexpr int MAXN = 128;      // largest state size
constexpr int SMEM_MAX = 232448;

typedef __nv_bfloat16 bf16_t;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_t v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16_t* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__host__ __device__ inline int round16(int q) { return (q + 15) / 16 * 16; }

// shared memory, in floats: B and C [Qpad][N + 1], M [Q][Q + 1], x [Q][PT],
// h^T [N][PT], Sa and dt [Q]; the odd row strides keep the column reads of
// B, C and M free of bank conflicts
__host__ __device__ inline size_t smem_floats(int Q, int N, int PT) {
  return 2 * (size_t)round16(Q) * (N + 1) + (size_t)Q * (Q + 1) +
         (size_t)Q * PT + (size_t)N * PT + 2 * (size_t)Q;
}

template <typename T, int PT>
__global__ void __launch_bounds__(NT, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dsk,
                T* __restrict__ y, float* __restrict__ h_final, int S, int H,
                int P, int G, int N, int Q, long long x_sb, long long x_ss,
                long long dt_sb, long long dt_ss, long long b_sb,
                long long b_ss, long long c_sb, long long c_ss) {
  // M x, C h^T: a thread owns rows ig + IG*k (k < RI) and columns
  // pg + PG*k (k < 4) of the chunk's y tile
  constexpr int PG = PT / 4;
  constexpr int IG = NT / PG;
  constexpr int RI = MAXQ / IG;
  // state update: columns pg + PG*k (k < 4) and rows ng + NG*m (m < RN) of h
  constexpr int NG = NT / PG;
  constexpr int RN = MAXN / NG;

  const int n_tiles = (P + PT - 1) / PT;
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H, b = bh / H;
  const int g = h / (H / G);
  const int p0 = tile * PT;
  const int tid = threadIdx.x;
  const int NP = N + 1, QP = Q + 1, Qpad = round16(Q);

  extern __shared__ float smem[];
  float* Bs = smem;
  float* Cs = Bs + (size_t)Qpad * NP;
  float* Ms = Cs + (size_t)Qpad * NP;
  float* xs = Ms + (size_t)Q * QP;
  float* hT = xs + Q * PT;
  float* Sa = hT + N * PT;
  float* dts = Sa + Q;

  const float Ah = A[h], Dh = Dsk[h];
  for (int e = tid; e < N * PT; e += NT) hT[e] = 0.f;
  // pad rows of B and C: read by the register tiles, never written out
  for (int e = Q * NP + tid; e < Qpad * NP; e += NT) Bs[e] = Cs[e] = 0.f;

  const T* xb = x + b * x_sb + (long long)h * P + p0;
  const float* dtb = dt + b * dt_sb + h;
  const T* Bb = Bm + b * b_sb + (long long)g * N;
  const T* Cb = Cm + b * c_sb + (long long)g * N;
  const long long y_ss = (long long)H * P;
  T* yb = y + (long long)b * S * y_ss + (long long)h * P + p0;

  const int pg = tid % PG;
  const int nc = S / Q;
  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * Q;
    __syncthreads();  // the previous chunk is done with shared memory
    for (int e = tid; e < Q * N; e += NT) {
      const int j = e / N, n = e - j * N;
      Bs[j * NP + n] = to_f32(Bb[(t0 + j) * b_ss + n]);
      Cs[j * NP + n] = to_f32(Cb[(t0 + j) * c_ss + n]);
    }
    for (int e = tid; e < Q * PT; e += NT) {
      const int j = e / PT, p = e - j * PT;
      xs[e] = p0 + p < P ? to_f32(xb[(t0 + j) * x_ss + p]) : 0.f;
    }
    for (int j = tid; j < Q; j += NT) dts[j] = dtb[(t0 + j) * dt_ss];
    __syncthreads();

    // Sa = inclusive cumsum(dt * A): each lane of warp 0 sums up to 4
    // consecutive steps, then the lanes' totals are scanned across the warp
    if (tid < 32) {
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
    __syncthreads();

    // M[i][j] = (C_i . B_j) exp(Sa_i - Sa_j) dt_j for j <= i, else 0;
    // thread (ty, tx) owns rows ty + 16r and columns tx + 16s
    {
      const int ty = tid / 16, tx = tid % 16;
      const int R = Qpad / 16;
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cr[8], br[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          cr[r] = r < R ? Cs[(ty + 16 * r) * NP + n] : 0.f;
          br[r] = r < R ? Bs[(tx + 16 * r) * NP + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(cr[r], br[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        if (r >= R || i >= Q) continue;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int j = tx + 16 * s;
          if (s >= R || j >= Q) continue;
          Ms[i * QP + j] =
              j <= i ? acc[r][s] * expf(Sa[i] - Sa[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = M x + exp(Sa) (C h^T) + D x for this block's columns
    {
      const int ig = tid / PG;
      int jmax = 0;  // M is zero right of the diagonal
#pragma unroll
      for (int k = 0; k < RI; ++k)
        if (ig + IG * k < Q) jmax = ig + IG * k + 1;
      float acc[RI][4], inter[RI][4];
#pragma unroll
      for (int k = 0; k < RI; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[k][l] = inter[k][l] = 0.f;
      for (int j = 0; j < jmax; ++j) {
        float xr[4], mr[RI];
#pragma unroll
        for (int l = 0; l < 4; ++l) xr[l] = xs[j * PT + pg + PG * l];
#pragma unroll
        for (int k = 0; k < RI; ++k) {
          const int i = ig + IG * k;
          mr[k] = i < Q ? Ms[i * QP + j] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < RI; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[k][l] = fmaf(mr[k], xr[l], acc[k][l]);
      }
      for (int n = 0; n < N; ++n) {
        float hr[4], cr[RI];
#pragma unroll
        for (int l = 0; l < 4; ++l) hr[l] = hT[n * PT + pg + PG * l];
#pragma unroll
        for (int k = 0; k < RI; ++k) {
          const int i = ig + IG * k;
          cr[k] = i < Q ? Cs[i * NP + n] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < RI; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l)
            inter[k][l] = fmaf(cr[k], hr[l], inter[k][l]);
      }
#pragma unroll
      for (int k = 0; k < RI; ++k) {
        const int i = ig + IG * k;
        if (i >= Q) continue;
        const float e = expf(Sa[i]);
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int p = pg + PG * l;
          if (p0 + p < P)
            put(yb + (t0 + i) * y_ss + p,
                acc[k][l] + e * inter[k][l] + Dh * xs[i * PT + p]);
        }
      }
    }
    __syncthreads();

    // x_j <- x_j exp(Sa_Q - Sa_j) dt_j, for the state update
    for (int e = tid; e < Q * PT; e += NT) {
      const int j = e / PT;
      xs[e] *= expf(Sa[Q - 1] - Sa[j]) * dts[j];
    }
    __syncthreads();

    // h^T[n][p] <- exp(Sa_Q) h^T[n][p] + sum_j B[j][n] x[j][p]
    {
      const int ng = tid / PG;
      const float decay = expf(Sa[Q - 1]);
      float acc[RN][4];
#pragma unroll
      for (int m = 0; m < RN; ++m)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int n = ng + NG * m;
          acc[m][l] = n < N ? decay * hT[n * PT + pg + PG * l] : 0.f;
        }
      for (int j = 0; j < Q; ++j) {
        float xr[4], br[RN];
#pragma unroll
        for (int l = 0; l < 4; ++l) xr[l] = xs[j * PT + pg + PG * l];
#pragma unroll
        for (int m = 0; m < RN; ++m) {
          const int n = ng + NG * m;
          br[m] = n < N ? Bs[j * NP + n] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < RN; ++m)
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[m][l] = fmaf(br[m], xr[l], acc[m][l]);
      }
      // each thread rewrites only the entries of h it read above
#pragma unroll
      for (int m = 0; m < RN; ++m) {
        const int n = ng + NG * m;
        if (n >= N) continue;
#pragma unroll
        for (int l = 0; l < 4; ++l) hT[n * PT + pg + PG * l] = acc[m][l];
      }
    }
  }
  __syncthreads();
  float* hb = h_final + ((long long)b * H + h) * P * N;
  for (int e = tid; e < PT * N; e += NT) {
    const int p = e / N, n = e - p * N;
    if (p0 + p < P) hb[(long long)(p0 + p) * N + n] = hT[n * PT + p];
  }
}

template <typename T, int PT>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* h_final, int B, int S,
           int H, int P, int G, int N, int Q, const long long* st,
           cudaStream_t stream) {
  const size_t smem = smem_floats(Q, N, PT) * sizeof(float);
  if (smem > (size_t)SMEM_MAX) return -1;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const long long blocks = (long long)B * H * ((P + PT - 1) / PT);
  if (blocks > 0x7fffffffLL) return -1;
  ssd_scan_kernel<T, PT><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(h_final), S, H, P, G, N, Q,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16; dt, A, D float32.
// strides (elements): x, dt, Bm, Cm over their batch and seq axes, in that
// order.  Returns cudaGetLastError() after the launch (0 on success), or -1
// for a shape or dtype it does not take.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* D, void* y,
                        void* h_final, int B, int S, int H, int P, int G, int N,
                        int Q, int dtype, long long x_sb, long long x_ss,
                        long long dt_sb, long long dt_ss, long long b_sb,
                        long long b_ss, long long c_sb, long long c_ss,
                        void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || H % G != 0 || N < 1 ||
      N > MAXN || Q < 1 || Q > MAXQ || S % Q != 0)
    return -1;
  const long long st[8] = {x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_ARGS x, dt, A, Bm, Cm, D, y, h_final, B, S, H, P, G, N, Q, st, s
  const bool wide = P % 32 == 0;
  if (dtype == 0)
    return wide ? launch<float, 32>(SSD_ARGS) : launch<float, 16>(SSD_ARGS);
  if (dtype == 1)
    return wide ? launch<bf16_t, 32>(SSD_ARGS) : launch<bf16_t, 16>(SSD_ARGS);
#undef SSD_ARGS
  return -1;
}
