// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel kernels/flash/kernel.py::flash_attention_bkg
// (body _flash_body) of the JAX package: GQA attention forward, causal and/or
// sliding window, online softmax (running max m, running sum l, f32
// accumulator), scale 1/sqrt(dh), output acc / max(l, 1e-30) cast to the
// input dtype.  Masks compare 0-based q and k indices with the same origin,
// as _flash_body does, also when Sq != Skv.
//
// Layout: q/o [B, Sq, H, dh], k/v [B, Skv, K, dh], contiguous, read in place
// (no transpose to the TPU kernel's [B*K*G, S, dh] layout).  Query head h
// reads kv head h / G (G = H / K), so K/V are never repeated in memory.
//
// What bounds it at the serving slice's shape (B=1, S=1024, H=K=16, dh=64,
// causal, bf16): q, k, v and o are 4 x 2,097,152 B = 8.39 MB, 2.50 us at
// 3.35 TB/s; the causal half is S(S+1)/2 = 524,800 (q, k) pairs per head at
// 4*dh = 256 operations each, 2.15 GFLOP over 16 heads, 2.17 us at the bf16
// tensor-core peak of 989 TFLOP/s.  So the function is balanced between
// memory and the tensor cores; a kernel that does its products on the CUDA
// cores in f32 (67 TFLOP/s peak, 32 us for this work) cannot come near it.
//
// What this design does about it.  Both paths use one CUDA block per
// (batch*head, 64-row q tile) and loop over 64-row kv tiles inside the block:
// the TPU grid's sequential kv axis becomes this loop, since blocks run in
// parallel and in no order.  m, l and the accumulator stay in registers in
// f32; scores never reach device memory, and each K/V tile is read once per
// q tile, so the traffic stays near the 8.39 MB floor.  Kv tiles that lie
// wholly above the causal diagonal or wholly before the window are skipped
// (the Pallas kernel computes and masks them; they only ever contribute
// corr = 0, so skipping gives the same numbers), the q tiles with the most
// kv tiles launch first, and the ragged edge is masked here, not padded in
// device memory.
//
// - bf16 (the serving path): 4 warps, 16 query rows each, products on the
//   tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).  Q stays
//   in registers as A fragments; S = Q K^T comes out in the accumulator
//   layout, which is already the A-fragment layout of P for P V, so P goes
//   from registers to the tensor cores without shared memory.  P is rounded
//   to bf16 for that product (the row sums l are taken in f32 before): on
//   the TPU, _flash_body's f32 P.V at default precision is one bf16 pass of
//   the MXU, which rounds P the same way; only its interpret mode on a CPU
//   keeps P in f32.  The scale goes onto the f32 scores after Q K^T, where
//   _flash_body puts it onto q in f32 before: the bf16 x bf16 products are
//   exact in f32, so the two orders differ by f32 rounding only, while
//   pre-scaling Q into bf16 would add a bf16 rounding of q for dh 32 and 128
//   (1/sqrt(dh) is a power of two only for dh 64).
// - f32: 256 threads, 4 per query row, f32 FMAs from shared memory, so the
//   result holds the f32 tolerance of the JAX kernel tests (1e-5), which
//   bf16 or TF32 products would not.
//
// Still to come for speed: wgmma, TMA loads in a ring of tiles, and warp
// specialisation, so that loads overlap the products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr float NEG_INF = -1e30f;

// which kv tiles [t_begin, t_end) a q tile starting at q0 can see: none above
// the causal diagonal, none wholly before the window
struct TileRange {
  int begin, end;
};

__device__ __forceinline__ TileRange tile_range(int q0, int Sq, int Skv,
                                                int causal, int window) {
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  return {k_begin / BKV, (k_end + BKV - 1) / BKV};
}

__device__ __forceinline__ bool visible(int qi, int kj, int Skv, int causal,
                                        int window) {
  bool ok = kj < Skv;
  if (causal) ok = ok && qi >= kj;
  if (window > 0) ok = ok && qi - kj < window;
  return ok;
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs from shared memory
// ---------------------------------------------------------------------------
constexpr int TPR = 4;        // threads per query row
constexpr int NT32 = BQ * TPR;  // 256 threads

template <int DH>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (size_t)(BQ * (DH + 1) + BKV * (DH + 1) + BKV * DH +
                                  BQ * (BKV + 1));
}

template <int DH>
__global__ void __launch_bounds__(NT32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Sq,
              int Skv, int H, int K, int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = DH + 1;      // padded row: no bank conflicts across rows
  constexpr int LDP = BKV + 1;
  constexpr int NS = BKV / TPR;   // scores per thread per tile
  constexpr int NA = DH / TPR;    // accumulator columns per thread
  float* sQ = smem;               // [BQ][LD], pre-scaled
  float* sK = sQ + BQ * LD;       // [BKV][LD]
  float* sV = sK + BKV * LD;      // [BKV][DH]
  float* sP = sV + BKV * DH;      // [BQ][LDP]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR, c = tid % TPR;

  const size_t qrow = (size_t)H * DH;  // element stride between positions
  const size_t krow = (size_t)K * DH;
  const float* qb = q + (size_t)b * Sq * qrow + (size_t)h * DH;
  const float* kb = k + (size_t)b * Skv * krow + (size_t)kh * DH;
  const float* vb = v + (size_t)b * Skv * krow + (size_t)kh * DH;
  float* ob = o + (size_t)b * Sq * qrow + (size_t)h * DH;

  for (int e = tid; e < BQ * DH; e += NT32) {
    const int row = e / DH, d = e % DH;
    const int qi = q0 + row;
    sQ[row * LD + d] = qi < Sq ? qb[(size_t)qi * qrow + d] * scale : 0.f;
  }

  const TileRange tr = tile_range(q0, Sq, Skv, causal, window);
  const int qi = q0 + r;
  float m = NEG_INF, l = 0.f;
  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.f;

  for (int t = tr.begin; t < tr.end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // sQ written / last tile's sK, sV, sP reads done
    for (int e = tid; e < BKV * DH; e += NT32) {
      const int row = e / DH, d = e % DH;
      const int kj = k0 + row;
      const bool in = kj < Skv;
      sK[row * LD + d] = in ? kb[(size_t)kj * krow + d] : 0.f;
      sV[row * DH + d] = in ? vb[(size_t)kj * krow + d] : 0.f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qv = sQ[r * LD + d];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = fmaf(qv, sK[(c + TPR * i) * LD + d], s[i]);
    }

    float mx = m;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kj = k0 + c + TPR * i;
      s[i] = qi < Sq && visible(qi, kj, Skv, causal, window) ? s[i] : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    // the TPR threads of a row are adjacent lanes
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = expf(s[i] - mx);
      psum += p;
      sP[r * LDP + c + TPR * i] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = mx;
    __syncthreads();  // the whole row of P is in shared memory

#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] *= corr;
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float p = sP[r * LDP + j];
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[a] = fmaf(p, sV[j * DH + c + TPR * a], acc[a]);
    }
  }

  if (qi < Sq) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int a = 0; a < NA; ++a) ob[(size_t)qi * qrow + c + TPR * a] = acc[a] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------
constexpr int NWARP = 4;            // 16 query rows each
constexpr int NT16 = NWARP * 32;    // 128 threads

typedef __nv_bfloat16 bf16_t;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values into one register, the first in the low half (lower column)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16_t lo, bf16_t hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of m16n8k16 (PTX ISA), lane = 4 * g + c:
//   A 16x16: a0 = A[g][2c..2c+1], a1 = A[g+8][2c..], a2 = A[g][2c+8..],
//            a3 = A[g+8][2c+8..]
//   B 16x8:  b0 = B[2c..2c+1][g], b1 = B[2c+8..2c+9][g]
//   C 16x8:  c0, c1 = C[g][2c..2c+1], c2, c3 = C[g+8][2c..2c+1]
template <int DH>
__global__ void __launch_bounds__(NT16)
flash_fwd_bf16(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
               const bf16_t* __restrict__ v, bf16_t* __restrict__ o, int Sq,
               int Skv, int H, int K, int causal, int window, float scale) {
  constexpr int LD = DH + 8;      // 16 B of padding: rows stay 16 B aligned
                                  // and fragment reads hit 32 distinct banks
  constexpr int CH = DH / 8;      // 16-byte chunks in a row
  constexpr int NKS = DH / 16;    // k-steps over dh for Q K^T
  constexpr int NNB = BKV / 8;    // n-blocks of 8 keys
  constexpr int NDB = DH / 8;     // n-blocks of 8 dims for P V
  __shared__ __align__(16) bf16_t sK[BKV * LD];  // holds the Q tile first
  __shared__ __align__(16) bf16_t sV[BKV * LD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;

  const size_t qrow = (size_t)H * DH;
  const size_t krow = (size_t)K * DH;
  const bf16_t* qb = q + (size_t)b * Sq * qrow + (size_t)h * DH;
  const bf16_t* kb = k + (size_t)b * Skv * krow + (size_t)kh * DH;
  const bf16_t* vb = v + (size_t)b * Skv * krow + (size_t)kh * DH;
  bf16_t* ob = o + (size_t)b * Sq * qrow + (size_t)h * DH;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q tile -> shared memory -> A fragments in registers
  for (int e = tid; e < BQ * CH; e += NT16) {
    const int row = e / CH, ch = e % CH;
    const int qi = q0 + row;
    *reinterpret_cast<uint4*>(&sK[row * LD + ch * 8]) =
        qi < Sq ? *reinterpret_cast<const uint4*>(qb + (size_t)qi * qrow + ch * 8)
                : zero;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[NKS][4];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const bf16_t* p0 = &sK[r0 * LD + ks * 16 + 2 * c];
    const bf16_t* p1 = p0 + 8 * LD;
    qa[ks][0] = ld32(p0);
    qa[ks][1] = ld32(p1);
    qa[ks][2] = ld32(p0 + 8);
    qa[ks][3] = ld32(p1 + 8);
  }

  const TileRange tr = tile_range(q0, Sq, Skv, causal, window);
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[NDB][4];
#pragma unroll
  for (int db = 0; db < NDB; ++db)
    acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

  for (int t = tr.begin; t < tr.end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // Q fragments / last tile's sK, sV reads done
    for (int e = tid; e < BKV * CH; e += NT16) {
      const int row = e / CH, ch = e % CH;
      const int kj = k0 + row;
      const bool in = kj < Skv;
      const size_t off = (size_t)kj * krow + ch * 8;
      *reinterpret_cast<uint4*>(&sK[row * LD + ch * 8]) =
          in ? *reinterpret_cast<const uint4*>(kb + off) : zero;
      *reinterpret_cast<uint4*>(&sV[row * LD + ch * 8]) =
          in ? *reinterpret_cast<const uint4*>(vb + off) : zero;
    }
    __syncthreads();

    // S = Q K^T: B[kdim][key] = K[key][kdim], so b0 is a contiguous pair
    float s[NNB][4];
#pragma unroll
    for (int nb = 0; nb < NNB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        const bf16_t* kp = &sK[(nb * 8 + g) * LD + ks * 16 + 2 * c];
        mma_bf16(s[nb], qa[ks], ld32(kp), ld32(kp + 8));
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nb = 0; nb < NNB; ++nb) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kj = k0 + nb * 8 + 2 * c + i;
        s[nb][i] = visible(qi0, kj, Skv, causal, window) ? s[nb][i] * scale : NEG_INF;
        s[nb][2 + i] =
            visible(qi1, kj, Skv, causal, window) ? s[nb][2 + i] * scale : NEG_INF;
        mx0 = fmaxf(mx0, s[nb][i]);
        mx1 = fmaxf(mx1, s[nb][2 + i]);
      }
    }
    // the 4 lanes that share a row differ in their two lowest bits
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int db = 0; db < NDB; ++db) {
      acc[db][0] *= corr0;
      acc[db][1] *= corr0;
      acc[db][2] *= corr1;
      acc[db][3] *= corr1;
    }

    // O += P V, 16 keys per k-step: P's A fragment is the C fragments of
    // key n-blocks 2j and 2j+1; B[key][dim] = V[key][dim], two rows apart
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      float p[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        p[h2][0] = expf(s[2 * j + h2][0] - m0);
        p[h2][1] = expf(s[2 * j + h2][1] - m0);
        p[h2][2] = expf(s[2 * j + h2][2] - m1);
        p[h2][3] = expf(s[2 * j + h2][3] - m1);
        l0 += p[h2][0] + p[h2][1];
        l1 += p[h2][2] + p[h2][3];
      }
      const uint32_t pa[4] = {pack_f32(p[0][0], p[0][1]), pack_f32(p[0][2], p[0][3]),
                              pack_f32(p[1][0], p[1][1]), pack_f32(p[1][2], p[1][3])};
#pragma unroll
      for (int db = 0; db < NDB; ++db) {
        const bf16_t* vp = &sV[(j * 16 + 2 * c) * LD + db * 8 + g];
        mma_bf16(acc[db], pa, pack_bf16(vp[0], vp[LD]),
                 pack_bf16(vp[8 * LD], vp[9 * LD]));
      }
    }
  }

  // each lane summed its own columns of l: add the row's 4 lanes
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int db = 0; db < NDB; ++db) {
    const int col = db * 8 + 2 * c;
    if (qi0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qi0 * qrow + col) =
          pack_f32(acc[db][0] / d0, acc[db][1] / d0);
    if (qi1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qi1 * qrow + col) =
          pack_f32(acc[db][2] / d1, acc[db][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int K, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_f32<DH>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_f32<DH><<<grid, NT32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, K,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int H, int K, int causal, int window,
                float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_bf16<DH><<<grid, NT16, 0, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<bf16_t*>(o), Sq, Skv, H, K,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Pointers must be 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// head dim / dtype / shape it does not take.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Skv, int H, int K, int dh, int dtype,
                         int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || K < 1 || H % K != 0 || B * H > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = (float)(1.0 / sqrt((double)dh));  // as 1/math.sqrt(dh)
#define FLASH_ARGS q, k, v, o, B, Sq, Skv, H, K, causal, window, scale, s
  if (dtype == 0) {
    switch (dh) {
      case 32: return launch_f32<32>(FLASH_ARGS);
      case 64: return launch_f32<64>(FLASH_ARGS);
      case 128: return launch_f32<128>(FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (dh) {
      case 32: return launch_bf16<32>(FLASH_ARGS);
      case 64: return launch_bf16<64>(FLASH_ARGS);
      case 128: return launch_bf16<128>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return -1;
}
