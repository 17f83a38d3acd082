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
// memory and the tensor cores.  At this size neither rate sets the kernel's
// time, though: the whole grid fits on 132 SMs in one wave, so the kernel
// lasts as long as the SM that holds the last q tile, which walks all 16
// kv tiles of 64 one after another.  What bounds the kernel is that walk:
// the latency of one step (load a K/V tile, Q K^T, softmax, P V) times the
// steps in a row, and the issue rate of the one SM that runs them.
//
// What this design does about it.  Both paths use one CUDA block per
// (batch*head, q tile) and loop over 64-row kv tiles inside the block:
// the TPU grid's sequential kv axis becomes this loop, since blocks run in
// parallel and in no order.  m, l and the accumulator stay in registers in
// f32; scores never reach device memory, and each K/V tile is read once per
// q tile, so the traffic stays near the 8.39 MB floor.  Kv tiles that lie
// wholly above the causal diagonal or wholly before the window are skipped
// (the Pallas kernel computes and masks them; they only ever contribute
// corr = 0, so skipping gives the same numbers), where a block holds one q
// tile the q tiles with the most kv tiles launch first, and the ragged edge
// is masked here, not padded in device memory.
//
// - bf16 (the serving path), built to shorten the busiest SM's walk and
//   each step of it:
//   * A block holds two q tiles of 64 rows (dh <= 64), t and n - 1 - t, one
//     per 16-row m-tile of each warp.  Under a causal mask every block then
//     has the same kv work, t + 1 + n - t tiles, where one 128-row tile per
//     block gave the last block twice the mean.  A kv tile that only one
//     m-tile sees runs a step compiled for that m-tile alone.  (dh 80 and
//     128: one 64-row q tile per block, whose accumulator fills the
//     registers.)
//   * dh 80 (Zamba2's shared attention block) is no power of two: Q K^T
//     takes 5 k-steps of 16, the last one alone through an x2 ldmatrix, and
//     a row of K or V is 10 chunks of 16 B, which do not divide a group's
//     128 threads, so each thread copies 5 chunks whose rows it works out
//     one by one.  Rows of 88 bf16 (176 B) keep the 8 rows of an ldmatrix
//     phase in 8 distinct bank groups (176 / 16 = 11 is odd).
//   * dh 160 (StableLM-2-12B) is the widest: Q K^T takes 10 k-steps and
//     P V 20 n-blocks, so the accumulator alone is 80 floats a thread.  Its
//     Q fragments are loaded two k-steps at a time inside the Q K^T loop
//     (8 registers live, where the other head dims hold all NKS k-steps'),
//     and each group's ring has 2 stages, not 3: three would need 279,552 B
//     of shared memory, above the 232,448 B a block may have; two need
//     193,536 B.  A K/V row is 20 chunks of 16 B, copied 10 a thread as at
//     dh 80; rows of 168 bf16 (336 B, 21 bank groups) keep ldmatrix free of
//     conflicts.
//   * Two kv groups of 4 warps hold the same q rows and walk alternate kv
//     tiles, each with its own m, l and accumulator; at the end the second
//     group's partial results pass through shared memory and merge into the
//     first's with the usual rescaling.  Each walk is half as long, and 8
//     warps per SM hide each other's latencies.
//   * Each group's K and V tiles flow through its own ring of NSTAGE = 3
//     stages (2 at dh 160) in dynamic shared memory, filled by cp.async
//     (16 B a thread, no registers on the way, out-of-range rows
//     zero-filled): tiles i + 1 .. i + NSTAGE - 1 are in flight while tile
//     i's products run, and one group barrier per step both publishes tile
//     i and frees the stage of i - 1.
//   * Products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//     accumulate); every K and V fragment feeds both m-tiles.  Fragments
//     come from shared memory by ldmatrix: x4 for Q and K, x4.trans for V.
//     Q's are loaded again at each step rather than held, which keeps the
//     registers for the accumulators.  Rows are padded by 16 B, so the 8
//     rows of each ldmatrix phase fall in 8 distinct bank groups.  Each
//     lane's shared-memory addresses for ldmatrix and cp.async are worked
//     out once; a load then adds only a constant and the stage.
//   * S = Q K^T comes out in the accumulator layout, which is already the
//     A-fragment layout of P for P V, so P goes from registers to the tensor
//     cores without shared memory.  P is rounded to bf16 for that product
//     (the row sums l are taken in f32 before): on the TPU, _flash_body's
//     f32 P.V at default precision is one bf16 pass of the MXU, which rounds
//     P the same way; only its interpret mode on a CPU keeps P in f32.
//   * The softmax runs in the exp2 domain: m is the running row max of
//     s * scale * log2(e), and p = 2^(s * scale * log2(e) - m) is one FMA
//     and one ex2.approx (relative error about 2^-22).  _flash_body scales
//     q in f32 and takes exp; the two differ by f32 rounding only (the
//     bf16 x bf16 products are exact in f32), while pre-scaling Q into bf16
//     would add a bf16 rounding of q for dh 32 and 128 (1/sqrt(dh) is a
//     power of two only for dh 64).
//   * The mask is evaluated only on kv tiles that cross the kv edge, the
//     causal diagonal or the window edge for one of the warp's rows; the
//     other tiles skip it.
// - f32: 256 threads, 4 per query row, f32 FMAs from shared memory, so the
//   result holds the f32 tolerance of the JAX kernel tests (1e-5), which
//   bf16 or TF32 products would not.  Nothing on the serving path runs it.
//
// Still to come for speed: wgmma and TMA with warp specialisation, which
// would free the registers that the mma.sync fragments hold.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

__device__ __forceinline__ TileRange tile_range(int q0, int bq, int Sq, int Skv,
                                                int causal, int window) {
  const int q_last = min(q0 + bq, Sq) - 1;
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

  const TileRange tr = tile_range(q0, BQ, Sq, Skv, causal, window);
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
// bf16: tensor cores through mma.sync m16n8k16, K/V in a cp.async ring
// ---------------------------------------------------------------------------
constexpr int NWARP = 4;            // warps of one kv group
constexpr int NTG = NWARP * 32;     // threads of one kv group
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16_t;

// q rows come in tiles of QT = NWARP * 16 = 64; a block holds MT of them,
// one per 16-row m-tile of each warp (each K and V fragment then feeds MT
// products).  With MT = 2 a block pairs q tile t with q tile n - 1 - t, so
// that under a causal mask every block has the same work (t + 1 + n - t kv
// tiles of 64 rows) instead of the last block having twice the mean.  NKG
// kv groups of NWARP warps hold the same q rows and walk every NKG-th kv
// tile each, so each walk is NKG times shorter.
constexpr int QT = NWARP * 16;
template <int V>
struct IntC {
  static constexpr int value = V;
};
// NSTAGE K/V tiles in each group's ring; QSTREAM: Q's fragments are loaded
// two k-steps at a time inside Q K^T instead of all at once (dh 160, whose
// ring of 3 stages and registers would not fit)
template <int DH>
struct Bf16Tile {
  static constexpr int MT = DH <= 64 ? 2 : 1;
  static constexpr int NKG = 2;
  static constexpr int NSTAGE = DH > 128 ? 2 : 3;
  static constexpr bool QSTREAM = DH > 128;
  static constexpr int BQ = QT * MT;
  static constexpr int NT = NKG * NTG;
};

// shared memory of the bf16 path: the Q tile and each kv group's NSTAGE K
// and V tiles, rows padded by 16 B (see flash_fwd_bf16)
template <int DH>
constexpr size_t smem_bytes_bf16() {
  return sizeof(bf16_t) *
         (size_t)(Bf16Tile<DH>::BQ +
                  2 * Bf16Tile<DH>::NKG * Bf16Tile<DH>::NSTAGE * BKV) *
         (DH + 8);
}
// the opt-in limit of one block's shared memory on the H100
constexpr size_t SMEM_LIMIT = 232448;

// barrier of one kv group's NTG threads (id 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int kg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kg), "n"(NTG));
}

// 2^x on the MUFU unit (ex2.approx, relative error about 2^-22; -inf -> 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B from global to shared memory without passing through registers;
// with in == false nothing is read and the 16 B are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i receives matrix i in the mma fragment layout (row lane/4,
// columns 2(lane%4), +1), or its transpose with .trans
// (a shared-space address: a lane's base plus a constant offset, so the
// address costs no instruction per load)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// two 8x8 b16 matrices from the row addresses of lanes 0-15 (the other
// lanes' addresses are not read)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// rows [r0, r0 + ROWS) of a [*, DH] global tile with row stride `stride`
// into shared memory with row stride LD; rows at or past `nrows` are
// zero-filled (their address is clamped to row 0, which is never read)
template <int DH, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(bf16_t* dst, const bf16_t* src,
                                                size_t stride, int r0,
                                                int nrows, int tid) {
  constexpr int LD = DH + 8, CH = DH / 8;
#pragma unroll
  for (int e = tid; e < ROWS * CH; e += NTHREADS) {
    const int row = e / CH, ch = e % CH;
    const bool in = r0 + row < nrows;
    cp_async16(&dst[row * LD + ch * 8],
               src + (in ? (size_t)(r0 + row) * stride : 0) + ch * 8, in);
  }
}

// Fragment layout of m16n8k16 (PTX ISA), lane = 4 * g + c:
//   A 16x16: a0 = A[g][2c..2c+1], a1 = A[g+8][2c..], a2 = A[g][2c+8..],
//            a3 = A[g+8][2c+8..]
//   B 16x8:  b0 = B[2c..2c+1][g], b1 = B[2c+8..2c+9][g]
//   C 16x8:  c0, c1 = C[g][2c..2c+1], c2, c3 = C[g+8][2c..2c+1]
template <int DH>
__global__ void __launch_bounds__(Bf16Tile<DH>::NT, 1)
flash_fwd_bf16(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
               const bf16_t* __restrict__ v, bf16_t* __restrict__ o, int Sq,
               int Skv, int H, int K, int causal, int window, float scale) {
  constexpr int LD = DH + 8;      // 16 B of padding: rows stay 16 B aligned
                                  // and the 8 rows of an ldmatrix phase hit
                                  // 8 distinct 16 B bank groups
  constexpr int MT = Bf16Tile<DH>::MT;
  constexpr int NKG = Bf16Tile<DH>::NKG;
  constexpr int NSTAGE = Bf16Tile<DH>::NSTAGE;
  constexpr int BQ16 = Bf16Tile<DH>::BQ;
  constexpr int NKS = DH / 16;    // k-steps over dh for Q K^T (5 at dh 80:
                                  // the last one pairs with no other)
  constexpr int NNB = BKV / 8;    // n-blocks of 8 keys
  constexpr int NDB = DH / 8;     // n-blocks of 8 dims for P V
  constexpr int TILE = BKV * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* sQ = reinterpret_cast<bf16_t*>(smem_raw);  // [MT][QT][LD]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int kg = tid / NTG, gtid = tid % NTG;     // kv group, thread in it
  const int warp = gtid / 32, lane = tid % 32;    // warp within the group
  const int g = lane / 4, c = lane % 4;
  // this lane's row address for ldmatrix: matrix lane / 8, row lane % 8
  const int lm = lane / 8, lr = lane % 8;
  bf16_t* sK = sQ + BQ16 * LD + kg * 2 * NSTAGE * TILE;  // [NSTAGE][BKV][LD]
  bf16_t* sV = sK + NSTAGE * TILE;                       // [NSTAGE][BKV][LD]

  const size_t qrow = (size_t)H * DH;
  const size_t krow = (size_t)K * DH;
  const bf16_t* qb = q + (size_t)b * Sq * qrow + (size_t)h * DH;
  const bf16_t* kb = k + (size_t)b * Skv * krow + (size_t)kh * DH;
  const bf16_t* vb = v + (size_t)b * Skv * krow + (size_t)kh * DH;
  bf16_t* ob = o + (size_t)b * Sq * qrow + (size_t)h * DH;
  constexpr int B2 = sizeof(bf16_t);  // bytes of an element

  // this block's q tiles, one per m-tile (-1: none), and the kv tiles
  // each sees
  const int n_qt = (Sq + QT - 1) / QT;
  int qtile[MT];
  TileRange rng[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (MT == 1)
      qtile[mt] = n_qt - 1 - blockIdx.x;      // longest causal rows first
    else
      qtile[mt] = mt == 0 ? blockIdx.x : n_qt - 1 - blockIdx.x;
    if (mt > 0 && qtile[mt] == qtile[0]) qtile[mt] = -1;  // odd middle tile
    rng[mt] = qtile[mt] < 0 ? TileRange{0, 0}
                            : tile_range(qtile[mt] * QT, QT, Sq, Skv, causal, window);
  }
  // the block walks the tiles from the first any m-tile sees to the last
  // (under a causal mask one m-tile's range holds the other's), kv group kg
  // the tiles t_begin + kg, + kg + NKG, ...: n_t of them
  int t_begin = rng[0].begin, t_end = rng[0].end;
  if (MT > 1 && rng[MT - 1].begin < rng[MT - 1].end) {
    t_begin = min(t_begin, rng[MT - 1].begin);
    t_end = max(t_end, rng[MT - 1].end);
  }
  const int n_t = max(0, (t_end - t_begin - kg + NKG - 1) / NKG);
  // each of the group's threads copies 16 B of rows lrow, lrow + RSTEP, ...
  // of a K and a V tile, at shared addresses fixed but for the stage.  That
  // needs the CH 16-byte chunks of a row to divide the group's NTG threads;
  // at dh 80 (CH = 10) they do not, and each thread takes the chunks
  // gtid, gtid + NTG, ... of the tile, BKV * CH / NTG = 5 of them, with the
  // row and column worked out for each
  constexpr int CH = DH / 8;
  constexpr bool FIXED_ROWS = NTG % CH == 0 && BKV % (NTG / CH) == 0;
  constexpr int RSTEP = FIXED_ROWS ? NTG / CH : 1;
  static_assert(FIXED_ROWS || (BKV * CH) % NTG == 0, "tile copy layout");
  const int lrow = gtid / CH, lch = gtid % CH;
  const uint32_t kv_dst = B2 * (lrow * LD + lch * 8);
  const uint32_t k_dst = smem_addr(sK) + kv_dst, v_dst = smem_addr(sV) + kv_dst;
  auto fetch = [&](int i, int stage) {  // the group's i-th tile, or nothing
    if (i < n_t) {
      const int k0 = (t_begin + kg + i * NKG) * BKV;
      if constexpr (FIXED_ROWS) {
#pragma unroll
        for (int r = 0; r < BKV / RSTEP; ++r) {
          const int row = k0 + lrow + r * RSTEP;
          const bool in = row < Skv;
          // rows past the end are zero-filled; their address is never read
          const size_t off = in ? (size_t)row * krow + lch * 8 : 0;
          const uint32_t d = B2 * (stage * TILE + r * RSTEP * LD);
          cp_async16(k_dst + d, kb + off, in);
          cp_async16(v_dst + d, vb + off, in);
        }
      } else {
#pragma unroll
        for (int e = gtid; e < BKV * CH; e += NTG) {
          const int r = e / CH, ch = e % CH;
          const int row = k0 + r;
          const bool in = row < Skv;
          const size_t off = in ? (size_t)row * krow + ch * 8 : 0;
          const uint32_t d = B2 * (stage * TILE + r * LD + ch * 8);
          cp_async16(smem_addr(sK) + d, kb + off, in);
          cp_async16(smem_addr(sV) + d, vb + off, in);
        }
      }
    }
    cp_async_commit();
  };
  // copy groups: Q, then the group's first NSTAGE - 1 tiles (or empty
  // groups), so that before step i exactly tiles i .. i + NSTAGE - 2 can be
  // in flight
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    load_tile_async<DH, QT, Bf16Tile<DH>::NT>(sQ + mt * QT * LD, qb, qrow,
                                             max(qtile[mt], 0) * QT,
                                             qtile[mt] < 0 ? 0 : Sq, tid);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i + 1 < NSTAGE; ++i) fetch(i, i);

  // this warp's rows of m-tile mt: qw[mt] + g and + 8; both kv groups hold
  // the same rows
  int qw[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) qw[mt] = max(qtile[mt], 0) * QT + warp * 16;
  cp_async_wait<NSTAGE - 1>();  // this thread's part of Q
  __syncthreads();     // everyone's
  // this lane's ldmatrix row addresses in shared memory, in bytes: Q's and
  // V's matrices are (rows 0-7 | 8-15) x (cols 0-7 | 8-15), K's four
  // 8-column blocks of rows 0-7
  const uint32_t q_lane =
      smem_addr(sQ) + B2 * ((warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8);
  const uint32_t k_lane = smem_addr(sK) + B2 * (lr * LD + lm * 8);
  const uint32_t v_lane =
      smem_addr(sV) + B2 * (((lm & 1) * 8 + lr) * LD + (lm >> 1) * 8);

  // scores go to the exp2 domain in one FMA: p = 2^(s * sl2 - m), with m
  // the running row max of s * sl2
  const float sl2 = scale * LOG2E;
  // masked scores are -inf, not NEG_INF: exp2 of the FMA's exact product
  // minus a rounded m would not be 0 for a finite sentinel.  A row that
  // has seen no visible key keeps m = -inf and exponentiates against 0, so
  // its p and l stay 0 (a row with no visible key at all returns 0)
  float m[MT][2], l[MT][2];
  float acc[MT][NDB][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int db = 0; db < NDB; ++db)
      acc[mt][db][0] = acc[mt][db][1] = acc[mt][db][2] = acc[mt][db][3] = 0.f;
  }

  for (int i = 0; i < n_t; ++i) {
    const int st = i % NSTAGE;
    const int t = t_begin + kg + i * NKG;
    const int k0 = t * BKV;
    // all but the newest NSTAGE - 2 copy groups: tile i has landed
    cp_async_wait<NSTAGE - 2>();
    // tile i is visible to the whole kv group, and the group is done with
    // step i - 1, whose stage the copy of tile i + NSTAGE - 1 now reuses
    group_sync(kg);
    fetch(i + NSTAGE - 1, (st + NSTAGE - 1) % NSTAGE);
    const uint32_t tK = k_lane + B2 * st * TILE;
    const uint32_t tV = v_lane + B2 * st * TILE;
    // one step over the m-tiles in ACT (a bit mask), which see this kv
    // tile; ACT is a compile-time constant, so no test sits between the
    // products
    auto step = [&](auto act_c) {
      constexpr int ACT = decltype(act_c)::value;
      // S = Q K^T: B[kdim][key] = K[key][kdim] is K's 8x8 blocks untransposed;
      // one x4 gives b0, b1 of k-steps ks and ks + 1, for every m-tile
      float s[MT][NNB][4];
      if constexpr (Bf16Tile<DH>::QSTREAM) {
        // Q's A fragments two k-steps at a time (dh 160): the k-step loop
        // outside, the key n-blocks inside.  Each s[mt][nb] takes the same
        // products in the same order as below.
        static_assert(NKS % 2 == 0, "QSTREAM pairs k-steps");
#pragma unroll
        for (int nb = 0; nb < NNB; ++nb)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            s[mt][nb][0] = s[mt][nb][1] = s[mt][nb][2] = s[mt][nb][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < NKS; ks += 2) {
          uint32_t qa[MT][2][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (!((ACT >> mt) & 1)) continue;
            ldsm_x4(qa[mt][0], q_lane + B2 * (mt * QT * LD + ks * 16));
            ldsm_x4(qa[mt][1], q_lane + B2 * (mt * QT * LD + ks * 16 + 16));
          }
#pragma unroll
          for (int nb = 0; nb < NNB; ++nb) {
            uint32_t kf[4];
            ldsm_x4(kf, tK + B2 * (nb * 8 * LD + ks * 16));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if (!((ACT >> mt) & 1)) continue;
              mma_bf16(s[mt][nb], qa[mt][0], kf[0], kf[1]);
              mma_bf16(s[mt][nb], qa[mt][1], kf[2], kf[3]);
            }
          }
        }
      } else {
        // Q -> A fragments, loaded again at each step so that they do not
        // hold registers through the softmax and P V: matrices (rows 0-7 |
        // 8-15) x (cols 0-7 | 8-15)
        uint32_t qa[MT][NKS][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!((ACT >> mt) & 1)) continue;
#pragma unroll
          for (int ks = 0; ks < NKS; ++ks)
            ldsm_x4(qa[mt][ks], q_lane + B2 * (mt * QT * LD + ks * 16));
        }
#pragma unroll
        for (int nb = 0; nb < NNB; ++nb) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            s[mt][nb][0] = s[mt][nb][1] = s[mt][nb][2] = s[mt][nb][3] = 0.f;
#pragma unroll
          for (int ks = 0; ks + 1 < NKS; ks += 2) {
            uint32_t kf[4];
            ldsm_x4(kf, tK + B2 * (nb * 8 * LD + ks * 16));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if (!((ACT >> mt) & 1)) continue;
              mma_bf16(s[mt][nb], qa[mt][ks], kf[0], kf[1]);
              mma_bf16(s[mt][nb], qa[mt][ks + 1], kf[2], kf[3]);
            }
          }
          if constexpr (NKS % 2) {
            // the odd last k-step (dh 80): one x2, lanes 0-15's addresses
            // name its two 8-column blocks
            uint32_t kf[2];
            ldsm_x2(kf, tK + B2 * (nb * 8 * LD + (NKS - 1) * 16));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if (!((ACT >> mt) & 1)) continue;
              mma_bf16(s[mt][nb], qa[mt][NKS - 1], kf[0], kf[1]);
            }
          }
        }
      }

      float mu[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (!((ACT >> mt) & 1)) continue;
        // the mask, only where this tile crosses the kv edge, the causal
        // diagonal or the window edge for one of this warp's rows
        const bool edge = k0 + BKV > Skv || (causal && k0 + BKV - 1 > qw[mt]) ||
                          (window > 0 && qw[mt] + 15 - k0 >= window);
        if (edge) {
          const int qi0 = qw[mt] + g, qi1 = qi0 + 8;
#pragma unroll
          for (int nb = 0; nb < NNB; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kj = k0 + nb * 8 + 2 * c + e;
              if (!visible(qi0, kj, Skv, causal, window)) s[mt][nb][e] = -INFINITY;
              if (!visible(qi1, kj, Skv, causal, window)) s[mt][nb][2 + e] = -INFINITY;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int nb = 0; nb < NNB; ++nb)
            mx = fmaxf(mx, fmaxf(s[mt][nb][2 * r], s[mt][nb][2 * r + 1]));
          // the 4 lanes that share a row differ in their two lowest bits
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mo = m[mt][r];
          m[mt][r] = fmaxf(mo, mx * sl2);
          mu[mt][r] = m[mt][r] == -INFINITY ? 0.f : m[mt][r];
          const float corr = fast_exp2(mo - mu[mt][r]);
          l[mt][r] *= corr;
#pragma unroll
          for (int db = 0; db < NDB; ++db) {
            acc[mt][db][2 * r] *= corr;
            acc[mt][db][2 * r + 1] *= corr;
          }
        }
      }

      // O += P V, 16 keys per k-step: P's A fragment is the C fragments of
      // key n-blocks 2j and 2j+1; B[key][dim] = V[key][dim] is V's 8x8
      // blocks transposed: one x4.trans gives b0, b1 of dim blocks db, db+1
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!((ACT >> mt) & 1)) continue;
          float p[2][4];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[h2][e] = fast_exp2(fmaf(s[mt][2 * j + h2][e], sl2, -mu[mt][e / 2]));
            l[mt][0] += p[h2][0] + p[h2][1];
            l[mt][1] += p[h2][2] + p[h2][3];
          }
          pa[mt][0] = pack_f32(p[0][0], p[0][1]);
          pa[mt][1] = pack_f32(p[0][2], p[0][3]);
          pa[mt][2] = pack_f32(p[1][0], p[1][1]);
          pa[mt][3] = pack_f32(p[1][2], p[1][3]);
        }
#pragma unroll
        for (int db = 0; db < NDB; db += 2) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, tV + B2 * (j * 16 * LD + db * 8));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (!((ACT >> mt) & 1)) continue;
            mma_bf16(acc[mt][db], pa[mt], vf[0], vf[1]);
            mma_bf16(acc[mt][db + 1], pa[mt], vf[2], vf[3]);
          }
        }
      }
    };
    // which m-tiles see this kv tile (the same for the whole block)
    int act = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      act |= (t >= rng[mt].begin && t < rng[mt].end) << mt;
    if (MT == 1 || act == 3)
      step(IntC<MT == 1 ? 1 : 3>{});
    else if (act == 1)
      step(IntC<1>{});
    else if (act == 2)
      step(IntC<2>{});
    // (act == 0: a kv tile between two windows that neither m-tile sees)
  }
  cp_async_wait<0>();
  __syncthreads();  // every group is done with its ring

  // the kv groups' partial m, l, acc of the same rows merge into group 0's:
  // the other groups leave theirs in the rings' shared memory, laid out by
  // (thread in group, value) so that each value is one 4-byte column
  constexpr int NV = MT * (NDB * 4 + 4);
  static_assert((NKG - 1) * NV * NTG * sizeof(float) <=
                    2 * NKG * NSTAGE * TILE * sizeof(bf16_t),
                "the exchange fits in the rings");
  float* xch = reinterpret_cast<float*>(sQ + BQ16 * LD);  // [NKG-1][NV][NTG]
  if (kg > 0) {
    float* mine = xch + (size_t)(kg - 1) * NV * NTG + gtid;
    int e = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mine[(e++) * NTG] = m[mt][r];
        mine[(e++) * NTG] = l[mt][r];
      }
#pragma unroll
      for (int db = 0; db < NDB; ++db)
#pragma unroll
        for (int u = 0; u < 4; ++u) mine[(e++) * NTG] = acc[mt][db][u];
    }
  }
  __syncthreads();
  if (kg > 0) return;
#pragma unroll 1
  for (int og = 1; og < NKG; ++og) {
    const float* theirs = xch + (size_t)(og - 1) * NV * NTG + gtid;
    int e = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float ca[2], cb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mo = theirs[(e++) * NTG], lo = theirs[(e++) * NTG];
        const float mn = fmaxf(m[mt][r], mo);
        const float mun = mn == -INFINITY ? 0.f : mn;
        ca[r] = fast_exp2(m[mt][r] - mun);
        cb[r] = fast_exp2(mo - mun);
        m[mt][r] = mn;
        l[mt][r] = l[mt][r] * ca[r] + lo * cb[r];
      }
#pragma unroll
      for (int db = 0; db < NDB; ++db)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[mt][db][u] = acc[mt][db][u] * ca[u / 2] + theirs[(e++) * NTG] * cb[u / 2];
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // each lane summed its own columns of l: add the row's 4 lanes
      float lt = l[mt][r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float d = fmaxf(lt, 1e-30f);
      const int qi = qw[mt] + g + 8 * r;
      if (qtile[mt] < 0 || qi >= Sq) continue;
#pragma unroll
      for (int db = 0; db < NDB; ++db)
        *reinterpret_cast<uint32_t*>(ob + (size_t)qi * qrow + db * 8 + 2 * c) =
            pack_f32(acc[mt][db][2 * r] / d, acc[mt][db][2 * r + 1] / d);
    }
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
  static_assert(smem <= SMEM_LIMIT, "the f32 tile exceeds a block's shared memory");
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
  constexpr size_t smem = smem_bytes_bf16<DH>();
  static_assert(smem <= SMEM_LIMIT, "the bf16 tile exceeds a block's shared memory");
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  // q tiles of QT rows, MT per block
  const int n_qt = (Sq + QT - 1) / QT;
  const dim3 grid((n_qt + Bf16Tile<DH>::MT - 1) / Bf16Tile<DH>::MT, B * H);
  flash_fwd_bf16<DH><<<grid, Bf16Tile<DH>::NT, smem, stream>>>(
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
      case 80: return launch_f32<80>(FLASH_ARGS);
      case 128: return launch_f32<128>(FLASH_ARGS);
      case 160: return launch_f32<160>(FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (dh) {
      case 32: return launch_bf16<32>(FLASH_ARGS);
      case 64: return launch_bf16<64>(FLASH_ARGS);
      case 80: return launch_bf16<80>(FLASH_ARGS);
      case 128: return launch_bf16<128>(FLASH_ARGS);
      case 160: return launch_bf16<160>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return -1;
}
