// Fused supervised-contrastive (SupCon / InfoNCE) loss and its gradient
// (f32 in, f32 math), for Hopper (sm_90a).
//
//   D1 supcon_loss  replaces contrastyou_tpu/ops/pallas/infonce.py _loss_kernel:
//                   for every anchor row i of z [M,d], s_ij = <z_i, z_j> / tau,
//                   the log-sum-exp of s_i over the columns its masks allow
//                   (stabilised by max(masked row max, -0), as the TPU kernel
//                   does) and the mean of (s_ij - lse_i) over its positives:
//                   loss_i = -sum_j pos_ij (s_ij - log(den_i + 1e-16) - mx_i)
//                   / max(#pos_i, 1). Besides the loss it writes two residuals
//                   per row for D2: lse_i = mx_i + log(max(den_i, 1e-16)) and
//                   the positive count.
//   D2 supcon_dz    replaces infonce.py _bwd_kernel: with G_ij = -(a_ij - w_i
//                   p_ij) / M (p the masked row softmax, a = pos / max(#pos, 1),
//                   w = sum_j a_ij), dz = (G z + G^T z) / tau * g. s is
//                   symmetric, so a block forms its tile of H = G + G^T from
//                   s_kj and the saved residuals of rows k and j, and takes
//                   dz_k = sum_j H_kj z_j / tau * g.
//
// Masks travel as one byte per pair: bit 0 = positive, bit 1 = negative (the
// pos / neg masks of the loss, diagonal already cleared).
//
// What bounds it on the H100. The work is small: D1 is 2 M^2 d FLOP (34 MFLOP
// at M = 256, 118 at the prostate dense hook's M = 480, d = 256), D2 twice
// that, and the bytes are z and the M^2 pair bytes (~0.4 MB at M = 480). At
// the card's f32 peak (67 TFLOP/s) that is 0.5-3.5 us, under the cost of a
// launch, so what bounds a launch is how many SMs it keeps busy and how long
// its serial chains are. This file's first design gave one block to 8 anchor
// rows (at most 32 blocks at M <= 256 on 132 SMs), ran one serial d-long dot
// product a thread, re-read all of z in every block and read the transposed
// pair bytes with stride M.
//
// The design. A 2-D grid of (16-row anchor tile, column slice) blocks; the
// slice is ceil(M / 8) columns rounded up to the 32-column chunk, so a row
// tile has at most 8 slices, and they form one thread-block cluster (8 is the
// portable size): 6 blocks at M = 36, 18 at 96, 72 at 180, 128 at 256, 240 at
// 480. A block of 4 warps stages its 16 rows of z once and streams its slice
// in 32-row chunks through a two-stage cp.async ring (one stage when the slice
// is one chunk). The similarity tile [16, 32] is a register-tiled FP32
// product: warp w takes a quarter of d for the whole tile, a lane 4 rows x 4
// columns (rows rg + 4i, columns cg + 8j, so each of its 8 16-byte shared
// loads a k step falls in distinct banks: 64 FMAs to 8 loads); the quarters
// meet in shared memory and are summed in warp order. D1 keeps a running
// (max, sum of exp) per thread over its columns and merges the 8 threads of a
// row with shuffles. D2 forms the chunk's H tile from pair bytes and
// residuals that each thread loads into registers before the product, which
// hides their latency (the transposed bytes are 4 contiguous bytes of each of
// 32 code rows a warp, under 2% of a chunk's bytes, so they skip shared
// memory), then the partial dz += H_tile z_chunk from the same staged chunk (a
// lane all 16 rows x 2 or 4 columns of d, in registers across chunks). The
// slices of a row tile merge through distributed shared memory: each block
// pushes its partials into the owner's shared memory with remote stores, one
// cluster barrier makes them visible, and the owner sums them locally in rank
// order (D1: rank 0 merges the rows' (max, sum of exp) and writes loss, lse
// and pcount; D2: rank r sums the r-th share of the [16, d] tile). Remote
// loads between two barriers, tried first, cost D2 its largest phase at
// small M. No atomics (two launches give the same bits) and no [M, M] tensor
// in device memory; shared memory does not grow with M (d = 256, two stages:
// 95 KB for D1, 112 KB for D2; d = 512: 177 and 210 KB), so the capacity is
// that of the 32-bit pair index, M^2 < 2^31 (M <= 46,340) at d <= 512. FP32
// cores, no tensor cores: the loss is defined in f32, and TF32 would not hold
// it to 1e-5.
//
// What still bounds it (NVIDIA H100, PERF.md): at M <= 480 a launch is its
// chain of phases (staging, product, barriers, the cluster barrier and the
// merge), ~6-10 us of kernel; at M >= 960 every row tile re-reads its slice
// of z from L2 (16 rows of reuse a byte) and the product runs at ~20% of the
// f32 peak.
//
// Every entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 16;           // anchor rows per block (one row tile)
constexpr int kChunk = 32;          // columns of z per staged chunk
constexpr int kThreads = 128;       // 4 warps
constexpr int kMaxSlices = 8;       // blocks per cluster (the portable size)
constexpr int kMaxDim = 512;        // dz: 4 columns a lane
constexpr int kMaxAnchors = 46340;  // pair bytes indexed in 32 bits: M^2 < 2^31
constexpr int kPld = 40;            // row stride of a warp's similarity partial
constexpr float kNegInf = -1e30f;

struct Geo {
  int M, d, dp, ld;   // anchors, width, width rounded up to 16, staged row stride
  int width;          // columns per slice (a multiple of kChunk)
  int stages;         // chunks in the ring: 1 when a slice is one chunk
  int vec;            // 16-byte copies (d % 4 == 0 and z 16-byte aligned)
  float tau;
};

struct Args {
  const float* z;
  const uint8_t* code;
  float* loss;        // D1 out
  float* lse;         // D1 out, D2 in
  float* pcount;      // D1 out, D2 in
  const float* g;     // D2 in: the cotangent of the mean loss, one float
  float* dz;          // D2 out
};

// D2 adds rx, the dz partials the other slices push: [kRows, dp] plus the
// rounding of its split into at most kMaxSlices shares of whole float4s
__host__ __device__ inline size_t smem_floats(const Geo& g, bool grad) {
  return (size_t)kRows * g.ld + (size_t)g.stages * kChunk * g.ld + 4 * kRows * kPld +
         kChunk * kRows + (grad ? kRows * g.dp + 4 * kMaxSlices : 0);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// rows [row0, row0 + n) of z into dst rows [0, n); rows [n, rows) and columns
// [d, dp) are zero-filled by the copy. Asynchronous: the caller commits.
__device__ void stage_rows(float* dst, const float* __restrict__ z, int row0, int n,
                           int rows, const Geo& g) {
  if (g.vec) {
    const int q = g.dp / 4;
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int r = i / q, c = (i - r * q) * 4;
      const bool ok = r < n && c < g.d;
      tc::cp_async16(tc::smem_addr(dst + r * g.ld + c),
                     ok ? z + (size_t)(row0 + r) * g.d + c : z, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * g.dp; i += kThreads) {
      const int r = i / g.dp, c = i - r * g.dp;
      const bool ok = r < n && c < g.d;
      cp_async4(tc::smem_addr(dst + r * g.ld + c),
                ok ? z + (size_t)(row0 + r) * g.d + c : z, ok ? 4 : 0);
    }
  }
}

// D1 (kGrad false) and D2 (kGrad true; kCpl dz columns a lane, dp <= 128 kCpl).
// Grid (slices, row tiles), one cluster of `slices` blocks per row tile.
template <bool kGrad, int kCpl>
__global__ void __launch_bounds__(kThreads)
supcon_kernel(Args a, Geo g) {
  extern __shared__ __align__(16) float smem[];
  float* zr = smem;                               // [kRows][ld] the tile's rows
  float* zc = zr + kRows * g.ld;                  // [stages][kChunk][ld] the ring
  float* ps = zc + g.stages * kChunk * g.ld;      // [4 warps][kRows][kPld] s partials
  float* aux = ps + 4 * kRows * kPld;             // D1 row partials, D2 H^T [kChunk][kRows]
                                                  // (D2: then rx, see the merge)
  cg::cluster_group cluster = cg::this_cluster();

  const int M = g.M, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * kRows;
  const int jbeg = blockIdx.x * g.width, jend = min(jbeg + g.width, M);
  const int nch = (jend - jbeg + kChunk - 1) / kChunk;

  stage_rows(zr, a.z, row0, min(kRows, M - row0), kRows, g);
  stage_rows(zc, a.z, jbeg, min(kChunk, jend - jbeg), kChunk, g);
  tc::cp_async_commit();

  // similarity product: warp w takes k in [w dp / 4, (w + 1) dp / 4) of the
  // whole [16, 32] tile; a lane rows rg + 4 i, columns cg + 8 j (i, j < 4):
  // each of its 8 16-byte loads a k step hits distinct bank groups
  const int dq = g.dp / 4, rg = lane >> 3, cg8 = lane & 7;
  const float* xa = zr + rg * g.ld + warp * dq;
  float* pw = ps + warp * kRows * kPld + rg * kPld + cg8;

  // epilogues: thread row er = tid / 8 of the tile, columns 4 (tid % 8) + [0, 4)
  const int er = tid >> 3, ej = (tid & 7) * 4;
  // D1: running masked max, sum of exp (relative to it), positive s, positives
  float m = kNegInf, l = 0.f, psum = 0.f, pc = 0.f;
  // D2: the row's residuals; dz partial of rows [0, 16), columns
  // kCpl (32 warp + lane) + [0, kCpl)
  float lse_k = 0.f, pc_k = 0.f;
  if (kGrad && row0 + er < M) {
    lse_k = a.lse[row0 + er];
    pc_k = a.pcount[row0 + er];
  }
  const int dc = kCpl * (32 * warp + lane);
  float acc[kRows][kCpl];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int q = 0; q < kCpl; ++q) acc[r][q] = 0.f;

  for (int c = 0; c < nch; ++c) {
    const int jc = jbeg + c * kChunk;
    const float* zs = zc + (c & 1) * kChunk * g.ld;
    if (c + 1 < nch) {
      stage_rows(zc + ((c + 1) & 1) * kChunk * g.ld, a.z, jc + kChunk,
                 min(kChunk, jend - jc - kChunk), kChunk, g);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    // the epilogue's pair bytes and residuals, loaded under the product
    uint8_t ckj[4], cjk[4];
    float lse_j[4], pc_j[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = row0 + er, j = jc + ej + t;
      const bool ok = i < M && j < jend;
      ckj[t] = ok ? a.code[i * M + j] : 0;
      cjk[t] = kGrad && ok ? a.code[j * M + i] : 0;
      lse_j[t] = kGrad && ok ? a.lse[j] : 0.f;
      pc_j[t] = kGrad && ok ? a.pcount[j] : 0.f;
    }
    __syncthreads();                   // chunk c (and the rows) staged by every thread

    float s[4][4] = {};
    const float* xb = zs + cg8 * g.ld + warp * dq;
#pragma unroll 2
    for (int k = 0; k < dq; k += 4) {
      float4 u[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = ld4(xa + 4 * i * g.ld + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = ld4(xb + 8 * j * g.ld + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(u[i].x, v[j].x, s[i][j]);
          s[i][j] = fmaf(u[i].y, v[j].y, s[i][j]);
          s[i][j] = fmaf(u[i].z, v[j].z, s[i][j]);
          s[i][j] = fmaf(u[i].w, v[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pw[4 * i * kPld + 8 * j] = s[i][j];
    __syncthreads();                   // the four k partials of the tile are in ps

    // s of the thread's 4 epilogue pairs: the k partials summed in warp order
    float sv[4];
    {
      const float* p = ps + er * kPld + ej;
      const float4 p0 = ld4(p), p1 = ld4(p + kRows * kPld), p2 = ld4(p + 2 * kRows * kPld),
                   p3 = ld4(p + 3 * kRows * kPld);
      sv[0] = (((p0.x + p1.x) + p2.x) + p3.x) / g.tau;
      sv[1] = (((p0.y + p1.y) + p2.y) + p3.y) / g.tau;
      sv[2] = (((p0.z + p1.z) + p2.z) + p3.z) / g.tau;
      sv[3] = (((p0.w + p1.w) + p2.w) + p3.w) / g.tau;
    }

    if (!kGrad) {
      float cm = kNegInf;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (ckj[t] & 3) cm = fmaxf(cm, sv[t]);
      const float mn = fmaxf(m, cm);
      l *= expf(m - mn);
      m = mn;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (ckj[t] & 3) l += expf(sv[t] - m);
        if (ckj[t] & 1) {
          psum += sv[t];
          pc += 1.f;
        }
      }
    } else {
      const float inv_m = 1.f / (float)M;
      const float ipk = 1.f / fmaxf(pc_k, 1.f);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float ipj = 1.f / fmaxf(pc_j[t], 1.f);
        const float pkj = (ckj[t] & 3) ? expf(sv[t] - lse_k) : 0.f;
        const float pjk = (cjk[t] & 3) ? expf(sv[t] - lse_j[t]) : 0.f;
        const float akj = (ckj[t] & 1) ? ipk : 0.f, ajk = (cjk[t] & 1) ? ipj : 0.f;
        const float gkj = -(akj - pc_k * ipk * pkj) * inv_m;
        const float gjk = -(ajk - pc_j[t] * ipj * pjk) * inv_m;
        aux[(ej + t) * kRows + er] = gkj + gjk;
      }
      __syncthreads();                 // aux holds H^T of the chunk
      const int nj = min(kChunk, jend - jc);
      if (dc < g.dp) {
        for (int jj = 0; jj < nj; ++jj) {
          float h[kRows];
#pragma unroll
          for (int r = 0; r < kRows; r += 4) {
            const float4 h4 = ld4(aux + jj * kRows + r);
            h[r] = h4.x;
            h[r + 1] = h4.y;
            h[r + 2] = h4.z;
            h[r + 3] = h4.w;
          }
          float zv[kCpl];
          if constexpr (kCpl == 4) {
            const float4 v = ld4(zs + jj * g.ld + dc);
            zv[0] = v.x;
            zv[1] = v.y;
            zv[2] = v.z;
            zv[3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(zs + jj * g.ld + dc);
            zv[0] = v.x;
            zv[1] = v.y;
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int q = 0; q < kCpl; ++q) acc[r][q] = fmaf(h[r], zv[q], acc[r][q]);
        }
      }
      __syncthreads();                 // before the next chunk refills the ring and aux
    }
  }

  // the merge: every block pushes its partials into the owner's shared
  // memory with remote stores, one cluster barrier makes them visible, and
  // the owner sums them locally in rank order (no remote loads, no second
  // barrier: nothing is read across blocks after it)
  const int ns = gridDim.x, rank = cluster.block_rank();
  if (!kGrad) {
    // merge a row's 8 threads (xor butterfly: every lane ends with the same bits)
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
      pc += __shfl_xor_sync(0xffffffffu, pc, o);
      const float mn = fmaxf(m, m2);
      l = l * expf(m - mn) + l2 * expf(m2 - mn);
      m = mn;
    }
    // rank 0's aux [slices][kRows] float4 (max, sum of exp, positive s, positives)
    if ((tid & 7) == 0)
      reinterpret_cast<float4*>(cluster.map_shared_rank(aux, 0))[rank * kRows + er] =
          make_float4(m, l, psum, pc);
    cluster.sync();
    const int i = row0 + tid;
    if (rank == 0 && tid < kRows && i < M) {
      const float4* p = reinterpret_cast<const float4*>(aux) + tid;
      float mx = kNegInf;
      for (int b = 0; b < ns; ++b) mx = fmaxf(mx, p[b * kRows].x);
      mx = fmaxf(mx, -0.f);            // rows with no mask or a negative max -> -0
      float den = 0.f, sp = 0.f, np = 0.f;
      for (int b = 0; b < ns; ++b) {
        const float4 v = p[b * kRows];
        den += v.y * expf(v.x - mx);
        sp += v.z;
        np += v.w;
      }
      const float log_den = logf(den + 1e-16f) + mx;
      a.loss[i] = -(sp - np * log_den) / fmaxf(np, 1.f);
      a.lse[i] = mx + logf(fmaxf(den, 1e-16f));
      a.pcount[i] = np;
    }
  } else {
    // the [kRows, dp] tile in float4 units, rank r owning [r per, (r + 1) per);
    // the owner's rx holds [slices][per] float4 (a piece never straddles owners)
    float* rx = aux + kChunk * kRows;
    const int n4 = kRows * g.dp / 4, per = (n4 + ns - 1) / ns;
    if (dc < g.dp) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int f = r * g.dp + dc, dst = (f / 4) / per;
        float* p = cluster.map_shared_rank(rx, dst) + (rank * per + f / 4 - dst * per) * 4 + f % 4;
        if constexpr (kCpl == 4)
          *reinterpret_cast<float4*>(p) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        else
          *reinterpret_cast<float2*>(p) = make_float2(acc[r][0], acc[r][1]);
      }
    }
    cluster.sync();
    const int mine = min(per, n4 - rank * per);
    const float gs = *a.g;
    for (int e = tid; e < mine; e += kThreads) {
      float4 sum = ld4(rx + 4 * e);
      for (int b = 1; b < ns; ++b) {
        const float4 v = ld4(rx + 4 * (b * per + e));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      const int f = 4 * (rank * per + e), r = f / g.dp, col = f - r * g.dp, k = row0 + r;
      const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
      if (k < M)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (col + t < g.d) a.dz[(size_t)k * g.d + col + t] = sv[t] / g.tau * gs;
    }
  }
}

template <bool kGrad, int kCpl>
int launch(const Args& a, int M, int d, float tau, void* stream) {
  Geo g;
  g.M = M;
  g.d = d;
  g.dp = (d + 15) / 16 * 16;
  g.ld = g.dp + 4;                     // 16-byte row groups: consecutive rows in distinct banks
  const int chunks = (M + kMaxSlices * kChunk - 1) / (kMaxSlices * kChunk);
  g.width = chunks * kChunk;
  g.stages = chunks > 1 ? 2 : 1;
  g.vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(a.z) % 16 == 0;
  g.tau = tau;
  const int slices = (M + g.width - 1) / g.width;
  static bool opted = false;           // the largest ring's shared memory, once
  if (!opted) {
    Geo big = g;
    big.ld = kMaxDim + 4;
    big.stages = 2;
    const cudaError_t e = cudaFuncSetAttribute(
        supcon_kernel<kGrad, kCpl>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(big, kGrad) * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, (M + kRows - 1) / kRows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_floats(g, kGrad) * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, supcon_kernel<kGrad, kCpl>, a, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool shape_ok(int M, int d) { return M >= 1 && M <= kMaxAnchors && d >= 1 && d <= kMaxDim; }

}  // namespace

extern "C" {

const char* supcon_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest anchor count M the kernels take for projection width d (0: d not taken).
int supcon_max_anchors(int d) {
  return d >= 1 && d <= kMaxDim ? kMaxAnchors : 0;
}

// D1. z [M,d] f32, code [M,M] u8 -> loss, lse, pcount [M] f32.
int supcon_loss(const void* z, const void* code, int M, int d, float tau,
                void* loss, void* lse, void* pcount, void* stream) {
  if (!shape_ok(M, d)) return (int)cudaErrorInvalidValue;
  Args a = {static_cast<const float*>(z), static_cast<const uint8_t*>(code),
            static_cast<float*>(loss), static_cast<float*>(lse),
            static_cast<float*>(pcount), nullptr, nullptr};
  return launch<false, 2>(a, M, d, tau, stream);
}

// D2. z [M,d] f32, code [M,M] u8, D1's lse and pcount [M], g [1] (the
// cotangent of the mean loss) -> dz [M,d] f32.
int supcon_dz(const void* z, const void* code, const void* lse, const void* pcount,
              const void* g, int M, int d, float tau, void* dz, void* stream) {
  Args a = {static_cast<const float*>(z), static_cast<const uint8_t*>(code), nullptr,
            const_cast<float*>(static_cast<const float*>(lse)),
            const_cast<float*>(static_cast<const float*>(pcount)),
            static_cast<const float*>(g), static_cast<float*>(dz)};
  if (!shape_ok(M, d)) return (int)cudaErrorInvalidValue;
  return d <= 256 ? launch<true, 2>(a, M, d, tau, stream) : launch<true, 4>(a, M, d, tau, stream);
}

}  // extern "C"
