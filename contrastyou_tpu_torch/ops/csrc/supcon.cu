// Fused supervised-contrastive (SupCon / InfoNCE) loss and its gradient
// (f32 in, f32 math).
//
//   D1 supcon_loss  replaces contrastyou_tpu/ops/pallas/infonce.py _loss_kernel:
//                   for every anchor row i of z [M,d], s_ij = <z_i, z_j> / tau,
//                   the log-sum-exp of s_i over the columns its masks allow
//                   (stabilised by max(masked row max, 0), as the TPU kernel
//                   does) and the mean of (s_ij - lse_i) over its positives:
//                   loss_i = -sum_j pos_ij (s_ij - lse_i) / max(#pos_i, 1).
//                   Besides the loss it writes two residuals per row for D2:
//                   the log of the softmax denominator (row max folded in) and
//                   the positive count.
//   D2 supcon_dz    replaces infonce.py _bwd_kernel: with G_ij = -(a_ij - w_i
//                   p_ij) / M (p the masked row softmax, a = pos / max(#pos, 1),
//                   w = sum_j a_ij), dz = (G z + G^T z) / tau * g. One block owns
//                   a set of output rows k and forms dz_k = sum_j (G_kj + G_jk)
//                   z_j / tau * g: s is symmetric, so G_jk comes from s_kj and
//                   row j's saved residuals. No atomics (deterministic), no
//                   [M,M] tensor in device memory.
//
// Masks travel as one byte per pair: bit 0 = positive, bit 1 = negative (the
// pos / neg masks of the loss, diagonal already cleared).
//
// What bounds it on the H100: at the pretrain shapes (M <= 256 anchors, d =
// 256) the work is at most 2*M*M*d = 34 MFLOP and ~0.33 MB of traffic, well
// under a microsecond at the card's peaks, so a launch is bound by its own
// latency (launch, one pass over z per block, the block reductions). The
// design keeps the TPU kernel's property that only O(M) numbers leave a
// block: a block of 8 anchor rows stages its rows and 16-row tiles of z in
// shared memory, keeps its [8, M] similarity rows in shared memory, and does
// the masked reductions there with warp shuffles. FP32 cores, no tensor cores
// (the loss is defined in f32; TF32 would not hold it to 1e-5).
//
// Every entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;         // anchor rows per block
constexpr int kCols = 16;        // rows of z per shared tile
constexpr int kThreads = 128;    // kRows x kCols threads, 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 4;         // dz columns per thread: d <= kMaxQ * kThreads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory of one block (floats): the block's rows [kRows][d+1], a z tile
// [kCols][d+1] (rows padded by one float against bank conflicts) and the
// similarity rows [kRows][M].
__host__ __device__ inline size_t smem_bytes(int M, int d) {
  return sizeof(float) * ((size_t)(kRows + kCols) * (d + 1) + (size_t)kRows * M);
}

// srow[r][j] = <z_{row0+r}, z_j> / tau for the block's rows and every column j.
__device__ void block_sims(const float* __restrict__ z, int M, int d, int row0,
                           float tau, float* zr, float* zc, float* srow) {
  const int tid = threadIdx.x;
  const int ld = d + 1;
  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, k = i - r * d;
    zr[r * ld + k] = row0 + r < M ? z[(size_t)(row0 + r) * d + k] : 0.f;
  }
  const int r = tid / kCols, c = tid % kCols;
  for (int j0 = 0; j0 < M; j0 += kCols) {
    __syncthreads();                       // rows staged / last tile consumed
    for (int i = tid; i < kCols * d; i += kThreads) {
      const int cc = i / d, k = i - cc * d;
      zc[cc * ld + k] = j0 + cc < M ? z[(size_t)(j0 + cc) * d + k] : 0.f;
    }
    __syncthreads();
    const float* x = zr + r * ld;
    const float* y = zc + c * ld;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(x[k], y[k], acc);
    if (j0 + c < M) srow[r * M + j0 + c] = acc / tau;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
supcon_loss_kernel(const float* __restrict__ z, const uint8_t* __restrict__ code,
                   int M, int d, float tau, float* __restrict__ loss,
                   float* __restrict__ lse, float* __restrict__ pcount) {
  extern __shared__ float smem[];
  float* zr = smem;
  float* zc = zr + kRows * (d + 1);
  float* srow = zc + kCols * (d + 1);
  const int row0 = blockIdx.x * kRows;
  block_sims(z, M, d, row0, tau, zr, zc, srow);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const int i = row0 + r;
    if (i >= M) break;
    const float* s = srow + r * M;
    const uint8_t* m = code + (size_t)i * M;
    float mx = kNegInf;
    for (int j = lane; j < M; j += 32)
      if (m[j] & 3) mx = fmaxf(mx, s[j]);
    mx = fmaxf(warp_max(mx), -0.f);        // rows with no mask -> 0 (TPU kernel)
    float den = 0.f, pc = 0.f;
    for (int j = lane; j < M; j += 32) {
      if (m[j] & 3) den += expf(s[j] - mx);
      if (m[j] & 1) pc += 1.f;
    }
    den = warp_sum(den);
    pc = warp_sum(pc);
    const float log_den = logf(den + 1e-16f) + mx;
    float acc = 0.f;
    for (int j = lane; j < M; j += 32)
      if (m[j] & 1) acc += s[j] - log_den;
    acc = warp_sum(acc);
    if (lane == 0) {
      loss[i] = -acc / fmaxf(pc, 1.f);
      lse[i] = mx + logf(fmaxf(den, 1e-16f));
      pcount[i] = pc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
supcon_dz_kernel(const float* __restrict__ z, const uint8_t* __restrict__ code,
                 const float* __restrict__ lse, const float* __restrict__ pcount,
                 const float* __restrict__ g, int M, int d, float tau,
                 float* __restrict__ dz) {
  extern __shared__ float smem[];
  float* zr = smem;
  float* zc = zr + kRows * (d + 1);
  float* srow = zc + kCols * (d + 1);
  const int row0 = blockIdx.x * kRows;
  block_sims(z, M, d, row0, tau, zr, zc, srow);

  // srow[r][j] <- G_kj + G_jk, k = row0 + r
  const float inv_m = 1.f / (float)M;
  for (int i = threadIdx.x; i < kRows * M; i += kThreads) {
    const int r = i / M, j = i - r * M, k = row0 + r;
    if (k >= M) continue;
    const float s = srow[i];
    const uint8_t ckj = code[(size_t)k * M + j], cjk = code[(size_t)j * M + k];
    const float ipk = 1.f / fmaxf(pcount[k], 1.f), ipj = 1.f / fmaxf(pcount[j], 1.f);
    const float pkj = (ckj & 3) ? expf(s - lse[k]) : 0.f;
    const float pjk = (cjk & 3) ? expf(s - lse[j]) : 0.f;
    const float akj = (ckj & 1) ? ipk : 0.f, ajk = (cjk & 1) ? ipj : 0.f;
    const float gkj = -(akj - pcount[k] * ipk * pkj) * inv_m;
    const float gjk = -(ajk - pcount[j] * ipj * pjk) * inv_m;
    srow[i] = gkj + gjk;
  }

  // dz[k, c] = sum_j srow[r][j] z[j, c] / tau * g, z tiles through zc (stride d)
  float acc[kMaxQ][kRows];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[q][r] = 0.f;
  for (int j0 = 0; j0 < M; j0 += kCols) {
    __syncthreads();                       // srow written / last tile consumed
    const int rows = min(kCols, M - j0);
    for (int i = threadIdx.x; i < rows * d; i += kThreads)
      zc[i] = z[(size_t)j0 * d + i];
    __syncthreads();
    for (int jj = 0; jj < rows; ++jj) {
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int c = threadIdx.x + q * kThreads;
        if (c < d) {
          const float zv = zc[jj * d + c];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[q][r] = fmaf(srow[r * M + j0 + jj], zv, acc[q][r]);
        }
      }
    }
  }
  const float gs = *g;
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    const int c = threadIdx.x + q * kThreads;
    if (c >= d) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < M) dz[(size_t)(row0 + r) * d + c] = acc[q][r] / tau * gs;
  }
}

template <typename K>
int prepare(K kernel, int M, int d, size_t& bytes) {
  if (M < 1 || d < 1 || d > kMaxQ * kThreads) return (int)cudaErrorInvalidValue;
  bytes = smem_bytes(M, d);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* supcon_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest anchor count M the kernels take for projection width d (shared memory).
int supcon_max_anchors(int d) {
  const size_t cap = 227 * 1024;
  const size_t fixed = sizeof(float) * (size_t)(kRows + kCols) * (d + 1);
  return fixed >= cap ? 0 : (int)((cap - fixed) / (sizeof(float) * kRows));
}

// D1. z [M,d] f32, code [M,M] u8 -> loss, lse, pcount [M] f32.
int supcon_loss(const void* z, const void* code, int M, int d, float tau,
                void* loss, void* lse, void* pcount, void* stream) {
  size_t bytes = 0;
  int rc = prepare(supcon_loss_kernel, M, d, bytes);
  if (rc) return rc;
  const int blocks = (M + kRows - 1) / kRows;
  supcon_loss_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const uint8_t*>(code), M, d, tau,
      static_cast<float*>(loss), static_cast<float*>(lse), static_cast<float*>(pcount));
  return (int)cudaGetLastError();
}

// D2. z [M,d] f32, code [M,M] u8, D1's lse and pcount [M], g [1] (the
// cotangent of the mean loss) -> dz [M,d] f32.
int supcon_dz(const void* z, const void* code, const void* lse, const void* pcount,
              const void* g, int M, int d, float tau, void* dz, void* stream) {
  size_t bytes = 0;
  int rc = prepare(supcon_dz_kernel, M, d, bytes);
  if (rc) return rc;
  const int blocks = (M + kRows - 1) / kRows;
  supcon_dz_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const uint8_t*>(code),
      static_cast<const float*>(lse), static_cast<const float*>(pcount),
      static_cast<const float*>(g), M, d, tau, static_cast<float*>(dz));
  return (int)cudaGetLastError();
}

}  // extern "C"
