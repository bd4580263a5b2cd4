// Cyclic-reduction (parallel-scan) variants of the chain solve sweeps, with
// chain_factor's factors Ls, CUs [S, L, n, n].
//
// Replaces the Pallas kernels chain_cr_precompute, chain_solve_bwd_cr and
// chain_forward_cr of treeqp_tpu/ops/chain_cr.py. The serial sweeps
// (chain_sweeps.cu) are L dependent triangular steps; written as affine
// recurrences
//   bwd: y_j = b_j + A_j y_{j+1},  A_j = -L_j^-1 CU_{j+1} (A_{L-1} = 0),
//        b_j = L_j^-1 r_j;
//   fwd: d_j = c_j + B_j d_{j-1},  B_j = -L_j^-T CU_j',
//        c_j = L_j^-T y_j, with B_0 droot folded into c_0,
// they are a suffix and a prefix scan: ceil(log2 L) doubling levels of
// independent n x n compositions. A and B depend only on the factors and
// are built once per factorization (chain_cr_precompute).
//
// Layout for this card, not the Pallas lane layout:
// - precompute: one thread per (scenario, j, column k), two triangular
//   solves against L_j (column k of A_j and of B_j);
// - sweeps: one block per scenario. The operators and vectors of the
//   chain stay in shared memory, double-buffered: a level reads one buffer
//   and writes the other, then __syncthreads(). Threads take the (j, row)
//   pairs; entries past the end of the chain are zero, as in the Pallas
//   kernels' _doubling_suffix / _doubling_prefix. Any L (the caller passes
//   a global scratch for the buffers when they exceed the 227 KB of shared
//   memory one block may take), n <= 16.
// Sums run in index order, like the plain twins (up to FMA contraction).

#include "tq_dense.cuh"

namespace {

constexpr int kThreadsPre = 128;

__global__ void chain_cr_precompute_kernel(const float* __restrict__ Ls,
                                           const float* __restrict__ CUs,
                                           float* __restrict__ Abwd,
                                           float* __restrict__ Bfwd, int S, int L,
                                           int n) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)S * L * n) return;
  const int k = (int)(t % n);
  const long sj = t / n;  // s * L + j
  const int j = (int)(sj % L);
  const size_t nn = (size_t)n * n;
  const float* Lj = Ls + sj * nn;
  float v[tq::kMaxN];
  // column k of A_j = -L_j^-1 CU_{j+1}
  if (j < L - 1) {
    for (int i = 0; i < n; ++i) v[i] = CUs[(sj + 1) * nn + i * n + k];
    tq::ltrsv_inplace(Lj, v, n);
    for (int i = 0; i < n; ++i) Abwd[sj * nn + i * n + k] = -v[i];
  } else {
    for (int i = 0; i < n; ++i) Abwd[sj * nn + i * n + k] = 0.f;
  }
  // column k of B_j = -L_j^-T CU_j': row k of CU_j
  for (int i = 0; i < n; ++i) v[i] = CUs[sj * nn + k * n + i];
  tq::uttrsv_inplace(Lj, v, n);
  for (int i = 0; i < n; ++i) Bfwd[sj * nn + i * n + k] = -v[i];
}

// One doubling level over the (j, row) pairs: with the partner p(j) = j + h
// (suffix) or j - h (prefix),
//   vn_j = v_j + M_j v_{p(j)},  Mn_j = M_j M_{p(j)}
// where p(j) lies in the chain, else vn_j = v_j, Mn_j = 0. The operator is
// not composed on the last level (``last``): nothing reads it after.
__device__ inline void doubling_level(const float* __restrict__ M,
                                      float* __restrict__ Mn,
                                      const float* __restrict__ v,
                                      float* __restrict__ vn, int L, int n, int h,
                                      bool suffix, bool last) {
  const int nn = n * n;
  for (int p = threadIdx.x; p < L * n; p += blockDim.x) {
    const int j = p / n, i = p % n;
    const int q = suffix ? j + h : j - h;
    const float* Mji = M + j * nn + i * n;
    if (q >= 0 && q < L) {
      float acc = 0.f;
      for (int m = 0; m < n; ++m) acc += Mji[m] * v[q * n + m];
      vn[p] = v[p] + acc;
      if (!last) {
        const float* Mq = M + q * nn;
        for (int k = 0; k < n; ++k) {
          float c = 0.f;
          for (int m = 0; m < n; ++m) c += Mji[m] * Mq[m * n + k];
          Mn[j * nn + i * n + k] = c;
        }
      }
    } else {
      vn[p] = v[p];
      if (!last)
        for (int k = 0; k < n; ++k) Mn[j * nn + i * n + k] = 0.f;
    }
  }
}

// The scan of one chain, with its operators [L, n, n] at the start of
// ``buf`` and its vectors after the two operator buffers; returns the
// vector buffer that holds the result.
__device__ inline float* doubling_scan(float* buf, int L, int n, bool suffix) {
  const int nn = n * n;
  float* M = buf;
  float* Mn = buf + (size_t)L * nn;
  float* v = Mn + (size_t)L * nn;
  float* vn = v + (size_t)L * n;
  for (int h = 1; h < L; h *= 2) {
    doubling_level(M, Mn, v, vn, L, n, h, suffix, 2 * h >= L);
    __syncthreads();
    float* t = M;
    M = Mn;
    Mn = t;
    t = v;
    v = vn;
    vn = t;
  }
  return v;
}

__device__ inline float* block_buffer(float* scratch, size_t per) {
  extern __shared__ float smem[];
  return scratch != nullptr ? scratch + (size_t)blockIdx.x * per : smem;
}

__global__ void chain_solve_bwd_cr_kernel(
    const float* __restrict__ Ls, const float* __restrict__ CUs,
    const float* __restrict__ Abwd, const float* __restrict__ res,
    float* __restrict__ ys, float* __restrict__ radd0, float* scratch, int L,
    int n) {
  const int s = blockIdx.x;
  const size_t nn = (size_t)n * n;
  const size_t chain = (size_t)L * nn, vec = (size_t)L * n;
  float* buf = block_buffer(scratch, 2 * (chain + vec));
  float* v = buf + 2 * chain;
  for (size_t e = threadIdx.x; e < chain; e += blockDim.x) buf[e] = Abwd[s * chain + e];
  // b_j = L_j^-1 r_j, independent over j
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    float* bj = v + (size_t)j * n;
    for (int i = 0; i < n; ++i) bj[i] = res[s * vec + (size_t)j * n + i];
    tq::ltrsv_inplace(Ls + s * chain + j * nn, bj, n);
  }
  __syncthreads();
  const float* y = doubling_scan(buf, L, n, true);
  for (size_t p = threadIdx.x; p < vec; p += blockDim.x) ys[s * vec + p] = y[p];
  // radd0 = CU_0 y_0
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc += CUs[s * chain + i * n + k] * y[k];
    radd0[(size_t)s * n + i] = acc;
  }
}

__global__ void chain_forward_cr_kernel(
    const float* __restrict__ Ls, const float* __restrict__ Bfwd,
    const float* __restrict__ ys, const float* __restrict__ droot,
    float* __restrict__ dls, float* scratch, int L, int n) {
  const int s = blockIdx.x;
  const size_t nn = (size_t)n * n;
  const size_t chain = (size_t)L * nn, vec = (size_t)L * n;
  float* buf = block_buffer(scratch, 2 * (chain + vec));
  float* v = buf + 2 * chain;
  for (size_t e = threadIdx.x; e < chain; e += blockDim.x) buf[e] = Bfwd[s * chain + e];
  // c_j = L_j^-T y_j, independent over j
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    float* cj = v + (size_t)j * n;
    for (int i = 0; i < n; ++i) cj[i] = ys[s * vec + (size_t)j * n + i];
    tq::uttrsv_inplace(Ls + s * chain + j * nn, cj, n);
  }
  __syncthreads();
  // the root term: c_0 += B_0 droot
  if (threadIdx.x < n) {
    float acc = 0.f;
    for (int m = 0; m < n; ++m) acc += buf[threadIdx.x * n + m] * droot[(size_t)s * n + m];
    v[threadIdx.x] += acc;
  }
  __syncthreads();
  const float* d = doubling_scan(buf, L, n, false);
  for (size_t p = threadIdx.x; p < vec; p += blockDim.x) dls[s * vec + p] = d[p];
}

// threads of a sweep block: the (j, row) pairs, whole warps, at most 1024
int sweep_threads(int L, int n) {
  const int pairs = L * n;
  const int t = (pairs + 31) / 32 * 32;
  return t < 1024 ? t : 1024;
}

// dynamic shared memory of a sweep block, or 0 when the buffers go to the
// caller's scratch; sets the opt-in above 48 KB
template <typename K>
int sweep_smem(K kernel, int L, int n, const float* scratch) {
  if (scratch != nullptr) return 0;
  const int bytes = 2 * (L * n * n + L * n) * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  return bytes;
}

}  // namespace

// Ls, CUs, Abwd, Bfwd, S, L, n, stream
extern "C" int tq_chain_cr_precompute(const float* Ls, const float* CUs, float* Abwd,
                                      float* Bfwd, int S, int L, int n, void* stream) {
  const long threads = (long)S * L * n;
  const int blocks = (int)((threads + kThreadsPre - 1) / kThreadsPre);
  chain_cr_precompute_kernel<<<blocks, kThreadsPre, 0, (cudaStream_t)stream>>>(
      Ls, CUs, Abwd, Bfwd, S, L, n);
  return (int)cudaGetLastError();
}

// Ls, CUs, Abwd, res, ys, radd0, scratch (NULL: shared memory), S, L, n, stream
extern "C" int tq_chain_solve_bwd_cr(const float* Ls, const float* CUs,
                                     const float* Abwd, const float* res, float* ys,
                                     float* radd0, float* scratch, int S, int L, int n,
                                     void* stream) {
  const int smem = sweep_smem(chain_solve_bwd_cr_kernel, L, n, scratch);
  chain_solve_bwd_cr_kernel<<<S, sweep_threads(L, n), smem, (cudaStream_t)stream>>>(
      Ls, CUs, Abwd, res, ys, radd0, scratch, L, n);
  return (int)cudaGetLastError();
}

// Ls, Bfwd, ys, droot, dls, scratch (NULL: shared memory), S, L, n, stream
extern "C" int tq_chain_forward_cr(const float* Ls, const float* Bfwd, const float* ys,
                                   const float* droot, float* dls, float* scratch,
                                   int S, int L, int n, void* stream) {
  const int smem = sweep_smem(chain_forward_cr_kernel, L, n, scratch);
  chain_forward_cr_kernel<<<S, sweep_threads(L, n), smem, (cudaStream_t)stream>>>(
      Ls, Bfwd, ys, droot, dls, scratch, L, n);
  return (int)cudaGetLastError();
}
