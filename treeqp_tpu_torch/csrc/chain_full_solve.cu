// Multi-right-hand-side full solve of self-contained chains, one thread per
// (chain, column): the banded per-scenario dual-Hessian solve of sdunes.
//
// Replaces the Pallas kernel chain_full_solve_mat of
// treeqp_tpu/ops/chain_kernels.py (reached through sdunes._sd_full_solve),
// with chain_factor's factors Ls, CUs [S, L, n, n] of chains whose node 0
// has no parent coupling (CUs_0 = 0), and rhs [S, L, n, m]:
//   backward  y_j = Ls_j^-1 (r_j - CUs_{j+1} y_{j+1})   for j = L-1 .. 0,
//   forward   z_j = Ls_j^-T (y_j - CUs_j' z_{j-1})      for j = 0 .. L-1,
// both sweeps in one launch, y kept in z between them. The m columns are
// independent, so each thread sweeps one column of one chain; the column
// stride in rhs and z is m. Same operation order as the Pallas kernel and
// the plain twin (chain_kernels.chain_full_solve_mat_ref): every sum term
// by term in index order.
//
// What bounds it on the card: latency. Each thread runs 2L dependent n x n
// triangular solves and products (~6 n^2 L flops, ~7.7k at sdunes' L = 20,
// n = 8) and the launch moves the factors once (2 S L n^2 f32, 2.6 MB at
// S = 256) plus rhs and z (0.8 MB at m = 5). The m threads of a chain read
// the same factor rows, which the L1 cache serves.

#include "tq_dense.cuh"

namespace {

__global__ void chain_full_solve_mat_kernel(
    const float* __restrict__ Ls, const float* __restrict__ CUs,
    const float* __restrict__ rhs, float* __restrict__ z, int S, int L, int n, int m) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * m) return;
  const int s = t / m;
  const int c = t % m;
  const size_t nn = (size_t)n * n;
  const float* Lc = Ls + (size_t)s * L * nn;
  const float* CUc = CUs + (size_t)s * L * nn;
  const float* rc = rhs + (size_t)s * L * n * m + c;
  float* zc = z + (size_t)s * L * n * m + c;
  float acc[tq::kMaxN];
  float y[tq::kMaxN];
  for (int i = 0; i < n; ++i) acc[i] = 0.f;
  for (int j = L - 1; j >= 0; --j) {
    const float* Lj = Lc + j * nn;
    const float* CU = CUc + j * nn;
    for (int i = 0; i < n; ++i) {
      float a = rc[((size_t)j * n + i) * m] - acc[i];
      for (int k = 0; k < i; ++k) a = a - Lj[i * n + k] * y[k];
      y[i] = a / Lj[i * n + i];
    }
    for (int i = 0; i < n; ++i) {
      zc[((size_t)j * n + i) * m] = y[i];
      float a = 0.f;
      for (int k = 0; k < n; ++k) a += CU[i * n + k] * y[k];
      acc[i] = a;
    }
  }
  // forward sweep from z_{-1} = 0, y_j read back from z
  float* zp = acc;
  for (int i = 0; i < n; ++i) zp[i] = 0.f;
  for (int j = 0; j < L; ++j) {
    const float* Lj = Lc + j * nn;
    const float* CU = CUc + j * nn;
    for (int i = 0; i < n; ++i) {
      float a = 0.f;
      for (int k = 0; k < n; ++k) a += CU[k * n + i] * zp[k];
      y[i] = zc[((size_t)j * n + i) * m] - a;
    }
    for (int i = n - 1; i >= 0; --i) {
      float a = y[i];
      for (int k = i + 1; k < n; ++k) a = a - Lj[k * n + i] * y[k];
      y[i] = a / Lj[i * n + i];
    }
    for (int i = 0; i < n; ++i) {
      zc[((size_t)j * n + i) * m] = y[i];
      zp[i] = y[i];
    }
  }
}

constexpr int kThreads = 128;

}  // namespace

// Ls, CUs, rhs, z, S, L, n, m, stream
extern "C" int tq_chain_full_solve_mat(const float* Ls, const float* CUs, const float* rhs,
                                       float* z, int S, int L, int n, int m,
                                       void* stream) {
  const int blocks = (S * m + kThreads - 1) / kThreads;
  chain_full_solve_mat_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      Ls, CUs, rhs, z, S, L, n, m);
  return (int)cudaGetLastError();
}
