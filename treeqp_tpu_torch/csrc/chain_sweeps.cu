// The two solve sweeps of the chain factors, one thread per chain: the
// chain half of the generic tree Cholesky's split-path solve.
//
// Replaces the Pallas kernels chain_solve_bwd and chain_forward of
// treeqp_tpu/ops/chain_kernels.py (reached through
// tdunes_multistage._chain_solve_bwd / _chain_forward from
// tdunes._tree_chol_solve_split), with chain_factor's factors
// Ls, CUs [S, L, n, n]:
//   chain_solve_bwd: ys_j = Ls_j^-1 (r_j - CUs_{j+1} ys_{j+1}) for
//     j = L-1 .. 0, and radd0 = CUs_0 ys_0, the update of each chain's
//     crown parent right-hand side;
//   chain_forward: dl_j = Ls_j^-T (ys_j - CUs_j' dl_{j-1}) for j = 0 .. L-1,
//     from dl_{-1} = droot, the crown's direction at the chain's edge.
// Between the two the crown is solved (crown_solve.cu). The per-chain
// bodies are tq_chain.cuh's, which system_solve.cu runs as its phases 1
// and 5.
//
// What bounds it on the card: latency. Each sweep is L dependent n x n
// triangular solves and products per thread (~2 L n^2 flops, ~1.2k at the
// quadcopter's L = 16, n = 6) on S threads, and each launch moves only
// the factors once (S L n^2 f32 each, 0.3 MB at 128 chains). The vectors
// stay in the output buffers and registers.

#include "tq_chain.cuh"

namespace {

__global__ void chain_solve_bwd_kernel(
    const float* __restrict__ Ls, const float* __restrict__ CUs,
    const float* __restrict__ res, float* __restrict__ ys,
    float* __restrict__ radd0, int S, int L, int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t chain = (size_t)L * n * n;
  const size_t vec = (size_t)L * n;
  tq::chain_solve_bwd_one(Ls + s * chain, CUs + s * chain, res + s * vec,
                          ys + s * vec, radd0 + (size_t)s * n, L, n);
}

__global__ void chain_forward_kernel(
    const float* __restrict__ Ls, const float* __restrict__ CUs,
    const float* __restrict__ ys, const float* __restrict__ droot,
    float* __restrict__ dls, int S, int L, int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t chain = (size_t)L * n * n;
  const size_t vec = (size_t)L * n;
  for (size_t k = 0; k < vec; ++k) dls[s * vec + k] = ys[s * vec + k];
  float dp[tq::kMaxN];
  for (int i = 0; i < n; ++i) dp[i] = droot[(size_t)s * n + i];
  tq::chain_forward_one(Ls + s * chain, CUs + s * chain, dls + s * vec, dp, L, n);
}

constexpr int kThreads = 128;

}  // namespace

// Ls, CUs, res, ys, radd0, S, L, n, stream
extern "C" int tq_chain_solve_bwd(const float* Ls, const float* CUs,
                                  const float* res, float* ys, float* radd0,
                                  int S, int L, int n, void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  chain_solve_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      Ls, CUs, res, ys, radd0, S, L, n);
  return (int)cudaGetLastError();
}

// Ls, CUs, ys, droot, dls, S, L, n, stream
extern "C" int tq_chain_forward(const float* Ls, const float* CUs,
                                const float* ys, const float* droot, float* dls,
                                int S, int L, int n, void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  chain_forward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      Ls, CUs, ys, droot, dls, S, L, n);
  return (int)cudaGetLastError();
}
