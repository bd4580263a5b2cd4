// Banded backward block Cholesky of given chain blocks, one thread per
// chain: the chain half of the generic tree Cholesky's split path.
//
// Replaces the Pallas kernel chain_factor of treeqp_tpu/ops/chain_kernels.py
// (reached through tdunes_multistage._chain_factor from
// tdunes._tree_chol_factor_split). Input: the equilibrated chain blocks
// Wc [S, L, n, n] (the caller has added the LM shift reg I) and couplings
// Utc [S, L, n, n], j = 0 the chain node next to the crown. Output, per
// chain: Ls_j = chol(W_j - schur), CUs_j = Ut_j Ls_j^-T for j = L-1 .. 0
// (schur = CUs_{j+1} CUs_{j+1}', pivot rule a_kk rsqrt(max(a_kk, 1e-8)) as
// the Pallas _chol, no shift), and schur0 [S, n, n] = CUs_0 CUs_0', the
// Schur block that flows into the crown. The backward loop is
// tq::chain_factor_bwd (tq_chain.cuh), which chain_blocks_factor.cu runs
// after its block build.
//
// What bounds it on the card: latency. Each thread walks its chain's L
// dependent n x n factorizations (~L (n^3/3 + n^3) flops, ~6k at the
// quadcopter's L = 16, n = 6), so a launch is a few thousand dependent f32
// operations long on S threads (128 chains at the pruned quadcopter(4,4,20):
// one SM). The TPU kernel put 128 chains on the vector lanes; one thread per
// chain is the natural mapping of this serial work on a GPU. The blocks are
// copied into the output buffers and factored there (L1/L2 resident), so the
// kernel needs no local arrays. A warp per chain is the next step.

#include "tq_chain.cuh"

namespace {

__global__ void chain_factor_kernel(
    const float* __restrict__ Wc, const float* __restrict__ Utc,
    float* __restrict__ Ls, float* __restrict__ CUs, float* __restrict__ schur0,
    int S, int L, int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t nn = (size_t)n * n;
  const size_t off = (size_t)s * L * nn;
  for (size_t k = 0; k < L * nn; ++k) {
    Ls[off + k] = Wc[off + k];
    CUs[off + k] = Utc[off + k];
  }
  tq::chain_factor_bwd(Ls + off, CUs + off, schur0 + s * nn, L, n);
}

constexpr int kThreads = 128;

}  // namespace

// Wc, Utc, Ls, CUs, schur0, S, L, n, stream
extern "C" int tq_chain_factor(const float* Wc, const float* Utc, float* Ls,
                               float* CUs, float* schur0, int S, int L, int n,
                               void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  chain_factor_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      Wc, Utc, Ls, CUs, schur0, S, L, n);
  return (int)cudaGetLastError();
}
