// Chain-side factorize of the multistage dual Hessian, one thread per chain.
//
// Replaces the Pallas kernels chain_blocks_factor and
// chain_blocks_factor_lanes of treeqp_tpu/ops/chain_kernels.py (chain block
// build + Jacobi equilibration + banded backward block Cholesky in one
// launch). The TPU kernels put 128 chains on the vector lanes; here each
// thread owns one chain and walks it sequentially, which is the natural
// mapping of this dependent, tiny (nx <= 16) per-step work. The two kernels
// share the body chain_factor_one and differ only in where the parent's
// masked inverses ztp_j come from:
//   chain_blocks_factor:       ztp [S, L, nz] given;
//   chain_blocks_factor_lanes: ztp_0 = ztp_root[s] (the crown root's),
//                              ztp_j = (qt, rt)_{j-1} of the chain evaluation
//                              for j >= 1, read in place.
//
// Per chain node j (edge dynamics AB_j = [A_j B_j] into node j):
//   W_j  = AB_j diag(ztp_j) AB_j' + diag(qtc_j)
//   sc_j = rsqrt(max(diag W_j, 1e-12)),  W_j <- diag(sc_j) W_j diag(sc_j)
//   Ut_j = -diag(ztp_j[:nx]) A_j',       Ut_j <- diag(sc_{j-1}) Ut_j diag(sc_j)
//                                         (sc_{-1} = s_root, the crown scale)
// then for j = L-1 .. 0:
//   Ls_j = chol(W_j - schur),  CUs_j = Ut_j Ls_j^-T,  schur = CUs_j CUs_j'
// and schur0 = the last schur (in the crown's scale).
//
// What bounds it on the card: latency. The work is ~L (nx^3/3 + nx^2 nz)
// flops per chain, ~25k at the quadcopter shapes, done serially by one
// thread, so one launch is a few thousand dependent f32 operations long and
// uses S threads (256 at the headline tree: 2 of 132 SMs). The scaled
// blocks are staged in the output buffers (Ls holds W_j, CUs holds Ut_j,
// schur0 holds the running Schur block) so the kernel needs no local
// arrays; every access hits L1/L2. Spreading one chain's block over a warp
// is the next step, for a later change.

#include "tq_chain.cuh"

namespace {

// ztp_j of chain s given as a stacked [S, L, nz] array.
struct ZtpStacked {
  const float* ztp;
  int L, nz;
  __device__ float operator()(int s, int j, int n) const {
    return ztp[((size_t)s * L + j) * nz + n];
  }
};

// ztp_j assembled from the chain evaluation's masked inverses.
struct ZtpLanes {
  const float* root;  // [S, nz]
  const float* qt;    // [S, L, nx]
  const float* rt;    // [S, L, nu]
  int L, nx, nu;
  __device__ float operator()(int s, int j, int n) const {
    if (j == 0) return root[(size_t)s * (nx + nu) + n];
    const size_t sp = (size_t)s * L + j - 1;
    return n < nx ? qt[sp * nx + n] : rt[sp * nu + n - nx];
  }
};

template <class Ztp>
__device__ void chain_factor_one(
    int s, const float* __restrict__ ABt, const Ztp& zt,
    const float* __restrict__ qtc, const float* __restrict__ s_root,
    float* __restrict__ Ls, float* __restrict__ CUs,
    float* __restrict__ schur0, float* __restrict__ sc, int L, int nx, int nz) {
  const int nn = nx * nx;

  // pass 1 (forward): scaled blocks and scales
  const float* scp = s_root + (size_t)s * nx;
  for (int j = 0; j < L; ++j) {
    const size_t sj = (size_t)s * L + j;
    const float* AB = ABt + sj * nx * nz;
    const float* qc = qtc + sj * nx;
    float* W = Ls + sj * nn;
    float* Ut = CUs + sj * nn;
    float* scj = sc + sj * nx;
    for (int i = 0; i < nx; ++i) {
      for (int c = 0; c < nx; ++c) {
        float w = 0.f;
        for (int n = 0; n < nz; ++n) w += (AB[i * nz + n] * zt(s, j, n)) * AB[c * nz + n];
        W[i * nx + c] = (i == c) ? w + qc[i] : w;
      }
    }
    for (int i = 0; i < nx; ++i) scj[i] = rsqrtf(fmaxf(W[i * nx + i], 1e-12f));
    for (int i = 0; i < nx; ++i)
      for (int c = 0; c < nx; ++c) W[i * nx + c] = W[i * nx + c] * scj[i] * scj[c];
    for (int i = 0; i < nx; ++i)
      for (int c = 0; c < nx; ++c)
        Ut[i * nx + c] = -(zt(s, j, i) * AB[c * nz + i]) * scp[i] * scj[c];
    scp = scj;
  }

  // pass 2 (backward): banded block Cholesky (shared with chain_factor.cu)
  tq::chain_factor_bwd(Ls + (size_t)s * L * nn, CUs + (size_t)s * L * nn,
                       schur0 + (size_t)s * nn, L, nx);
}

__global__ void chain_blocks_factor_kernel(
    const float* __restrict__ ABt, const float* __restrict__ ztp,
    const float* __restrict__ qtc, const float* __restrict__ s_root,
    float* __restrict__ Ls, float* __restrict__ CUs,
    float* __restrict__ schur0, float* __restrict__ sc,
    int S, int L, int nx, int nz) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  chain_factor_one(s, ABt, ZtpStacked{ztp, L, nz}, qtc, s_root, Ls, CUs,
                   schur0, sc, L, nx, nz);
}

__global__ void chain_blocks_factor_lanes_kernel(
    const float* __restrict__ ABt, const float* __restrict__ qt,
    const float* __restrict__ rt, const float* __restrict__ ztp_root,
    const float* __restrict__ s_root,
    float* __restrict__ Ls, float* __restrict__ CUs,
    float* __restrict__ schur0, float* __restrict__ sc,
    int S, int L, int nx, int nz) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  chain_factor_one(s, ABt, ZtpLanes{ztp_root, qt, rt, L, nx, nz - nx}, qt,
                   s_root, Ls, CUs, schur0, sc, L, nx, nz);
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int tq_chain_blocks_factor(
    const float* ABt, const float* ztp, const float* qtc, const float* s_root,
    float* Ls, float* CUs, float* schur0, float* sc,
    int S, int L, int nx, int nz, void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  chain_blocks_factor_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ABt, ztp, qtc, s_root, Ls, CUs, schur0, sc, S, L, nx, nz);
  return (int)cudaGetLastError();
}

extern "C" int tq_chain_blocks_factor_lanes(
    const float* ABt, const float* qt, const float* rt, const float* ztp_root,
    const float* s_root, float* Ls, float* CUs, float* schur0, float* sc,
    int S, int L, int nx, int nz, void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  chain_blocks_factor_lanes_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ABt, qt, rt, ztp_root, s_root, Ls, CUs, schur0, sc, S, L, nx, nz);
  return (int)cudaGetLastError();
}
