// The multistage IPM's chain Riccati sweeps, one thread per scenario chain
// running the whole length-L sweep: factorize, backward right-hand side,
// forward.
//
// Replaces the Pallas kernels ric_chain_factor, ric_chain_bwd and
// ric_chain_fwd of treeqp_tpu/ops/riccati_kernels.py (reached through
// ipm_multistage.ipm_ms_solve on its f32-factored iterations with
// chain_backend="pallas"). Tensors are [S, L, ...], j = 0 the chain node
// next to the crown. Per stage the arithmetic is tq_riccati.cuh's:
//   factor, j = L-1 .. 0: M = hbar_j + W (hbar diagonal [nz] or dense
//     [nz, nz]: general C/D rows), the stage factors P, Lu, K, Mxu, and
//     W = AB_j' P AB_j; W0 = W after j = 0;
//   rhs, j = L-1 .. 0: m = rg_j + w, p, k and w = AB_j'(P rb_j + p);
//     w0 = w after j = 0;
//   forward, j = 0 .. L-1: from z_root (the crown's step at each chain
//     root's parent), dx = AB_j z + rb_j, du = K dx + k, dlam = P dx + p.
//
// What bounds it on the card: latency. Each thread runs L dependent
// stages of ~(nu^3/3 + 2 nu^2 nx + 2 nx^2 nu + 2 nx^2 nz + 2 nx nz^2)
// flops (~2.7k at nx = 8, nz = 9) with its blocks in a local-memory frame;
// S = 256 chains fill two blocks of 128 threads, two SMs. The TPU kernel
// put 128 chains on the vector lanes; a thread per chain is that mapping
// on a GPU, a warp per chain the next step.

#include "tq_riccati.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void ric_chain_factor_kernel(
    const float* __restrict__ hbar, const float* __restrict__ AB, float* __restrict__ P,
    float* __restrict__ Lu, float* __restrict__ K, float* __restrict__ Mxu,
    float* __restrict__ W0, int S, int L, int nx, int nz, int dense, float reg) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int nu = nz - nx, nn = nz * nz;
  float W[tq::kMaxN * tq::kMaxN];
  for (int e = 0; e < nn; ++e) W[e] = 0.f;
  for (int j = L - 1; j >= 0; --j) {
    const size_t sj = (size_t)s * L + j;
    if (dense) {
      const float* hb = hbar + sj * nn;
      for (int e = 0; e < nn; ++e) W[e] += hb[e];
    } else {
      const float* hb = hbar + sj * nz;
      for (int i = 0; i < nz; ++i) W[i * nz + i] += hb[i];
    }
    tq::ric_stage_factor(W, AB + sj * nx * nz, nx, nz, reg, P + sj * nx * nx,
                         Lu + sj * nu * nu, K + sj * nu * nx, Mxu + sj * nx * nu, W);
  }
  for (int e = 0; e < nn; ++e) W0[(size_t)s * nn + e] = W[e];
}

// The operand lists of the sweeps, passed by value (the host array of
// device pointers is copied into the launch's parameters).
struct Ops9 {
  const void* p[9];
};

// operands: P, Lu, Mxu, AB, rg, rb, p, k, w0
__global__ void ric_chain_bwd_kernel(Ops9 ops, int S, int L, int nx, int nz) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const float* P = static_cast<const float*>(ops.p[0]);
  const float* Lu = static_cast<const float*>(ops.p[1]);
  const float* Mxu = static_cast<const float*>(ops.p[2]);
  const float* AB = static_cast<const float*>(ops.p[3]);
  const float* rg = static_cast<const float*>(ops.p[4]);
  const float* rb = static_cast<const float*>(ops.p[5]);
  float* p = static_cast<float*>(const_cast<void*>(ops.p[6]));
  float* k = static_cast<float*>(const_cast<void*>(ops.p[7]));
  float* w0 = static_cast<float*>(const_cast<void*>(ops.p[8]));
  const int nu = nz - nx;
  float w[tq::kMaxN];
  for (int i = 0; i < nz; ++i) w[i] = 0.f;
  for (int j = L - 1; j >= 0; --j) {
    const size_t sj = (size_t)s * L + j;
    for (int i = 0; i < nz; ++i) w[i] = rg[sj * nz + i] + w[i];
    tq::ric_stage_bwd(w, P + sj * nx * nx, Lu + sj * nu * nu, Mxu + sj * nx * nu,
                      AB + sj * nx * nz, rb + sj * nx, nx, nz, p + sj * nx, k + sj * nu,
                      w);
  }
  for (int i = 0; i < nz; ++i) w0[(size_t)s * nz + i] = w[i];
}

// operands: P, K, AB, rb, p, k, z_root, dz, dl
__global__ void ric_chain_fwd_kernel(Ops9 ops, int S, int L, int nx, int nz) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const float* P = static_cast<const float*>(ops.p[0]);
  const float* K = static_cast<const float*>(ops.p[1]);
  const float* AB = static_cast<const float*>(ops.p[2]);
  const float* rb = static_cast<const float*>(ops.p[3]);
  const float* p = static_cast<const float*>(ops.p[4]);
  const float* k = static_cast<const float*>(ops.p[5]);
  const float* zroot = static_cast<const float*>(ops.p[6]);
  float* dz = static_cast<float*>(const_cast<void*>(ops.p[7]));
  float* dl = static_cast<float*>(const_cast<void*>(ops.p[8]));
  const int nu = nz - nx;
  const float* zp = zroot + (size_t)s * nz;
  for (int j = 0; j < L; ++j) {
    const size_t sj = (size_t)s * L + j;
    tq::ric_stage_fwd(zp, P + sj * nx * nx, K + sj * nu * nx, AB + sj * nx * nz,
                      rb + sj * nx, p + sj * nx, k + sj * nu, nx, nz, dz + sj * nz,
                      dl + sj * nx);
    zp = dz + sj * nz;
  }
}

Ops9 ops9(const void* const* p) {
  Ops9 o;
  for (int i = 0; i < 9; ++i) o.p[i] = p[i];
  return o;
}

}  // namespace

// hbar, AB, P, Lu, K, Mxu, W0, S, L, nx, nz, dense, reg, stream
extern "C" int tq_ric_chain_factor(const float* hbar, const float* AB, float* P,
                                   float* Lu, float* K, float* Mxu, float* W0, int S,
                                   int L, int nx, int nz, int dense, float reg,
                                   void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  ric_chain_factor_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      hbar, AB, P, Lu, K, Mxu, W0, S, L, nx, nz, dense, reg);
  return (int)cudaGetLastError();
}

// pointers (P, Lu, Mxu, AB, rg, rb, p, k, w0), S, L, nx, nz, stream
extern "C" int tq_ric_chain_bwd(const void* const* p, int S, int L, int nx, int nz,
                                void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  ric_chain_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(ops9(p), S, L, nx,
                                                                       nz);
  return (int)cudaGetLastError();
}

// pointers (P, K, AB, rb, p, k, z_root, dz, dl), S, L, nx, nz, stream
extern "C" int tq_ric_chain_fwd(const void* const* p, int S, int L, int nx, int nz,
                                void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  ric_chain_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(ops9(p), S, L, nx,
                                                                       nz);
  return (int)cudaGetLastError();
}
