// Multi-right-hand-side full solve of self-contained chains, a group of
// lanes per (chain, column): the banded per-scenario dual-Hessian solve of
// sdunes.
//
// Replaces the Pallas kernel chain_full_solve_mat of
// treeqp_tpu/ops/chain_kernels.py (reached through sdunes._sd_full_solve),
// with chain_factor's factors Ls, CUs [S, L, n, n] of chains whose node 0
// has no parent coupling (CUs_0 = 0), and rhs [S, L, n, m]:
//   backward  y_j = Ls_j^-1 (r_j - CUs_{j+1} y_{j+1})   for j = L-1 .. 0,
//   forward   z_j = Ls_j^-T (y_j - CUs_j' z_{j-1})      for j = 0 .. L-1,
// both sweeps in one launch, y kept in z between them.
//
// What bounds it on the card: latency. A column of a chain is 2L dependent
// n x n triangular solves and products (~6 n^2 L flops, ~7.7k at sdunes'
// L = 20, n = 8); the launch moves the factors once (2 S L n^2 f32, 2.6 MB
// at S = 256) plus rhs and z (0.8 MB at m = 5). The thread-per-(chain,
// column) kernel this replaces ran the 2L steps in one thread with its
// vectors in local memory and the factors read a float at a time (S m =
// 1280 threads on ten SMs at m = 5, two at m = 1: 0.31 / 0.44 ms). Design:
// - A group of G = tq::lanes(n) lanes (8 for n <= 8, 16 for n <= 16) takes
//   one column of one chain, 32 / G groups a warp and one warp a block:
//   S m groups, any m (1280 groups in 320 blocks at m = 5, 64 blocks at
//   m = 1). The m groups of a chain read the same factors, which the L2
//   cache keeps.
// - The two sweeps are tq_lanes.cuh's sweep_bwd and sweep_fwd (the steps
//   of chain_sweeps.cu): lane i owns row i of the step's vector in a
//   register, Ls_j and CUs_j stream through a ring of kSweepStages stages
//   of shared memory by cp.async, and a step is n rounds of a true
//   division and a __shfl_sync. CUs_0 = 0 stands in for the crown: the
//   backward sweep's CUs_0 y_0 is dropped and the forward sweep starts
//   from z_{-1} = 0.
// - The column's entries are m floats apart in rhs and z: the ring's
//   vector slot takes them by 4-byte copies, a lane its own entry
//   (SweepGroup's vector stride); rhs is not transposed.
// - y goes to z and comes back through the forward sweep's ring. Lane i
//   stores y_j's row i and later copies the same float back, so a fence
//   between the sweeps orders its stores before its copies; the forward
//   sweep overwrites z_j only after the stage holding y_j has landed.
// Every sum runs in the order of the thread-per-(chain, column) kernel
// (which is ltrsv_inplace / uttrsv_inplace's walked over the chain), each
// product folded in by one FMA as nvcc contracted that body, and the
// divisions are true divisions: bit for bit that kernel.
// No tensor cores: a step is a dependent triangular solve of n <= 16 rows.

#include <cstdint>

#include "tq_lanes.cuh"

namespace {

using tq::kSweepStages;
using tq::sweep_stage_floats;

// Group q of the block takes (chain, column) t = blockIdx.x (32 / G) + q,
// chain t / m and column t % m; a group past the last chain stores nothing
// and reads rhs in both sweeps.
template <int G>
__global__ void __launch_bounds__(32) chain_full_solve_mat_kernel(
    const float* __restrict__ Ls, const float* __restrict__ CUs,
    const float* __restrict__ rhs, float* __restrict__ z, int S, int L, int n, int m,
    int vec16) {
  extern __shared__ __align__(16) float smem[];
  const int q = threadIdx.x / G, i = threadIdx.x % G;
  const long t = (long)blockIdx.x * (32 / G) + q;
  const int s = (int)(t / m), c = (int)(t % m);
  float* ring = smem + (size_t)q * kSweepStages * sweep_stage_floats(n);
  const tq::SweepGroup<G> bwd(ring, i, s, Ls, CUs, rhs + c, S, L, n, m);
  const bool store = bwd.live && i < n;
  float* zc = z + (size_t)(bwd.live ? s : 0) * L * n * m + c;
  tq::sweep_bwd(bwd, L, n, vec16, [&](int j, float y) {
    if (store) zc[((size_t)j * n + i) * m] = y;
  });
  __syncwarp();
  __threadfence_block();  // y's stores before the forward sweep's copies of them
  const tq::SweepGroup<G> fwd(ring, i, s, Ls, CUs, (bwd.live ? z : rhs) + c, S, L, n, m);
  const float zero[tq::kMaxN] = {};
  tq::sweep_fwd(fwd, zero, L, n, vec16, [](int) {}, [&](int j, float d) {
    if (store) zc[((size_t)j * n + i) * m] = d;
  });
}

template <int G>
int launch(const float* Ls, const float* CUs, const float* rhs, float* z, int S, int L, int n,
           int m, int vec16, cudaStream_t st) {
  constexpr int groups = 32 / G;
  const long blocks = ((long)S * m + groups - 1) / groups;
  const size_t shmem = (size_t)groups * kSweepStages * sweep_stage_floats(n) * sizeof(float);
  chain_full_solve_mat_kernel<G><<<(unsigned)blocks, 32, shmem, st>>>(Ls, CUs, rhs, z, S, L,
                                                                     n, m, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

// Ls, CUs, rhs, z, S, L, n, m, stream
extern "C" int tq_chain_full_solve_mat(const float* Ls, const float* CUs, const float* rhs,
                                       float* z, int S, int L, int n, int m,
                                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  // 16-byte ring copies of the factors: even n and 16-byte aligned factors
  const int vec16 = n % 2 == 0 && (((uintptr_t)Ls | (uintptr_t)CUs) & 15) == 0;
  if (n <= 8) return launch<8>(Ls, CUs, rhs, z, S, L, n, m, vec16, st);
  return launch<16>(Ls, CUs, rhs, z, S, L, n, m, vec16, st);
}
