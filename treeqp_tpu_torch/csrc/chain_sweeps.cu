// The two solve sweeps of the chain factors, a group of lanes per chain:
// the chain half of the generic tree Cholesky's split-path solve.
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
// Between the two the crown is solved (crown_solve.cu).
//
// What bounds it on the card: latency. A sweep is L dependent steps, each
// an n x n triangular solve and product (n <= 16); a launch moves only the
// factors once (S L n^2 f32 each, 0.3 MB at 128 chains). Design:
// - A group of G lanes takes a chain: G = 8 for n <= 8, 16 for n <= 16, so
//   32 / G chains a warp and one warp a block (128 chains of n = 6 take 32
//   SMs). Lane i owns row i of the step's vector, in a register.
// - The chain's blocks Ls_j, CUs_j and the step's vector are streamed
//   through a ring of kSweepStages stages of shared memory per chain with
//   cp.async (16-byte copies, coalesced over the group's lanes, when n is
//   even and the factors 16-byte aligned; 4-byte copies otherwise), up to
//   kSweepStages steps ahead of the step computed. The ring's depth is fixed,
//   so any L runs; no chain is staged whole.
// - The dependent arithmetic stays in registers and shuffles. Ls_j^-1 t:
//   for k = 0 .. n-1 lane k divides by its diagonal, __shfl_sync
//   broadcasts y_k, lanes i > k subtract L_ik y_k and every lane i adds
//   CU_ik y_k to its row of the next step's CUs_j y. Ls_j^-T t: every lane
//   holds the whole previous direction, so CUs_j' dp needs no shuffle, and
//   for k = n-1 .. 0 lane k folds in the entries solved so far, divides,
//   and __shfl_sync broadcasts z_k to every lane. A step thus costs n
//   rounds of a division and a shuffle (~0.75 us at n = 6 on an H100).
// - Each step's n outputs are written once, lane i to row i: n contiguous
//   floats a chain and step.
// Every sum runs in the order of tq_dense.cuh's ltrsv_inplace /
// uttrsv_inplace walked over a chain's blocks by one thread (the
// thread-per-chain kernels), each product folded in by one FMA as nvcc
// contracts those bodies, and the divisions are true divisions: the
// results equal the thread-per-chain kernels' bit for bit. The two steps
// are tq_lanes.cuh's sweep_bwd / sweep_fwd, which tq_system.cuh's
// Newton-system solve (system_solve.cu, newton_iter.cu) runs too.
// No tensor cores: a step is a dependent triangular solve of n <= 16 rows,
// where wgmma needs 64-row tiles and mma.sync would pad n = 6 to 16 with no
// batch dimension inside a chain.
//
// The launch shape is fixed: 8 or 16 lanes a chain, one warp a block, three
// stages. On an H100 two warps a block and 2-4 stages ran as fast, and a
// chain a warp (32 lanes) 1.3-1.6x slower at n <= 8.

#include <cstdint>

#include "tq_lanes.cuh"

namespace {

using tq::kSweepStages;
using tq::sweep_stage_floats;

constexpr int kWarps = 1;

// Group g of the block takes chain blockIdx.x * (blockDim.x / G) + g, its
// ring at g's place in the block's shared memory.
template <int G>
__device__ tq::SweepGroup<G> group(float* smem, const float* Ls, const float* CUs,
                                   const float* v, int S, int L, int n) {
  const int g = threadIdx.x / G;
  return tq::SweepGroup<G>(smem + (size_t)g * kSweepStages * sweep_stage_floats(n),
                           threadIdx.x % G, blockIdx.x * (blockDim.x / G) + g, Ls, CUs,
                           v, S, L, n);
}

template <int G>
__global__ void __launch_bounds__(32 * kWarps) chain_solve_bwd_kernel(
    const float* __restrict__ Ls, const float* __restrict__ CUs,
    const float* __restrict__ res, float* __restrict__ ys,
    float* __restrict__ radd0, int S, int L, int n, int vec16) {
  extern __shared__ __align__(16) float smem[];
  const tq::SweepGroup<G> g = group<G>(smem, Ls, CUs, res, S, L, n);
  const int i = g.lane;
  const float radd = tq::sweep_bwd(g, L, n, vec16, [&](int j, float y) {
    if (g.live && i < n) ys[((size_t)g.s * L + j) * n + i] = y;
  });
  if (g.live && i < n) radd0[(size_t)g.s * n + i] = radd;
}

template <int G>
__global__ void __launch_bounds__(32 * kWarps) chain_forward_kernel(
    const float* __restrict__ Ls, const float* __restrict__ CUs,
    const float* __restrict__ ys, const float* __restrict__ droot,
    float* __restrict__ dls, int S, int L, int n, int vec16) {
  extern __shared__ __align__(16) float smem[];
  const tq::SweepGroup<G> g = group<G>(smem, Ls, CUs, ys, S, L, n);
  const int i = g.lane;
  const size_t sl = g.live ? g.s : S - 1;
  tq::sweep_fwd(g, droot + sl * n, L, n, vec16, [](int) {}, [&](int j, float dl) {
    if (g.live && i < n) dls[((size_t)g.s * L + j) * n + i] = dl;
  });
}

struct Launch {
  int G, blocks;
  size_t shmem;
  int vec16;
};

Launch launch_shape(const float* Ls, const float* CUs, int S, int n) {
  Launch c;
  c.G = n <= 8 ? 8 : 16;
  const int chains = kWarps * 32 / c.G;
  c.blocks = (S + chains - 1) / chains;
  c.shmem = (size_t)chains * kSweepStages * sweep_stage_floats(n) * sizeof(float);
  c.vec16 = n % 2 == 0 && (((uintptr_t)Ls | (uintptr_t)CUs) & 15) == 0;
  return c;
}

}  // namespace

// Ls, CUs, res, ys, radd0, S, L, n, stream
extern "C" int tq_chain_solve_bwd(const float* Ls, const float* CUs,
                                  const float* res, float* ys, float* radd0,
                                  int S, int L, int n, void* stream) {
  const Launch c = launch_shape(Ls, CUs, S, n);
  const cudaStream_t st = (cudaStream_t)stream;
#define TQ_BWD(G_)                                                              \
  chain_solve_bwd_kernel<G_><<<c.blocks, 32 * kWarps, c.shmem, st>>>(           \
      Ls, CUs, res, ys, radd0, S, L, n, c.vec16)
  if (c.G == 8)
    TQ_BWD(8);
  else
    TQ_BWD(16);
#undef TQ_BWD
  return (int)cudaGetLastError();
}

// Ls, CUs, ys, droot, dls, S, L, n, stream
extern "C" int tq_chain_forward(const float* Ls, const float* CUs,
                                const float* ys, const float* droot, float* dls,
                                int S, int L, int n, void* stream) {
  const Launch c = launch_shape(Ls, CUs, S, n);
  const cudaStream_t st = (cudaStream_t)stream;
#define TQ_FWD(G_)                                                              \
  chain_forward_kernel<G_><<<c.blocks, 32 * kWarps, c.shmem, st>>>(             \
      Ls, CUs, ys, droot, dls, S, L, n, c.vec16)
  if (c.G == 8)
    TQ_FWD(8);
  else
    TQ_FWD(16);
#undef TQ_FWD
  return (int)cudaGetLastError();
}
