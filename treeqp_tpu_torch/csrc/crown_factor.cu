// Level-synchronous tree block Cholesky of given equilibrated blocks, in
// one launch of one thread-block cluster: the factorization of the generic
// tree solver (the whole tree, or the crown levels of its split path).
//
// Replaces the Pallas kernel crown_factor of treeqp_tpu/ops/crown_kernels.py
// (reached through tdunes._tree_chol_factor). Input: W [NpG, G, G] (Jacobi
// equilibrated; on the split path only the crown's groups, with the chain
// Schur blocks already subtracted) and the parent couplings Ut
// [NpG, nxm, G]. Phase 1 copies W into CholW (16-byte copies where both are
// aligned, spread over the whole cluster) and zeroes CholUt_0 (the root
// group has no parent); phase 2 is tq::crown_factor_warps (tq_crown.cuh),
// the level loop crown_blocks_factor.cu runs after its block build: per
// level entry CholW_g = chol(W_g + reg I) (pivot floor 1e-8, clamped
// diagonal), CholUt_g = Ut_g CholW_g^-T (read from Ut), and the Schur block
// CholUt_g CholUt_g' subtracted from its (parent, slot) diagonal block by
// index, one writer per (parent, slot), where the TPU kernel moved it with
// one-hot [K, NPg, NPg] matmuls; then the root group.
//
// What bounds it on the card: latency. A level is one dependent G x G
// Cholesky and triangular solve (G = 24 at the pruned quadcopter's crown:
// ~24 pivot rounds of a shuffle and an rsqrt, ~24 true divisions), and the
// levels are separated by barriers; the bytes (CholW once, ~0.2 MB at 81
// groups of G = 24) take well under a microsecond. The one-block kernel
// this replaces factored each group in one thread, element by element in
// global memory, on one SM (1.03 ms there). Design (tq_crown.cuh):
// - one cluster of 8 blocks (the portable maximum), a warp a group, the
//   warps of a level interleaved over the 8 SMs; the cluster's barrier
//   between levels, the parents' blocks through global memory (L2);
// - the warp loads its group's block and couplings as one stack of G + n
//   rows into registers, lane i rows i + 32 s; the Cholesky's pivots and
//   columns go out by shuffles and the coupling rows ride along its steps
//   (CholUt divides where the factor multiplies); the factors go back
//   coalesced through shared memory, and an entry of the Schur block a
//   lane goes to the parent; the step loop runs to the runtime G, so the
//   code stays in the instruction cache;
// - the deepest level reads its blocks from W; phase 1 copies only the
//   other groups' (the parents') blocks into CholW, and its barrier is
//   waited for only before a child's first Schur update, so the copy
//   overlaps the deepest level's factorizations;
// - the warps a block: as many as the groups need in one round (NpG / 8),
//   at most 16 (8 with two or three rows a lane) and what shared memory
//   holds (the wrapper computes them: crown_kernels._factor_launch).
// Every element meets the per-thread kernel's operations in its order
// (tq_crown.cuh), so the factors are that kernel's bit for bit. No tensor
// cores: a level is a dependent factorization of one G <= 64 block a group.

#include <cstdint>

#include "tq_crown.cuh"

namespace {

using tq::kCrownCluster;

template <int R>
__global__ void __cluster_dims__(kCrownCluster, 1, 1)
    __launch_bounds__(32 * tq::crown_max_warps(R)) crown_factor_kernel(
        const float* __restrict__ W, const float* __restrict__ Ut, const int* lev_ptr,
        const int* lev_child, const int* lev_parent, const int* lev_slot, float* CholW,
        float* CholUt, int NpG, int K, int nxm, int n_lev, float reg, int warp_floats) {
  extern __shared__ __align__(16) float smem[];
  tq::cg::cluster_group cluster = tq::cg::this_cluster();
  int* ss = reinterpret_cast<int*>(smem + (blockDim.x / 32) * warp_floats);
  tq::crown_sched_load(ss, lev_ptr, lev_child, lev_parent, lev_slot, NpG, n_lev);
  __syncthreads();
  const int G = K * nxm;
  const size_t GG = (size_t)G * G;
  const int gt = cluster.block_rank() * blockDim.x + threadIdx.x;
  const int gn = kCrownCluster * blockDim.x;

  // phase 1: the blocks of the groups off the deepest level (the root and
  // the upper levels' groups) into CholW, CholUt_0 = 0; the deepest level
  // reads its blocks from W itself
  const int* child = ss + n_lev + 1;
  const int first = n_lev > 0 ? ss[1] : 0;  // the upper levels' first entry
  const int U = NpG - first;                 // the root and those groups
  const auto group = [&](int u) { return u == 0 ? 0 : child[first + u - 1]; };
  if (GG % 4 == 0 && (((uintptr_t)W | (uintptr_t)CholW) & 15) == 0) {
    const int q4 = (int)(GG / 4);
    for (int t = gt; t < U * q4; t += gn) {
      const size_t o = group(t / q4) * GG + 4 * (size_t)(t % q4);
      *reinterpret_cast<float4*>(CholW + o) = *reinterpret_cast<const float4*>(W + o);
    }
  } else {
    for (int t = gt; t < U * (int)GG; t += gn) {
      const size_t o = group(t / (int)GG) * GG + t % (int)GG;
      CholW[o] = W[o];
    }
  }
  for (int e = gt; e < nxm * G; e += gn) CholUt[e] = 0.f;
  tq::cluster_arrive();

  // phase 2: levels, deepest first, then the root group
  const int i = threadIdx.x % 32;
  tq::crown_factor_warps<R>(
      cluster, CholW, CholUt, Ut, ss, NpG, n_lev, K, nxm, reg,
      smem + (threadIdx.x / 32) * warp_floats, [&](int g, auto& a) {
        tq::load_rows<R>(a, W + g * GG, Ut + (size_t)g * nxm * G, G, nxm, reg, i);
      });
}

template <int R>
int launch(const float* W, const float* Ut, const int* lev_ptr, const int* lev_child,
           const int* lev_parent, const int* lev_slot, float* CholW, float* CholUt, int NpG,
           int K, int nxm, int n_lev, float reg, int warps, int warp_floats, cudaStream_t st) {
  if (warps < 1 || warps > tq::crown_max_warps(R) ||
      warp_floats < tq::crown_factor_floats(K * nxm, nxm) || warp_floats % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)warps * warp_floats * sizeof(float) +
                       (size_t)tq::crown_sched_ints(NpG, n_lev) * sizeof(int);
  static size_t opted = 0;  // the dynamic shared memory this kernel may take
  if (bytes > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        crown_factor_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted = bytes;
  }
  crown_factor_kernel<R><<<kCrownCluster, 32 * warps, bytes, st>>>(
      W, Ut, lev_ptr, lev_child, lev_parent, lev_slot, CholW, CholUt, NpG, K, nxm, n_lev, reg,
      warp_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// W, Ut, lev_ptr, lev_child, lev_parent, lev_slot, CholW, CholUt, NpG, K,
// nxm, n_lev, reg, warps (a block), warp_floats (shared memory a warp),
// stream
extern "C" int tq_crown_factor(
    const float* W, const float* Ut, const int* lev_ptr, const int* lev_child,
    const int* lev_parent, const int* lev_slot, float* CholW, float* CholUt,
    int NpG, int K, int nxm, int n_lev, float reg, int warps, int warp_floats, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int G = K * nxm;
  if (G < 1 || G > 64 || nxm > tq::kMaxN) return (int)cudaErrorInvalidValue;
  switch (tq::crown_rows(G, nxm)) {
#define TQ_R(R_)                                                                          \
  case R_:                                                                                \
    return launch<R_>(W, Ut, lev_ptr, lev_child, lev_parent, lev_slot, CholW, CholUt, NpG, \
                      K, nxm, n_lev, reg, warps, warp_floats, st);
    TQ_R(1) TQ_R(2) TQ_R(3)
#undef TQ_R
    default:
      return (int)cudaErrorInvalidValue;
  }
}
