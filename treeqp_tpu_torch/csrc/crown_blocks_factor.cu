// Crown factorize of the multistage dual Hessian: block build, Jacobi
// scaling, the chain Schur term, and the level-synchronous tree block
// Cholesky, in one launch of one thread-block cluster.
//
// Replaces the Pallas kernel crown_blocks_factor of
// treeqp_tpu/ops/crown_kernels.py (with its _factor_levels loop). The TPU
// kernel put the lambda-groups on the 128 vector lanes, factorized every
// lane at every level and moved each child's Schur block to its parent with
// one-hot matmuls. Here a warp takes a group; a level's groups are
// factorized in parallel on the cluster's warps, and each child subtracts
// its Schur block CU CU' directly from its (parent, slot) diagonal block.
// Every (parent, slot) has exactly one child, so the writes need no
// atomics; the cluster's barrier orders the levels.
//
// Per group g (G = K nxm, kid slots k1, k2 over the K kids):
//   W[k1 a, k2 b] = sum_n ABk[k1, a, n] ztp[n] ABk[k2, b, n]  (+ dvals on the diagonal)
//   W  <- diag(sW) W diag(sW) + Wadd         (Wadd: the negated chain Schur blocks)
//   Ut[i, k c] = -ztp[i] ABk[k, c, i],  Ut <- diag(sUt) Ut diag(sW)
// then, deepest level first: CholW = chol(W + reg I) with pivot floor 1e-8,
// CholUt = Ut CholW^-T, W[parent][slot, slot] -= CholUt CholUt'; the root
// group (0) last.
//
// What bounds it on the card: latency. The build is ~G^2 nz / 2 FMAs a
// group, independent over the groups; each level is one dependent G x G
// Cholesky and triangular solve a group (G = 24 at the quadcopter crown:
// ~24 pivot rounds of a shuffle and an rsqrt, ~24 true divisions), and the
// crown has 3-4 levels and the root. The one-block kernel this replaces ran
// a thread a group on one SM, building each block serially (G^2 nz FMAs in
// one thread) and factoring it element by element in global memory (1.46
// ms at the headline). Design:
// - one cluster of 8 blocks, the warps interleaved over them (the wrapper
//   sizes the warps a block: crown_kernels._factor_launch);
// - a group's build, on a warp: [A B] of the group's kids goes to the
//   warp's shared memory transposed ([nz][G]), with each row's products
//   AB_r,m ztp_m beside it, and lane r sums row r's entries of W_g (the
//   lower part: the factorization reads no other) side by side in
//   registers, the coupling rows' lanes their rows of Ut_g;
// - the deepest level's groups are built by the warp that factors them,
//   straight into the registers of tq_crown.cuh's stack of rows; phase 1
//   builds only the other groups' (the parents') blocks the same way and
//   stores them into CholW and CholUt, first on the warps the deepest
//   level leaves idle, and its barrier is waited for only before a child's
//   first Schur update;
// - phase 2 is tq::crown_factor_warps (tq_crown.cuh, shared with
//   crown_factor.cu): a warp a group, the block and its couplings as one
//   stack of rows in registers, the pivots and columns by shuffles.
// Every element meets the thread-per-group kernel's operations in its
// order, the FMAs nvcc contracted there written out (w = AB_r ztp AB_c +
// w, and w sW_r sW_c + Wadd as one FMA after the product w sW_r): the
// factors are that kernel's bit for bit.

#include "tq_crown.cuh"

namespace {

using tq::kCrownCluster;

// Shared memory floats a warp needs for phase 1: AB_g' and the products
// [nz][G] each, ztp [nz], sW [G].
__host__ __device__ constexpr int build_floats(int G, int nz) { return 2 * nz * G + nz + G; }

struct BuildArgs {
  const float *ABk, *ztp, *dvals, *sW, *sUt, *Wadd;
};

// Group g's operands into the warp's sm: [A B]' of its kids [nz][G], the
// products AB_r,m ztp_m [nz][G], ztp [nz] and sW [G].
__device__ __forceinline__ void stage(const BuildArgs& in, int g, int G, int nz, float* sm,
                                      int i) {
  float* sABt = sm;
  float* sP = sm + nz * G;
  float* szt = sP + nz * G;
  float* ssw = szt + nz;
  const float* AB = in.ABk + (size_t)g * G * nz;  // [K][nxm][nz] = [G][nz]
  const float* zt = in.ztp + (size_t)g * nz;
  __syncwarp();  // the previous group's reads of sm are done
  for (int m = i; m < nz; m += 32) szt[m] = zt[m];
  for (int r = i; r < G; r += 32) ssw[r] = in.sW[(size_t)g * G + r];
  for (int e = i; e < G * nz; e += 32) {
    const int r = e / nz, m = e % nz;
    const float v = AB[e];
    sABt[m * G + r] = v;
    sP[m * G + r] = __fmul_rn(v, zt[m]);
  }
  __syncwarp();
}

// Group g's scaled block W_g and its couplings Ut_g as the stack of
// tq::load_rows (lane i rows i + 32 s: the block's lower part with reg on
// the diagonal, then the coupling rows), built on the calling warp from the
// operands staged in sm: lane r sums its row's entries side by side in
// registers, each in the thread-per-group kernel's order.
template <int R>
__device__ __forceinline__ void build_rows(const BuildArgs& in, int g, int K, int n, int nz,
                                           float reg, float* sm, int i, float (&a)[R][64]) {
  const int G = K * n;
  // Wadd's rows (lower part; -0 leaves the diagonal as it is) first, so
  // that their loads overlap the staging
  tq::load_rows<R>(a, in.Wadd + (size_t)g * G * G, nullptr, G, n, -0.f, i);
  stage(in, g, G, nz, sm, i);
  const float* sABt = sm;
  const float* sP = sm + nz * G;
  const float* szt = sP + nz * G;
  const float* ssw = szt + nz;
  const bool vec = G % 4 == 0;  // the staged rows are 16-byte aligned
#pragma unroll
  for (int s = 0; s < R; ++s) {
    constexpr int kC = 64;
    const int r = i + 32 * s;
    if (r < G) {
      const float dv = in.dvals[(size_t)g * G + r], swr = ssw[r];
      // 32 columns at a time, so that the sums and the rows fit the
      // registers
#pragma unroll
      for (int c0 = 0; c0 < kC; c0 += 32) {
        if (c0 < tq::slot_cols(s) && c0 < G) {
          float w[32];
#pragma unroll
          for (int c = 0; c < 32; ++c) w[c] = 0.f;
          for (int m = 0; m < nz; ++m) {
            const float pr = sP[m * G + r];
            const float* ab = sABt + m * G + c0;
#pragma unroll
            for (int c = 0; c < 32; c += 4) {
              float4 v;
              if (vec) {
                v = c0 + c < G ? *reinterpret_cast<const float4*>(ab + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
              } else {
                const auto at = [&](int j) { return c0 + j < G ? ab[j] : 0.f; };
                v = make_float4(at(c), at(c + 1), at(c + 2), at(c + 3));
              }
              w[c] = __fmaf_rn(pr, v.x, w[c]);
              w[c + 1] = __fmaf_rn(pr, v.y, w[c + 1]);
              w[c + 2] = __fmaf_rn(pr, v.z, w[c + 2]);
              w[c + 3] = __fmaf_rn(pr, v.w, w[c + 3]);
            }
          }
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int c = c0 + j;
            const float v = c == r ? __fadd_rn(w[j], dv) : w[j];
            const float wv = __fmaf_rn(__fmul_rn(v, swr), ssw[c < G ? c : 0], a[s][c]);
            a[s][c] = c <= r ? (c == r ? __fadd_rn(wv, reg) : wv) : 0.f;
          }
        }
      }
    } else if (r < G + n) {
      const int q = r - G;
      const float zq = szt[q], sq = in.sUt[(size_t)g * n + q];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (c < tq::slot_cols(s))
          a[s][c] = c < G ? __fmul_rn(__fmul_rn(-__fmul_rn(zq, sABt[q * G + c]), sq), ssw[c])
                          : 0.f;
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (c < tq::slot_cols(s)) a[s][c] = 0.f;
    }
  }
}

// The stack a (build_rows' form, built with reg = -0, which leaves the
// diagonal as it is) into the group's W_g (lower part) and, with U, Ut_g:
// what tq::load_rows reads back at the group's level.
template <int R>
__device__ __forceinline__ void store_rows(const float (&a)[R][64], float* W, float* U, int G,
                                           int n, int i) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = i + 32 * s;
#pragma unroll
    for (int c = 0; c < 64; ++c) {
      if (c < tq::slot_cols(s)) {
        if (r < G && c <= r) W[(size_t)r * G + c] = a[s][c];
        if (U != nullptr && r >= G && r < G + n && c < G) U[(size_t)(r - G) * G + c] = a[s][c];
      }
    }
  }
}

template <int R>
__global__ void __cluster_dims__(kCrownCluster, 1, 1)
    __launch_bounds__(32 * tq::crown_max_warps(R)) crown_blocks_factor_kernel(
        const BuildArgs in, const int* lev_ptr, const int* lev_child, const int* lev_parent,
        const int* lev_slot, float* CholW, float* CholUt, int NpG, int K, int nxm, int nz,
        int n_lev, float reg, int warp_floats) {
  extern __shared__ __align__(16) float smem[];
  tq::cg::cluster_group cluster = tq::cg::this_cluster();
  int* ss = reinterpret_cast<int*>(smem + (blockDim.x / 32) * warp_floats);
  tq::crown_sched_load(ss, lev_ptr, lev_child, lev_parent, lev_slot, NpG, n_lev);
  __syncthreads();
  float* sm = smem + (threadIdx.x / 32) * warp_floats;
  const int i = threadIdx.x % 32;
  const int w = (threadIdx.x / 32) * kCrownCluster + (int)cluster.block_rank();
  const int nw = kCrownCluster * (blockDim.x / 32);

  // phase 1: the blocks of the groups off the deepest level (the root and
  // the upper levels' groups) into CholW and CholUt, a warp a group, first
  // on the warps the deepest level leaves idle; the deepest level builds
  // its own blocks in registers (build_rows, both)
  const int G = K * nxm;
  const size_t GG = (size_t)G * G, UG = (size_t)nxm * G;
  const int* child = ss + n_lev + 1;
  const int first = n_lev > 0 ? ss[1] : 0;  // the upper levels' first entry, and the
  const int U = NpG - first;                 // deepest level's width; the root and those
  for (int u = ((w - first) % nw + nw) % nw; u < U; u += nw) {
    const int g = u == 0 ? 0 : child[first + u - 1];
    float a[R][64];
    build_rows<R>(in, g, K, nxm, nz, -0.f, sm, i, a);
    store_rows<R>(a, CholW + g * GG, g == 0 ? nullptr : CholUt + g * UG, G, nxm, i);
  }
  for (int e = (int)cluster.block_rank() * blockDim.x + threadIdx.x; e < nxm * G;
       e += kCrownCluster * blockDim.x)
    CholUt[e] = 0.f;  // the root's couplings
  tq::cluster_arrive();

  // phase 2: levels, deepest first; children update their parents; then
  // the root group (tq_crown.cuh, shared with crown_factor.cu)
  tq::crown_factor_warps<R>(cluster, CholW, CholUt, CholUt, ss, NpG, n_lev, K, nxm, reg, sm,
                            [&](int g, auto& a) {
                              build_rows<R>(in, g, K, nxm, nz, reg, sm, i, a);
                            });
}

template <int R>
int launch(const BuildArgs& in, const int* lev_ptr, const int* lev_child,
           const int* lev_parent, const int* lev_slot, float* CholW, float* CholUt, int NpG,
           int K, int nxm, int nz, int n_lev, float reg, int warps, int warp_floats,
           cudaStream_t st) {
  const int G = K * nxm;
  if (warps < 1 || warps > tq::crown_max_warps(R) || warp_floats % 4 != 0 ||
      warp_floats < tq::crown_factor_floats(G, nxm) || warp_floats < build_floats(G, nz))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)warps * warp_floats * sizeof(float) +
                       (size_t)tq::crown_sched_ints(NpG, n_lev) * sizeof(int);
  static size_t opted = 0;  // the dynamic shared memory this kernel may take
  if (bytes > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        crown_blocks_factor_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted = bytes;
  }
  crown_blocks_factor_kernel<R><<<kCrownCluster, 32 * warps, bytes, st>>>(
      in, lev_ptr, lev_child, lev_parent, lev_slot, CholW, CholUt, NpG, K, nxm, nz, n_lev, reg,
      warp_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// ABk, ztp, dvals, sW, sUt, Wadd, lev_ptr, lev_child, lev_parent, lev_slot,
// CholW, CholUt, NpG, K, nxm, nz, n_lev, reg, warps (a block), warp_floats
// (shared memory a warp), stream
extern "C" int tq_crown_blocks_factor(
    const float* ABk, const float* ztp, const float* dvals, const float* sW,
    const float* sUt, const float* Wadd, const int* lev_ptr,
    const int* lev_child, const int* lev_parent, const int* lev_slot,
    float* CholW, float* CholUt,
    int NpG, int K, int nxm, int nz, int n_lev, float reg, int warps, int warp_floats,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const BuildArgs in{ABk, ztp, dvals, sW, sUt, Wadd};
  const int G = K * nxm;
  if (G < 1 || G > 64 || nxm > tq::kMaxN || nz < nxm) return (int)cudaErrorInvalidValue;
  switch (tq::crown_rows(G, nxm)) {
#define TQ_R(R_)                                                                             \
  case R_:                                                                                   \
    return launch<R_>(in, lev_ptr, lev_child, lev_parent, lev_slot, CholW, CholUt, NpG, K,  \
                      nxm, nz, n_lev, reg, warps, warp_floats, st);
    TQ_R(1) TQ_R(2) TQ_R(3)
#undef TQ_R
    default:
      return (int)cudaErrorInvalidValue;
  }
}
