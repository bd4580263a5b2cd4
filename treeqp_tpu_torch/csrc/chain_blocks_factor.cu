// Chain-side factorize of the multistage dual Hessian, a group of lanes per
// chain: the chain block build, its Jacobi equilibration and the banded
// backward block Cholesky in one launch.
//
// Replaces the Pallas kernels chain_blocks_factor and
// chain_blocks_factor_lanes of treeqp_tpu/ops/chain_kernels.py (reached
// through tdunes_multistage._ms_factorize). The two kernels share one body
// and differ only in where the parent's masked inverses ztp_j and the
// node's own qtc_j come from:
//   chain_blocks_factor:       ztp [S, L, nz], qtc [S, L, nx] given;
//   chain_blocks_factor_lanes: ztp_0 = ztp_root[s] (the crown root's),
//                              ztp_j = (qt, rt)_{j-1} of the chain evaluation
//                              for j >= 1, qtc_j = qt_j, read in place.
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
// What bounds it on the card: latency. A chain is L dependent steps, each a
// block build (nx nz products a row), a factorization, a triangular solve
// and a product of nx x nx blocks (nx <= 16); a launch moves the dynamics
// and the factors once (2.5 MB at the quadcopter headline's 256 chains of
// L = 16, nx = 6, nz = 10). The thread-per-chain kernel this replaces built
// every step's blocks serially into the Ls / CUs output buffers, read them
// back and factored them in global memory, 256 threads on 2 SMs (3.1 ms).
// Design (chain_factor.cu's, with the build moved into the step):
// - A group of G lanes takes a chain: G = 8 for nx <= 8, 16 for nx <= 16,
//   so 32 / G chains a warp and one warp a block; nx is a template
//   parameter (one instantiation per nx = 1 .. 16), nz a runtime one.
// - Each step's sources [AB_j | ztp_j | qtc_j] stream through a ring of
//   kStages stages of shared memory per chain with cp.async (16-byte copies
//   of AB_j when nx nz is a multiple of 4 and ABt is 16-byte aligned, 4-byte
//   copies otherwise), up to kStages steps ahead; the ring's depth is fixed,
//   so any L runs. A step waits for its own stage and the next one.
// - Lane i builds row i of W_j in registers: each element summed over n in
//   ascending order by one FMA (AB_in ztp_n) AB_cn a product, the FMA nvcc
//   contracted the thread-per-chain body into, qtc_i added last on the
//   diagonal. sc_j[i] was taken one step earlier from the same sums (lane i
//   builds W_{j-1}'s diagonal element from the next stage), so the blocks'
//   builds no longer run serially before the recursion and the scaled
//   blocks never pass through the output buffers. The scales of the other
//   rows come by __shfl_sync; row i of Ut_j is -(ztp_i AB_ci) sc_{j-1,i}
//   sc_{j,c}, rounded in that order.
// - Then the step of tq_lanes.cuh (chain_factor.cu's): right-looking
//   Cholesky with pivots and columns broadcast by __shfl_sync, CU by true
//   divisions against Ls_j in shared memory, the schur rows from CU in
//   shared memory.
// - sc_j, Ls_j and CUs_j are written once, coalesced over the group.
// Every sum keeps the order of the thread-per-chain kernel this one
// replaces, with the same FMAs, rsqrtf and true divisions: the results are
// that kernel's bit for bit.
// No tensor cores: a step is a dependent factorization of one nx <= 16
// block, where wgmma needs 64-row tiles.

#include <cstdint>

#include "tq_lanes.cuh"

namespace {

using tq::block_floats;
using tq::lanes;

constexpr int kStages = 4;
constexpr int kMaxNz = 64;  // keeps a block's ring under 48 KB of shared memory

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// A stage: [AB_j (N nz) | ztp_j (nz) | qtc_j (N)], each area 16-byte aligned.
__host__ __device__ constexpr int stage_floats(int N, int nz) {
  return round4(N * nz) + round4(nz) + round4(N);
}

// A chain's shared memory: the ring, then two work blocks (Ls_j, CUs_j);
// 4 floats more, so that the chains of a warp start on different banks.
__host__ __device__ constexpr int chain_floats(int N, int nz) {
  return kStages * stage_floats(N, nz) + 2 * block_floats(N) + 4;
}

// ztp_j and qtc_j of chain s given as stacked [S, L, nz] and [S, L, nx]
// arrays.
struct SrcStacked {
  const float* ztp;
  const float* qtc;
  __device__ void fetch(float* zt, float* qc, int s, int j, int L, int nx, int nz,
                        int lane, int G) const {
    const size_t sj = (size_t)s * L + j;
    for (int e = lane; e < nz; e += G) tq::cp_async4(zt + e, ztp + sj * nz + e);
    for (int e = lane; e < nx; e += G) tq::cp_async4(qc + e, qtc + sj * nx + e);
  }
};

// ztp_j assembled from the crown root's and the chain evaluation's masked
// inverses, qtc_j = qt_j.
struct SrcLanes {
  const float* root;  // [S, nz]
  const float* qt;    // [S, L, nx]
  const float* rt;    // [S, L, nz - nx]
  __device__ void fetch(float* zt, float* qc, int s, int j, int L, int nx, int nz,
                        int lane, int G) const {
    const size_t sj = (size_t)s * L + j;
    if (j == 0) {
      for (int e = lane; e < nz; e += G) tq::cp_async4(zt + e, root + (size_t)s * nz + e);
    } else {
      const int nu = nz - nx;
      for (int e = lane; e < nx; e += G) tq::cp_async4(zt + e, qt + (sj - 1) * nx + e);
      for (int e = lane; e < nu; e += G) tq::cp_async4(zt + nx + e, rt + (sj - 1) * nu + e);
    }
    for (int e = lane; e < nx; e += G) tq::cp_async4(qc + e, qt + sj * nx + e);
  }
};

// sc of row i of a stage's block: rsqrt(max(W_ii, 1e-12)), W_ii built as
// the row build below builds it.
__device__ __forceinline__ float row_scale(const float* st, int i, int nz, int N) {
  const float* AB = st;
  const float* zt = st + round4(N * nz);
  const float* qc = zt + round4(nz);
  float w = 0.f;
  for (int n = 0; n < nz; ++n) {
    const float ab = AB[i * nz + n];
    w = __fmaf_rn(__fmul_rn(ab, zt[n]), ab, w);
  }
  return rsqrtf(fmaxf(__fadd_rn(w, qc[i]), 1e-12f));
}

template <int N, class Src>
__global__ void __launch_bounds__(32) blocks_factor_kernel(
    Src src, const float* __restrict__ ABt, const float* __restrict__ s_root,
    float* __restrict__ Ls, float* __restrict__ CUs, float* __restrict__ schur0,
    float* __restrict__ sc, int S, int L, int nz, int vec16) {
  extern __shared__ __align__(16) float smem[];
  constexpr int G = lanes(N);
  constexpr int NN = N * N;
  constexpr int BF = block_floats(N);
  const int i = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int s_raw = blockIdx.x * (32 / G) + grp;
  const bool live = s_raw < S;  // a group past the last chain stores nothing
  const int s = live ? s_raw : S - 1;
  const bool row = i < N;
  const int ir = row ? i : 0;  // the row a lane reads (lanes past N-1: row 0, unused)
  const int SF = stage_floats(N, nz);
  const int zoff = round4(N * nz);
  const int qoff = zoff + round4(nz);
  float* ring = smem + grp * chain_floats(N, nz);
  float* sL = ring + kStages * SF;
  float* sC = sL + BF;
  const int nab = N * nz;

  // step t works on node j = L-1-t
  auto fetch = [&](int t) {
    if (t < L) {
      const int j = L - 1 - t;
      float* st = ring + (t % kStages) * SF;
      const float* AB = ABt + ((size_t)s * L + j) * nab;
      if (vec16) {
        for (int q = 4 * i; q < nab; q += 4 * G) tq::cp_async16(st + q, AB + q);
      } else {
        for (int e = i; e < nab; e += G) tq::cp_async4(st + e, AB + e);
      }
      src.fetch(st + zoff, st + qoff, s, j, L, N, nz, i, G);
    }
    tq::cp_async_commit();
  };
  auto stage = [&](int t) -> const float* { return ring + (t % kStages) * SF; };

  for (int t = 0; t < kStages; ++t) fetch(t);
  const float scr = s_root[(size_t)s * N + ir];
  tq::cp_async_wait<kStages - 1>();
  __syncwarp();
  float scn = row_scale(stage(0), ir, nz, N);  // sc_{L-1}, row i
  float sch[N];  // row i of the previous step's schur
#pragma unroll
  for (int k = 0; k < N; ++k) sch[k] = 0.f;
  for (int t = 0; t < L; ++t) {
    tq::cp_async_wait<kStages - 2>();  // steps t and t+1 have landed
    __syncwarp();
    const int j = L - 1 - t;
    const float* st = stage(t);
    const float* AB = st;
    const float* zt = st + zoff;
    const float* qc = st + qoff;
    const float scj = scn;
    // sc_{j-1}, row i: the next step's block, or the crown's scale
    scn = t + 1 < L ? row_scale(stage(t + 1), ir, nz, N) : scr;

    // row i of W_j, unscaled
    float w[N];
#pragma unroll
    for (int c = 0; c < N; ++c) w[c] = 0.f;
    for (int n = 0; n < nz; ++n) {
      const float p = __fmul_rn(AB[ir * nz + n], zt[n]);
#pragma unroll
      for (int c = 0; c < N; ++c) w[c] = __fmaf_rn(p, AB[c * nz + n], w[c]);
    }
    const float qi = qc[ir];
    float a[N], u[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float sck = __shfl_sync(tq::kFull, scj, k, G);
      const float wk = k == i ? __fadd_rn(w[k], qi) : w[k];
      a[k] = row ? __fsub_rn(__fmul_rn(__fmul_rn(wk, scj), sck), sch[k]) : 0.f;
      // the pivot a_kk + 0 of the Cholesky (a zero shift; -0 -> +0)
      if (k == i) a[k] = __fadd_rn(a[k], 0.f);
      u[k] = row ? __fmul_rn(__fmul_rn(-__fmul_rn(zt[ir], AB[k * nz + ir]), scn), sck) : 0.f;
    }
    __syncwarp();  // the stage is read: refill it kStages steps ahead
    fetch(t + kStages);
    if (live && row) sc[((size_t)s * L + j) * N + i] = scj;

    tq::factor_step<N, G>(a, u, sch, sL, sC, i);

    // this step's blocks, once, coalesced over the group
    if (live) {
      const size_t off = ((size_t)s * L + j) * NN;
      for (int e = i; e < NN; e += G) {
        Ls[off + e] = sL[e];
        CUs[off + e] = sC[e];
      }
    }
  }
  if (live && row) {
#pragma unroll
    for (int k = 0; k < N; ++k) schur0[(size_t)s * NN + i * N + k] = sch[k];
  }
}

template <int N, class Src>
int launch(const Src& src, const float* ABt, const float* s_root, float* Ls, float* CUs,
           float* schur0, float* sc, int S, int L, int nz, cudaStream_t st) {
  constexpr int chains = 32 / lanes(N);
  const int blocks = (S + chains - 1) / chains;
  const size_t shmem = (size_t)chains * chain_floats(N, nz) * sizeof(float);
  const int vec16 = (N * nz) % 4 == 0 && ((uintptr_t)ABt & 15) == 0;
  blocks_factor_kernel<N, Src><<<blocks, 32, shmem, st>>>(src, ABt, s_root, Ls, CUs, schur0,
                                                         sc, S, L, nz, vec16);
  return (int)cudaGetLastError();
}

template <class Src>
int dispatch(const Src& src, const float* ABt, const float* s_root, float* Ls, float* CUs,
             float* schur0, float* sc, int S, int L, int nx, int nz, void* stream) {
  if (S <= 0 || L <= 0 || nz < nx || nz > kMaxNz) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (nx) {
#define TQ_N(N_) \
  case N_:       \
    return launch<N_>(src, ABt, s_root, Ls, CUs, schur0, sc, S, L, nz, st);
    TQ_N(1) TQ_N(2) TQ_N(3) TQ_N(4) TQ_N(5) TQ_N(6) TQ_N(7) TQ_N(8)
    TQ_N(9) TQ_N(10) TQ_N(11) TQ_N(12) TQ_N(13) TQ_N(14) TQ_N(15) TQ_N(16)
#undef TQ_N
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tq_chain_blocks_factor(
    const float* ABt, const float* ztp, const float* qtc, const float* s_root,
    float* Ls, float* CUs, float* schur0, float* sc,
    int S, int L, int nx, int nz, void* stream) {
  return dispatch(SrcStacked{ztp, qtc}, ABt, s_root, Ls, CUs, schur0, sc, S, L, nx, nz,
                  stream);
}

extern "C" int tq_chain_blocks_factor_lanes(
    const float* ABt, const float* qt, const float* rt, const float* ztp_root,
    const float* s_root, float* Ls, float* CUs, float* schur0, float* sc,
    int S, int L, int nx, int nz, void* stream) {
  return dispatch(SrcLanes{ztp_root, qt, rt}, ABt, s_root, Ls, CUs, schur0, sc, S, L, nx, nz,
                  stream);
}
