// Banded backward block Cholesky of given chain blocks, a group of lanes per
// chain: the chain half of the generic tree Cholesky's split path, and the
// banded per-scenario factor of sdunes.
//
// Replaces the Pallas kernel chain_factor of treeqp_tpu/ops/chain_kernels.py
// (reached through tdunes_multistage._chain_factor from
// tdunes._tree_chol_factor_split). Input: the equilibrated chain blocks
// Wc [S, L, n, n] (the caller has added the LM shift reg I) and couplings
// Utc [S, L, n, n], j = 0 the chain node next to the crown. Output, per
// chain, for j = L-1 .. 0:
//   Ls_j = chol(Wc_j - schur)  (pivot d = max(a_kk, 1e-8), column
//          a rsqrt(d), diagonal a_kk rsqrt(d): the Pallas _chol, no shift),
//   CUs_j = Utc_j Ls_j^-T      (true divisions),
//   schur = CUs_j CUs_j',
// and schur0 [S, n, n], the last schur: the Schur block that flows into the
// crown.
//
// What bounds it on the card: latency. A chain is L dependent steps, each a
// factorization, a triangular solve and a product of n x n blocks (n <= 16:
// ~600 flops at n = 6); a launch moves each block once (0.3 MB at the
// pruned quadcopter's 128 chains of L = 16, n = 6). The thread-per-chain
// kernel this replaces ran 128 chains on one SM, copied its blocks element
// by element and factored them in global memory (1.68 ms there). Design:
// - A group of G lanes takes a chain: G = 8 for n <= 8, 16 for n <= 16, so
//   32 / G chains a warp and one warp a block (128 chains of n = 6 take 32
//   SMs).
// - The chain's blocks Wc_j, Utc_j stream through a ring of kStages stages
//   of shared memory per chain with cp.async (16-byte copies, coalesced over
//   the group's lanes, when n is even and the buffers 16-byte aligned; 4-byte
//   copies otherwise), up to kStages steps ahead of the step computed. The
//   ring's depth is fixed, so any L runs.
// - n is a template parameter (one instantiation per n = 1 .. 16): with a
//   runtime n every unrolled product sat behind its own branch and nothing
//   overlapped (0.0483 against 0.0205 ms in a CUDA graph at S=256, L=16,
//   n=8, where no lane idles).
// - Lane i owns row i of the step's block in registers. Cholesky,
//   right-looking: for k = 0 .. n-1 lane k's pivot is broadcast by
//   __shfl_sync, every lane takes its rsqrt, lanes i >= k scale their
//   entry, column k is broadcast by __shfl_sync and lanes i > k fold
//   a_ij -= L_ik L_jk into their row by one FMA a product. Each element
//   meets its products in ascending k, the order of the left-looking
//   chol_inplace<false> (tq_dense.cuh). Ls_j goes to shared memory for
//   the solve. (Every lane factoring the whole block in its registers, no
//   shuffle, was 7-10% faster at n = 5, 6 and 2-5% slower at n = 8; not
//   kept.)
// - CUs_j = Utc_j Ls_j^-T: lane r runs row r's n true divisions, the step's
//   critical path. A zero dividend (the lanes past row n-1, sdunes' Utc_0,
//   the quadcopter's structural zeros) sends the warp's division down its
//   slow path (the pruned shape ran 1.65x slower), so it gets its signed
//   zero and the lane divides d by d.
// - schur = CU CU': lane a forms row a from CU's rows in shared memory, each
//   element summed over k ascending from 0.
// - Ls_j and CUs_j are written once, coalesced over the group (16-byte
//   stores when the copies are); schur0 lane i row i.
// The step (tq_lanes.cuh's factor_step, shared with chain_blocks_factor.cu)
// keeps the order of the thread-per-chain body both kernels ran until they
// were redesigned (a left-looking Cholesky, then CU and schur element by
// element), each product folded in by one FMA as nvcc contracted that body,
// with rsqrtf and true divisions: the results are that kernel's bit for bit.
// No tensor cores: a step is a dependent factorization of one n <= 16 block,
// where wgmma needs 64-row tiles and mma.sync would pad n = 6 to 16 with no
// batch dimension inside a chain.
//
// The launch shape is fixed: 8 or 16 lanes a chain, one warp a block, three
// stages (the sweeps' of chain_sweeps.cu).

#include <cstdint>

#include "tq_lanes.cuh"

namespace {

using tq::block_floats;
using tq::lanes;

constexpr int kStages = 3;

// A chain's shared memory: the ring of kStages stages [Wc_j | Utc_j], then
// two work blocks; 4 floats more, so that the chains of a warp start on
// different banks.
__host__ __device__ constexpr int chain_floats(int N) {
  return (2 * kStages + 2) * block_floats(N) + 4;
}

// A chain's group of lanes(N) lanes and its ring, for blocks of N x N; a
// group past the last chain reads the last chain's blocks and stores
// nothing.
template <int N>
struct Chain {
  static constexpr int G = lanes(N);
  static constexpr int NN = N * N;
  static constexpr int BF = block_floats(N);
  int i;        // the lane in the group
  int s;        // the chain
  bool live;    // s < S
  int L;
  size_t base;  // the chain's offset in Wc, Utc, Ls, CUs
  float* ring;
  float* work;  // two blocks of BF floats after the ring

  __device__ Chain(float* smem, int S, int L_) : L(L_) {
    i = threadIdx.x % G;
    const int g = threadIdx.x / G;
    s = blockIdx.x * (32 / G) + g;
    live = s < S;
    base = (size_t)(live ? s : S - 1) * L * NN;
    ring = smem + g * chain_floats(N);
    work = ring + 2 * kStages * BF;
  }

  __device__ const float* stage(int t) const { return ring + (t % kStages) * 2 * BF; }

  // Copy node L-1-t's blocks into the stage of step t (none past the last
  // step), then close the thread's copy group.
  __device__ void fetch(const float* Wc, const float* Utc, int t, bool vec16) const {
    if (t < L) {
      float* st = ring + (t % kStages) * 2 * BF;
      const size_t off = base + (size_t)(L - 1 - t) * NN;
      if (vec16) {
#pragma unroll
        for (int q = 4 * i; q < NN; q += 4 * G) {
          tq::cp_async16(st + q, Wc + off + q);
          tq::cp_async16(st + BF + q, Utc + off + q);
        }
      } else {
#pragma unroll
        for (int e = i; e < NN; e += G) {
          tq::cp_async4(st + e, Wc + off + e);
          tq::cp_async4(st + BF + e, Utc + off + e);
        }
      }
    }
    tq::cp_async_commit();
  }

  // Step t's stage has landed and every lane of the group sees it.
  __device__ void arrive() const {
    tq::cp_async_wait<kStages - 1>();
    __syncwarp();
  }

  // Copy a block from shared memory to out (N N floats at off), coalesced
  // over the group.
  __device__ void store(float* out, size_t off, const float* blk, bool vec16) const {
    if (vec16) {
#pragma unroll
      for (int q = 4 * i; q < NN; q += 4 * G)
        *reinterpret_cast<float4*>(out + off + q) = *reinterpret_cast<const float4*>(blk + q);
    } else {
#pragma unroll
      for (int e = i; e < NN; e += G) out[off + e] = blk[e];
    }
  }
};

template <int N>
__global__ void __launch_bounds__(32) chain_factor_kernel(
    const float* __restrict__ Wc, const float* __restrict__ Utc,
    float* __restrict__ Ls, float* __restrict__ CUs, float* __restrict__ schur0,
    int S, int L, int vec16) {
  extern __shared__ __align__(16) float smem[];
  using C = Chain<N>;
  constexpr int G = C::G;
  const C ch(smem, S, L);
  const int i = ch.i;
  const bool row = i < N;
  float* sL = ch.work;
  float* sC = ch.work + C::BF;
  for (int t = 0; t < kStages; ++t) ch.fetch(Wc, Utc, t, vec16);
  float sch[N];  // row i of the previous step's schur
#pragma unroll
  for (int k = 0; k < N; ++k) sch[k] = 0.f;
  for (int t = 0; t < L; ++t) {
    ch.arrive();
    const float* st = ch.stage(t);
    float a[N], u[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      a[k] = row ? __fsub_rn(st[i * N + k], sch[k]) : 0.f;
      // the pivot a_kk + 0 of chol_inplace<false> (a zero shift; -0 -> +0)
      if (k == i) a[k] = __fadd_rn(a[k], 0.f);
      u[k] = row ? st[C::BF + i * N + k] : 0.f;
    }
    __syncwarp();  // the stage is read: refill it kStages steps ahead
    ch.fetch(Wc, Utc, t + kStages, vec16);

    tq::factor_step<N, G>(a, u, sch, sL, sC, i);

    // this step's blocks, once, coalesced over the group
    if (ch.live) {
      const size_t off = ch.base + (size_t)(L - 1 - t) * C::NN;
      ch.store(Ls, off, sL, vec16);
      ch.store(CUs, off, sC, vec16);
    }
  }
  if (ch.live && row) {
#pragma unroll
    for (int k = 0; k < N; ++k) schur0[(size_t)ch.s * C::NN + i * N + k] = sch[k];
  }
}

template <int N>
int launch(const float* Wc, const float* Utc, float* Ls, float* CUs, float* schur0, int S,
           int L, cudaStream_t st) {
  constexpr int chains = 32 / lanes(N);
  const int blocks = (S + chains - 1) / chains;
  const size_t shmem = (size_t)chains * chain_floats(N) * sizeof(float);
  const int vec16 = N % 2 == 0 &&
      (((uintptr_t)Wc | (uintptr_t)Utc | (uintptr_t)Ls | (uintptr_t)CUs) & 15) == 0;
  chain_factor_kernel<N><<<blocks, 32, shmem, st>>>(Wc, Utc, Ls, CUs, schur0, S, L, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

// Wc, Utc, Ls, CUs, schur0, S, L, n, stream
extern "C" int tq_chain_factor(const float* Wc, const float* Utc, float* Ls,
                               float* CUs, float* schur0, int S, int L, int n,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
#define TQ_N(N_) \
  case N_:       \
    return launch<N_>(Wc, Utc, Ls, CUs, schur0, S, L, st);
    TQ_N(1) TQ_N(2) TQ_N(3) TQ_N(4) TQ_N(5) TQ_N(6) TQ_N(7) TQ_N(8)
    TQ_N(9) TQ_N(10) TQ_N(11) TQ_N(12) TQ_N(13) TQ_N(14) TQ_N(15) TQ_N(16)
#undef TQ_N
    default:
      return (int)cudaErrorInvalidValue;
  }
}
