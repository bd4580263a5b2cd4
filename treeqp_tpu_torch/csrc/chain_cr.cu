// Cyclic-reduction (parallel-scan) variants of the chain solve sweeps, with
// chain_factor's factors Ls, CUs [S, L, n, n].
//
// Replaces the Pallas kernels chain_cr_precompute, chain_solve_bwd_cr and
// chain_forward_cr of treeqp_tpu/ops/chain_cr.py. The serial sweeps
// (chain_sweeps.cu) are L dependent triangular steps; written as affine
// recurrences
//   bwd: y_j = b_j + A_j y_{j+1},  A_j = -L_j^-1 CU_{j+1} (A_{L-1} = 0),
//        b_j = L_j^-1 r_j;
//   fwd: d_j = c_j + B_j d_{j-1},  B_j = -L_j^-T CU_j',
//        c_j = L_j^-T y_j, with B_0 droot folded into c_0,
// they are a suffix and a prefix scan: ceil(log2 L) doubling levels of
// independent n x n compositions. A and B depend only on the factors and
// are built once per factorization (chain_cr_precompute).
//
// chain_cr_precompute. What bounds it on the card: latency. It moves each
// node's blocks once (Ls_j, CUs_j in, Abwd_j, Bfwd_j out: 4 S L n^2
// floats, 1.2 MB at the pruned shape, microseconds below the card's byte
// rate) and does 2 n triangular solves a node, far below its FP32 rate; a
// node's critical path is one n-row solve, n true divisions and the FMAs
// of its longest row in series. Design:
// - The precompute has no recurrence, so no block a chain: a block takes P
//   = 32 / G consecutive nodes t = s L + j of the flat [S L, n, n] layout,
//   across chain boundaries, so no chain is too long for it.
// - A node gets 2 G lanes, G = tq::lanes(n) (8 for n <= 8, 16 for n <=
//   16): lane k of its A group solves column k of Abwd_j, lane k of its B
//   group column k of Bfwd_j; lanes k >= n idle. The block's A groups fill
//   its first P G threads and its B groups the rest, whole warps each, so a
//   node's two dependency chains run side by side in different warps, with
//   no divergence. The kernel is instantiated per G, so every loop over
//   rows and m runs to the compile-time G under an i < n / m < n mask and
//   unrolls: the lane's column stays in registers. One column a lane, not
//   a row a lane: the n columns are independent, so no shuffle is needed.
// - Before any arithmetic, the block's P n^2 floats of Ls start on their
//   way to shared memory as one range (tq::stage_async: 16-byte copies but
//   for an odd n's ragged ends). The 32 / G groups of a warp read the same
//   entry of as many nodes, n^2 floats apart: 4-way bank conflicts at n =
//   8, 2-way at n = 16, but only in the triangle's loads before the chain
//   (regions padded to G mod 32 floats a node, free of them, measured
//   0.0001-0.0003 ms faster at n = 8 and slower at every other n on an
//   H100; PERF.md). While the copies fly, each lane loads its column k
//   of CUs_{j+1} (A) or row k of CUs_j (B) straight from global memory
//   into registers: each CU entry is read once, by one lane, so a copy in
//   shared memory would buy nothing but a second trip (and B's rows, n
//   floats apart a lane, bank conflicts). One
//   wait, one barrier, no further barrier. Node j = L - 1 loads nothing
//   for A and writes +0 (A_{L-1} = 0), so no CU block past the tensor's
//   last node is read.
// - After the barrier each lane loads the lower triangle of Ls_j into
//   registers (n (n + 1) / 2 broadcasts, 136 floats at n = 16) before any
//   arithmetic: both solves read just those entries, and the dependent
//   chain of FMAs and divisions then waits on no load (read from shared
//   memory inside the chain, the loads doubled its time at n = 16).
// - Every element keeps the one-thread order of tq_dense.cuh's
//   ltrsv_inplace (A: rows ascending, products m = 0 .. i-1) and
//   uttrsv_inplace (B: rows descending, products m = i+1 .. n-1), each
//   product folded in by one FMA as nvcc contracts `acc -= L v`, true
//   divisions, the result negated on store: bit for bit the thread-per-
//   column kernel it replaces.
// - Stores: a group writes row i of its node's result as n contiguous
//   floats, lane k entry k. (Staging the result in shared memory for
//   16-byte stores of the node's n^2 contiguous floats measured no faster
//   on an H100 at any shape; PERF.md.)
// No tensor cores, as for the sweeps below. What bounds it now: a launch
// in a CUDA graph takes ~2.2 us on an H100 at n = 1; the rest, ~2-3 us
// more at n = 8 and n = 16, is the chain of divisions and FMAs (B's row i folds
// the newest v_{i+1} first, so its row's FMAs wait in series).
//
// The sweeps. What bounds them on the card: latency. A sweep moves each
// chain's operators once (S L n^2 f32, 0.3-1 MB a launch) and does about
// 2 L n^3 log2(L) flops a chain, microseconds below the card's byte and
// FP32 rates. Its critical path is one n-row triangular solve (n rounds of
// a division and a shuffle) and ceil(log2 L) dependent levels of n-term
// dot products, each closed by block barriers. Design:
// - One block a chain, a group of G = tq::lanes(n) lanes a chain node (8
//   for n <= 8, 16 for n <= 16), lane i owning row i. The kernels are
//   instantiated per G, so every loop over rows, columns or m runs to a
//   compile-time bound under an i < n / m < n mask and unrolls. A block
//   holds P groups (whole warps, at most 1024 threads); a longer chain's
//   groups take nodes j, j + P, j + 2P, .. in rounds, ascending for the
//   suffix scan and descending for the prefix scan, so that no round
//   overwrites a node that a later round of the same level still reads.
// - Before any arithmetic, every copy of the chain's operators (Abwd or
//   Bfwd, L n^2 contiguous floats) and of CUs_0 (bwd) into shared memory is
//   started by cp.async (tq::stage_async: 16-byte copies where the source
//   and its copy share their offset within 16 bytes, 4-byte ones at the
//   ends). While they fly, each group loads its node's row (bwd) or column
//   (fwd) of Ls_j and right-hand side into registers and solves b_j =
//   Ls_j^-1 r_j or c_j = Ls_j^-T y_j in shuffles (tq_lanes.cuh's lane_ltrsv
//   / lane_uttrsv), every j at once; group 0 of the forward sweep adds the
//   root term B_0 droot, its row loaded beside the factor's. One wait, one
//   barrier.
// - A doubling level: lane (j, i) keeps row i of its operator M_j and its
//   entry v_i in registers across the levels (one round; a longer chain
//   reloads them each round), reads its partner q = j +- h's M_q and v_q
//   from shared memory as broadcasts within the group (16-byte reads where
//   n % 4 == 0 and the operators are 16-byte aligned), and forms vn_i = v_i
//   + M_j[i,:] v_q and, below the last level, Mn_j[i,:] = M_j[i,:] M_q (no
//   change where q leaves the chain, Mn_j = 0 there); a barrier, the
//   write-back of its row and v_i, a barrier. The operators are
//   single-buffered, so a chain of L (n^2 + n) floats within the 227 KB
//   one block may take stays in shared memory (S = 4, L = 130, n = 16: 139
//   KB); only a longer chain's operators and vectors go to the caller's
//   global scratch (ops/chain_cr.py's sweep_launch). The last level writes
//   nothing back: each lane writes its entry of the result once (n
//   contiguous floats a node), and group 0 of the backward sweep forms
//   radd0 = CUs_0 y_0 from shuffles of y_0.
// Every sum runs in the order of the per-thread form (tq_dense.cuh's
// ltrsv_inplace / uttrsv_inplace for the solves, m ascending for the
// levels' and the root term's dot products, k ascending for radd0), each
// product folded in by one FMA as nvcc contracts those loops, and the
// divisions are true divisions. No tensor cores: wgmma needs 64-row tiles
// and would pad n = 6 to 64, and TF32 mma would change the bits of every
// sum.
// What still holds a sweep back: at L <= 20, n <= 8 a launch takes ~5 us
// in a CUDA graph on an H100, against ~3 us for chains of one or two
// nodes; the rest is the staging's global round trip, the n division
// rounds and the levels' barriers. A long, wide chain is bound by shared memory instead: each
// lane reads its partner's whole block a level (n^2 floats, n^2 / 4
// 16-byte reads), so one block's L G lanes take about L G n^2 / 32 bank
// cycles a level, the row write-back meets bank conflicts where n is a
// multiple of 8, and a chain of more than 1024 / G nodes runs its levels
// in rounds on the one SM that holds it.

#include <cstdint>

#include "tq_lanes.cuh"


namespace {

// A precompute block: P = 32 / G nodes, one warp of A's lanes and one of B's.
constexpr int kPreThreads = 64;
__host__ __device__ constexpr int pre_nodes(int n) { return 32 / tq::lanes(n); }

// Shared memory of a precompute block, in bytes: its Ls blocks, one range
// at its source's offset within 16 bytes (tq::stage_async).
inline size_t pre_smem_bytes(int n) { return (size_t)pre_nodes(n) * n * n * sizeof(float) + 16; }

// Where row i of a lower triangle starts in its row-major packing.
__host__ __device__ constexpr int tri(int i) { return i * (i + 1) / 2; }

template <int G>
__global__ void __launch_bounds__(kPreThreads) chain_cr_precompute_kernel(
    const float* __restrict__ Ls, const float* __restrict__ CUs, float* __restrict__ Abwd,
    float* __restrict__ Bfwd, long T, int L, int n) {
  extern __shared__ __align__(16) float smem[];
  constexpr int N = G, P = 32 / G;
  const int nn = n * n;
  const long t0 = (long)blockIdx.x * P;
  const int cnt = T - t0 < P ? (int)(T - t0) : P;
  const float* Lb = tq::stage_async(smem, Ls + t0 * nn, (size_t)cnt * nn);
  tq::cp_async_commit();
  // the thread's side (A: the first P G threads), node t and column k
  const bool bside = threadIdx.x >= P * G;
  const int lane = threadIdx.x - (bside ? P * G : 0), p = lane / G, k = lane % G;
  const long t = t0 + p;
  const bool node = p < cnt, zero = !bside && t % L == L - 1;  // A_{L-1} = 0
  // column k of CUs_{t+1} (A) or row k of CUs_t (B), zeros past row n
  const float* C = CUs + (bside ? t * nn + k * n : (t + 1) * nn + k);
  const int step = bside ? 1 : n;
  const bool load = node && k < n && !zero;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = load && i < n ? C[i * step] : 0.f;
  tq::cp_async_wait<0>();
  __syncthreads();
  if (node) {
    // Ls_t's lower triangle into registers, row i at tri(i), before any
    // arithmetic: no load waits inside the chain of FMAs and divisions
    const float* Lj = Lb + p * nn;
    float Lt[tri(N)];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int m = 0; m <= i; ++m) Lt[tri(i) + m] = i < n ? Lj[i * n + m] : 1.f;
    if (!bside) {  // Ls_t v = c: ltrsv_inplace's order
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i < n) {
          float acc = v[i];
#pragma unroll
          for (int m = 0; m < i; ++m) acc = __fmaf_rn(-Lt[tri(i) + m], v[m], acc);
          v[i] = tq::quotient(acc, Lt[tri(i) + i]);
        }
      }
    } else {  // Ls_t' v = c: uttrsv_inplace's order
#pragma unroll
      for (int i = N - 1; i >= 0; --i) {
        if (i < n) {
          float acc = v[i];
#pragma unroll
          for (int m = i + 1; m < N; ++m)
            if (m < n) acc = __fmaf_rn(-Lt[tri(m) + i], v[m], acc);
          v[i] = tq::quotient(acc, Lt[tri(i) + i]);
        }
      }
    }
  }
  float* out = (bside ? Bfwd : Abwd) + t * nn;
  if (node && k < n) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) out[i * n + k] = zero ? 0.f : -v[i];
  }
}

template <int G>
int launch_pre(const float* Ls, const float* CUs, float* Abwd, float* Bfwd, long T, int L,
               int n, cudaStream_t st) {
  constexpr int P = 32 / G;
  const long blocks = (T + P - 1) / P;
  chain_cr_precompute_kernel<G><<<(unsigned)blocks, kPreThreads, pre_smem_bytes(n), st>>>(
      Ls, CUs, Abwd, Bfwd, T, L, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The sweeps

constexpr int kMaxThreads = 1024;  // a sweep block's threads, at most

// Shared memory of a sweep block, in floats: the chain's operators as
// stage_async fills them (L n^2 rounded up to 4, and 4 for their offset
// within 16 bytes), its vectors (L n rounded up to 4), then CUs_0 as the
// operators (read by the backward sweep's radd0).
__host__ __device__ inline size_t op_floats(int L, int n) {
  return (((size_t)L * n * n + 3) & ~(size_t)3) + 4;
}
__host__ __device__ inline size_t vec_floats(int L, int n) {
  return ((size_t)L * n + 3) & ~(size_t)3;
}
inline size_t sweep_smem_bytes(int L, int n) {
  return (op_floats(L, n) + vec_floats(L, n) + op_floats(1, n)) * sizeof(float);
}

// Threads of a sweep block: P groups of G lanes, the chain's L nodes in
// ceil(L G / 1024) rounds, P rounded up to whole warps.
inline int sweep_threads(int L, int n) {
  const int G = tq::lanes(n), per = 32 / G;
  const int rounds = (L * G + kMaxThreads - 1) / kMaxThreads;
  const int P = ((L + rounds - 1) / rounds + per - 1) / per * per;
  return P * G;
}

// The doubling levels of one chain: M [L, n, n] and v [L, n], its operators
// and vectors (shared memory or the scratch), updated in place; kSuffix:
// the partner of node j is j + h (bwd), else j - h (fwd). Every thread
// calls ``emit(j, y)`` once a round with its entry y of the result at node
// j (no node where j >= L; the round of node 0 where j equals the thread's
// group).
template <int G, bool kQuad, bool kSuffix, typename Emit>
__device__ __forceinline__ void doubling_scan(float* M, float* v, int L, int n, Emit emit) {
  constexpr int N = G;
  const int i = threadIdx.x % G, g = threadIdx.x / G, P = blockDim.x / G;
  const int rounds = (L + P - 1) / P;
  const int nn = n * n;
  float Mrow[N], vi = 0.f;  // the lane's row of M_j and entry of v_j
  auto load = [&](int j) {
    const bool in = j < L && i < n;
    const float* Mj = M + j * nn + i * n;
#pragma unroll
    for (int k = 0; k < N; ++k) Mrow[k] = 0.f;
    if (in) {
      if constexpr (kQuad) {
#pragma unroll
        for (int k = 0; k < N; k += 4) {
          if (k < n) {
            const float4 t = *reinterpret_cast<const float4*>(Mj + k);
            Mrow[k] = t.x;
            Mrow[k + 1] = t.y;
            Mrow[k + 2] = t.z;
            Mrow[k + 3] = t.w;
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k)
          if (k < n) Mrow[k] = Mj[k];
      }
    }
    vi = in ? v[j * n + i] : 0.f;
  };
  if (rounds == 1) load(g);
  if (L == 1) {
    emit(g, vi);
    return;
  }
  for (int h = 1; h < L; h *= 2) {
    const bool last = 2 * h >= L;
    for (int r = 0; r < rounds; ++r) {
      const int j = (kSuffix ? r : rounds - 1 - r) * P + g;
      if (rounds > 1) load(j);
      const int q = kSuffix ? j + h : j - h;
      float vn = vi, Mn[N];
#pragma unroll
      for (int k = 0; k < N; ++k) Mn[k] = 0.f;
      if (j < L && q >= 0 && q < L) {
        const float* vq = v + q * n;
        float acc = 0.f;
        if constexpr (kQuad) {
#pragma unroll
          for (int m = 0; m < N; m += 4) {
            if (m < n) {
              const float4 t = *reinterpret_cast<const float4*>(vq + m);
              acc = __fmaf_rn(Mrow[m], t.x, acc);
              acc = __fmaf_rn(Mrow[m + 1], t.y, acc);
              acc = __fmaf_rn(Mrow[m + 2], t.z, acc);
              acc = __fmaf_rn(Mrow[m + 3], t.w, acc);
            }
          }
        } else {
#pragma unroll
          for (int m = 0; m < N; ++m)
            if (m < n) acc = __fmaf_rn(Mrow[m], vq[m], acc);
        }
        vn = __fadd_rn(vi, acc);
        if (!last) {
          const float* Mq = M + q * nn;
#pragma unroll
          for (int m = 0; m < N; ++m) {
            if (m < n) {
              const float a = Mrow[m];
              const float* row = Mq + m * n;
              if constexpr (kQuad) {
#pragma unroll
                for (int k = 0; k < N; k += 4) {
                  if (k < n) {
                    const float4 t = *reinterpret_cast<const float4*>(row + k);
                    Mn[k] = __fmaf_rn(a, t.x, Mn[k]);
                    Mn[k + 1] = __fmaf_rn(a, t.y, Mn[k + 1]);
                    Mn[k + 2] = __fmaf_rn(a, t.z, Mn[k + 2]);
                    Mn[k + 3] = __fmaf_rn(a, t.w, Mn[k + 3]);
                  }
                }
              } else {
#pragma unroll
                for (int k = 0; k < N; ++k)
                  if (k < n) Mn[k] = __fmaf_rn(a, row[k], Mn[k]);
              }
            }
          }
        }
      }
      if (last) {
        emit(j, vn);
        continue;
      }
      __syncthreads();  // every read of this round is done
      if (j < L && i < n) {
        v[j * n + i] = vn;
        float* Mj = M + j * nn + i * n;
        if constexpr (kQuad) {
#pragma unroll
          for (int k = 0; k < N; k += 4)
            if (k < n)
              *reinterpret_cast<float4*>(Mj + k) = make_float4(Mn[k], Mn[k + 1], Mn[k + 2], Mn[k + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < N; ++k)
            if (k < n) Mj[k] = Mn[k];
        }
      }
      vi = vn;
#pragma unroll
      for (int k = 0; k < N; ++k) Mrow[k] = Mn[k];
      __syncthreads();  // the level's operators are written
    }
  }
}

// Where the backward sweep finds CUs_0 of the chain at CU0: its copy in
// shared memory (as stage_async places it), or CU0 itself beside a scratch.
template <bool kScratch>
__device__ __forceinline__ const float* cu0_copy(const float* CU0, int L, int n) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kScratch) return CU0;
  return reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(smem + op_floats(L, n) + vec_floats(L, n)) +
      ((uintptr_t)CU0 & 15));
}

// The chain's operators (and CUs_0 for the backward sweep, CU0 not null)
// on their way to shared memory, or copied into the scratch: sets M and v.
template <bool kScratch>
__device__ __forceinline__ void stage_chain(const float* op, const float* CU0, float* scratch,
                                            int L, int n, float*& M, float*& v) {
  extern __shared__ __align__(16) float smem[];
  const size_t chain = (size_t)L * n * n;
  if constexpr (kScratch) {
    M = scratch + (size_t)blockIdx.x * (chain + (size_t)L * n);
    v = M + chain;
    for (size_t e = threadIdx.x; e < chain; e += blockDim.x) M[e] = op[e];
  } else {
    M = const_cast<float*>(tq::stage_async(smem, op, chain));
    v = smem + op_floats(L, n);
    if (CU0 != nullptr) tq::stage_async(v + vec_floats(L, n), CU0, (size_t)n * n);
    tq::cp_async_commit();
  }
}

template <int G, bool kQuad, bool kScratch>
__global__ void __launch_bounds__(kMaxThreads) chain_solve_bwd_cr_kernel(
    const float* __restrict__ Ls, const float* __restrict__ CUs,
    const float* __restrict__ Abwd, const float* __restrict__ res,
    float* __restrict__ ys, float* __restrict__ radd0, float* scratch, int L, int n) {
  constexpr int N = G;
  const int s = blockIdx.x;
  const int i = threadIdx.x % G, g = threadIdx.x / G, P = blockDim.x / G;
  const size_t nn = (size_t)n * n, chain = (size_t)L * nn, vec = (size_t)L * n;
  float *M, *v;
  stage_chain<kScratch>(Abwd + s * chain, CUs + s * chain, scratch, L, n, M, v);
  // b_j = Ls_j^-1 res_j, a group a node (a group past the chain solves its
  // last node and keeps nothing)
  for (int j0 = 0; j0 < L; j0 += P) {
    const int j = j0 + g, jl = j < L ? j : L - 1;
    const float* Lr = Ls + s * chain + jl * nn + (size_t)i * n;
    float Lrow[N], diag = 1.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const bool in = i < n && k <= i;
      Lrow[k] = in ? Lr[k] : 0.f;
      if (in && k == i) diag = Lrow[k];
    }
    const float r = i < n ? res[s * vec + jl * n + i] : 0.f;
    const float b = tq::lane_ltrsv<N, G>(Lrow, diag, r, i, n, [](int, float) {});
    if (j < L && i < n) v[j * n + i] = b;
  }
  if constexpr (!kScratch) tq::cp_async_wait<0>();
  __syncthreads();
  doubling_scan<G, kQuad, true>(M, v, L, n, [&](int j, float y) {
    if (j < L && i < n) ys[s * vec + j * n + i] = y;
    if (j == g && threadIdx.x < 32) {  // the warp of node 0: radd0 = CUs_0 y_0
      const float* C0 = cu0_copy<kScratch>(CUs + s * chain, L, n);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (k < n) {
          const float yk = __shfl_sync(tq::kFull, y, k, G);
          if (i < n) acc = __fmaf_rn(C0[i * n + k], yk, acc);
        }
      }
      if (g == 0 && i < n) radd0[(size_t)s * n + i] = acc;
    }
  });
}

template <int G, bool kQuad, bool kScratch>
__global__ void __launch_bounds__(kMaxThreads) chain_forward_cr_kernel(
    const float* __restrict__ Ls, const float* __restrict__ Bfwd,
    const float* __restrict__ ys, const float* __restrict__ droot,
    float* __restrict__ dls, float* scratch, int L, int n) {
  constexpr int N = G;
  const int s = blockIdx.x;
  const int i = threadIdx.x % G, g = threadIdx.x / G, P = blockDim.x / G;
  const size_t nn = (size_t)n * n, chain = (size_t)L * nn, vec = (size_t)L * n;
  float *M, *v;
  stage_chain<kScratch>(Bfwd + s * chain, nullptr, scratch, L, n, M, v);
  // c_j = Ls_j^-T ys_j, a group a node, and c_0 += B_0 droot
  for (int j0 = 0; j0 < L; j0 += P) {
    const int j = j0 + g, jl = j < L ? j : L - 1;
    const float* Lc = Ls + s * chain + jl * nn + i;
    float Lcol[N], diag = 1.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const bool in = i < n && k >= i && k < n;
      Lcol[k] = in ? Lc[k * n] : 0.f;
      if (in && k == i) diag = Lcol[k];
    }
    const float t = i < n ? ys[s * vec + jl * n + i] : 0.f;
    float root = 0.f;  // row i of B_0 droot
    if (j == 0 && i < n) {
      const float* B0 = Bfwd + s * chain + (size_t)i * n;
      const float* dr = droot + (size_t)s * n;
#pragma unroll
      for (int m = 0; m < N; ++m)
        if (m < n) root = __fmaf_rn(B0[m], dr[m], root);
    }
    float z[N] = {};
    float c = tq::lane_uttrsv<N, G>(Lcol, diag, t, z, i, n);
    if (j == 0) c = __fadd_rn(c, root);
    if (j < L && i < n) v[j * n + i] = c;
  }
  if constexpr (!kScratch) tq::cp_async_wait<0>();
  __syncthreads();
  doubling_scan<G, kQuad, false>(M, v, L, n, [&](int j, float d) {
    if (j < L && i < n) dls[s * vec + j * n + i] = d;
  });
}

template <int G, bool kQuad, bool kScratch>
int launch_bwd(const float* Ls, const float* CUs, const float* Abwd, const float* res,
               float* ys, float* radd0, float* scratch, int S, int L, int n, cudaStream_t st) {
  const size_t bytes = kScratch ? 0 : sweep_smem_bytes(L, n);
  static size_t opted = tq::kDefaultSmem;
  const cudaError_t e = tq::opt_in(chain_solve_bwd_cr_kernel<G, kQuad, kScratch>, bytes, opted);
  if (e != cudaSuccess) return (int)e;
  chain_solve_bwd_cr_kernel<G, kQuad, kScratch><<<S, sweep_threads(L, n), bytes, st>>>(
      Ls, CUs, Abwd, res, ys, radd0, scratch, L, n);
  return (int)cudaGetLastError();
}

template <int G, bool kQuad, bool kScratch>
int launch_fwd(const float* Ls, const float* Bfwd, const float* ys, const float* droot,
               float* dls, float* scratch, int S, int L, int n, cudaStream_t st) {
  const size_t bytes = kScratch ? 0 : sweep_smem_bytes(L, n);
  static size_t opted = tq::kDefaultSmem;
  const cudaError_t e = tq::opt_in(chain_forward_cr_kernel<G, kQuad, kScratch>, bytes, opted);
  if (e != cudaSuccess) return (int)e;
  chain_forward_cr_kernel<G, kQuad, kScratch><<<S, sweep_threads(L, n), bytes, st>>>(
      Ls, Bfwd, ys, droot, dls, scratch, L, n);
  return (int)cudaGetLastError();
}

// The form of a sweep (in a function with n and scratch): 16-byte reads of
// the operators where n % 4 == 0 and they start 16-byte aligned (then every
// chain's and row's do), the global scratch where the caller passes one.
#define TQ_CR_DISPATCH(LAUNCH, op, ...)                                             \
  if (scratch != nullptr)                                                           \
    return n <= 8 ? LAUNCH<8, false, true>(__VA_ARGS__)                             \
                  : LAUNCH<16, false, true>(__VA_ARGS__);                           \
  if (n % 4 == 0 && ((uintptr_t)(op) & 15) == 0)                                    \
    return n <= 8 ? LAUNCH<8, true, false>(__VA_ARGS__)                             \
                  : LAUNCH<16, true, false>(__VA_ARGS__);                           \
  return n <= 8 ? LAUNCH<8, false, false>(__VA_ARGS__) : LAUNCH<16, false, false>(__VA_ARGS__)

}  // namespace

// Ls, CUs, Abwd, Bfwd, S, L, n, stream
extern "C" int tq_chain_cr_precompute(const float* Ls, const float* CUs, float* Abwd,
                                      float* Bfwd, int S, int L, int n, void* stream) {
  const long T = (long)S * L;
  const auto st = (cudaStream_t)stream;
  return tq::lanes(n) == 8 ? launch_pre<8>(Ls, CUs, Abwd, Bfwd, T, L, n, st)
                           : launch_pre<16>(Ls, CUs, Abwd, Bfwd, T, L, n, st);
}

// n, out: out[0] the threads of a precompute block, out[1] its dynamic
// shared memory in bytes (ops/chain_cr.py's precompute_launch mirrors both)
extern "C" int tq_chain_cr_precompute_launch(int n, int* out) {
  out[0] = kPreThreads;
  out[1] = (int)pre_smem_bytes(n);
  return 0;
}

// Ls, CUs, Abwd, res, ys, radd0, scratch (NULL: shared memory), S, L, n, stream
extern "C" int tq_chain_solve_bwd_cr(const float* Ls, const float* CUs,
                                     const float* Abwd, const float* res, float* ys,
                                     float* radd0, float* scratch, int S, int L, int n,
                                     void* stream) {
  TQ_CR_DISPATCH(launch_bwd, Abwd, Ls, CUs, Abwd, res, ys, radd0, scratch, S, L, n,
                 (cudaStream_t)stream);
}

// Ls, Bfwd, ys, droot, dls, scratch (NULL: shared memory), S, L, n, stream
extern "C" int tq_chain_forward_cr(const float* Ls, const float* Bfwd, const float* ys,
                                   const float* droot, float* dls, float* scratch,
                                   int S, int L, int n, void* stream) {
  TQ_CR_DISPATCH(launch_fwd, Bfwd, Ls, Bfwd, ys, droot, dls, scratch, S, L, n,
                 (cudaStream_t)stream);
}

// L, n, out: out[0] the threads of a sweep block, out[1] its dynamic shared
// memory in bytes when the chain stays in shared memory (ops/chain_cr.py's
// sweep_launch mirrors both)
extern "C" int tq_chain_cr_sweep_launch(int L, int n, int* out) {
  out[0] = sweep_threads(L, n);
  out[1] = (int)sweep_smem_bytes(L, n);
  return 0;
}
