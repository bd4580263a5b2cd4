// Pieces of the lane-group kernels (chain_factor.cu, chain_blocks_factor.cu,
// chain_sweeps.cu, chain_full_solve.cu, newton_iter.cu, admm_identify.cu,
// ric_chain.cu, chain_eval_df.cu, chain_apply_df.cu, chain_cr.cu): the
// cp.async copies of the chain kernels' shared-memory rings and tiles, the broadcast
// lane's true division, the step of the banded backward block Cholesky
// that both chain factor kernels run, a group of lanes per chain with lane
// i owning row i of the step's n x n block, the lane groups' triangular
// solves of one factor block, and the two solve sweeps of the chain factors
// that chain_sweeps.cu, chain_full_solve.cu and newton_iter.cu run.
#pragma once

#include <cuda_runtime.h>

#include "tq_dense.cuh"

namespace tq {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// count floats from src to dst, lane ``lane`` of a group of G copying every
// G-th
__device__ __forceinline__ void copy_async(float* dst, const float* src, int count, int lane,
                                           int G) {
  for (int e = lane; e < count; e += G) cp_async4(dst + e, src + e);
}

// Start copying count T's (4-byte aligned, sizeof(T) a multiple of 4) from
// src to shared memory, by the block's threads: 16-byte copies (a warp's
// lanes on neighbouring addresses) where src and the copy share their
// offset within 16 bytes, 4-byte ones at the ragged ends. buf is 16-byte
// aligned and holds count T's + 16 bytes; returns where src's copy begins.
// The caller commits, waits and synchronizes the block.
template <typename T>
__device__ inline const T* stage_async(void* buf, const T* src, size_t count) {
  const size_t bytes = count * sizeof(T);
  const size_t off = (size_t)src & 15;
  char* dst = static_cast<char*>(buf) + off;
  const char* from = reinterpret_cast<const char*>(src);
  const size_t head = bytes < ((16 - off) & 15) ? bytes : (16 - off) & 15;
  const size_t body = head + ((bytes - head) & ~(size_t)15);
  const size_t t = threadIdx.x, nt = blockDim.x;
  for (size_t b = 4 * t; b < head; b += 4 * nt)
    cp_async4(reinterpret_cast<float*>(dst + b), reinterpret_cast<const float*>(from + b));
  for (size_t b = head + 16 * t; b < body; b += 16 * nt)
    cp_async16(reinterpret_cast<float*>(dst + b), reinterpret_cast<const float*>(from + b));
  for (size_t b = body + 4 * t; b < bytes; b += 4 * nt)
    cp_async4(reinterpret_cast<float*>(dst + b), reinterpret_cast<const float*>(from + b));
  return reinterpret_cast<const T*>(dst);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The dynamic shared memory every kernel may take without opting in.
constexpr size_t kDefaultSmem = 48 * 1024;

// Opt ``kernel`` in to ``bytes`` of dynamic shared memory, once for each new
// high-water mark (``opted``, the kernel's own, from kDefaultSmem).
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes, size_t& opted) {
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) opted = bytes;
  return e;
}

// Lanes a chain: 8 for n <= 8, 16 for n <= 16.
__host__ __device__ constexpr int lanes(int N) { return N <= 8 ? 8 : 16; }

// N N floats rounded up to 4, so that every area starts 16-byte aligned.
__host__ __device__ constexpr int block_floats(int N) { return (N * N + 3) & ~3; }

__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ float signed_zero(float x, float d) {
  return __int_as_float((__float_as_int(x) ^ __float_as_int(d)) & 0x80000000);
}
__device__ __forceinline__ double signed_zero(double x, double d) {
  return __longlong_as_double((__double_as_longlong(x) ^ __double_as_longlong(d)) &
                              (long long)0x8000000000000000ULL);
}

// x / d rounded as the division rounds. A zero x sends the warp's division
// down its slow path, so a zero x over a finite nonzero d is answered by its
// signed zero and the lane divides d by d; the empty asm keeps the compiler
// from dividing x itself and selecting after.
__device__ __forceinline__ float quotient(float x, float d) {
  const bool zero = x == 0.f && d != 0.f && isfinite(d);
  float y = zero ? d : x;
  asm("" : "+f"(y));
  const float q = y / d;
  return zero ? signed_zero(x, d) : q;
}

// x / d for the lane whose quotient is broadcast (``own``), rounded as the
// division rounds; d is the lane's own diagonal (1 past the last row). A
// zero (or any special) dividend sends the whole warp's division down its
// slow path, so the other lanes divide d by d, and a zero x over a finite
// nonzero d is answered by its signed zero without dividing.
template <typename T>
__device__ __forceinline__ T quotient(T x, T d, bool own) {
  const bool zero = x == T(0) && d != T(0) && isfinite(d);
  const T q = div_rn(own && !zero ? x : d, d);
  return zero ? signed_zero(x, d) : q;
}

// One step of the banded backward block Cholesky on lane i's row: on entry
// a holds row i of W_j - schur (the pivot already + 0), u row i of Ut_j and
// sch row i of the previous step's schur; G lanes take part, rows past N-1
// hold zeros. Right-looking Cholesky: for k = 0 .. N-1 lane k's pivot is
// broadcast, every lane takes its rsqrt, lanes i >= k scale their entry,
// column k is broadcast and lanes i > c fold a_ic -= L_ik L_ck by one FMA,
// so each element meets its products in ascending k, the order of the
// left-looking chol_inplace<false> (tq_dense.cuh). Ls_j goes to sL and the
// lane's row of CUs_j = Ut_j Ls_j^-T (true divisions) to sC, both [N, N] in
// shared memory; sch becomes row i of CUs_j CUs_j', each element summed
// over k ascending from 0.
template <int N, int G>
__device__ __forceinline__ void factor_step(float (&a)[N], float (&u)[N], float (&sch)[N],
                                            float* sL, float* sC, int i) {
  const bool row = i < N;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float akk = __shfl_sync(kFull, a[k], k, G);
    const float dinv = rsqrtf(fmaxf(akk, kPivotFloor));
    const float lik = __fmul_rn(a[k], dinv);
    if (i >= k) a[k] = lik;
#pragma unroll
    for (int c = k + 1; c < N; ++c) {
      const float lck = __shfl_sync(kFull, lik, c, G);
      if (i >= c) a[c] = __fmaf_rn(-lik, lck, a[c]);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (row) sL[i * N + k] = k > i ? 0.f : a[k];
  }
  __syncwarp();

  // CU = Ut Ls_j^-T, row i
#pragma unroll
  for (int c = 0; c < N; ++c) {
    float acc = u[c];
#pragma unroll
    for (int m = 0; m < c; ++m) acc = __fmaf_rn(-u[m], sL[c * N + m], acc);
    u[c] = quotient(acc, sL[c * N + c]);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (row) sC[i * N + k] = u[k];
  }
  __syncwarp();

  // schur = CU CU', row i
#pragma unroll
  for (int c = 0; c < N; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) acc = __fmaf_rn(u[k], sC[c * N + k], acc);
    sch[c] = acc;
  }
}

// The triangular solves of one n x n factor L_j (n <= N) on a group of G
// lanes, lane i owning row i, that the sweeps below and chain_cr.cu's
// cyclic-reduction sweeps run. Each sum runs in the order of
// tq_dense.cuh's ltrsv_inplace / uttrsv_inplace, each product folded in by
// one FMA, and the divisions are true divisions (``quotient``).
//
// lane_ltrsv: lane i's entry of y = L_j^-1 t. Lrow holds row i of L_j (the
// entries left of the diagonal are read), diag its diagonal (1 past the
// last row), acc t_i. For k = 0 .. n-1 lane k divides, __shfl_sync
// broadcasts y_k and lanes i > k fold it in, so row i meets its products in
// ascending k; ``each(k, y_k)`` sees every entry in every lane.
template <int N, int G, typename Each>
__device__ __forceinline__ float lane_ltrsv(const float (&Lrow)[N], float diag, float acc, int i,
                                            int n, Each each) {
  float y = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < n) {
      const float yk = __shfl_sync(kFull, quotient(acc, diag, i == k), k, G);
      if (i > k) acc = __fmaf_rn(-Lrow[k], yk, acc);
      each(k, yk);
      if (i == k) y = yk;
    }
  }
  return y;
}

// lane_uttrsv: lane i's entry of z = L_j^-T t. Lcol holds column i of L_j
// (the entries below the diagonal are read), diag its diagonal, acc t_i.
// For k = n-1 .. 0 every lane folds in the entries solved so far, m = k+1
// .. n-1 ascending, lane k's fold (its own column) divides, and
// __shfl_sync broadcasts z_k into z, which ends holding every entry in
// every lane.
template <int N, int G>
__device__ __forceinline__ float lane_uttrsv(const float (&Lcol)[N], float diag, float acc,
                                             float (&z)[N], int i, int n) {
  float x = 0.f;
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    if (k < n) {
      float a = acc;
#pragma unroll
      for (int m = k + 1; m < N; ++m)
        if (m < n) a = __fmaf_rn(-Lcol[m], z[m], a);
      z[k] = __shfl_sync(kFull, quotient(a, diag, i == k), k, G);
      if (i == k) x = z[k];
    }
  }
  return x;
}

// ---------------------------------------------------------------------------
// The two solve sweeps of the chain factors Ls, CUs [S, L, n, n], a group of
// G lanes per chain (G = lanes(n)), lane i owning row i of the step's
// vector in a register (see chain_sweeps.cu for the design):
//   sweep_bwd: ys_j = Ls_j^-1 (r_j - CUs_{j+1} ys_{j+1}) for j = L-1 .. 0;
//     returns row i of radd0 = CUs_0 ys_0;
//   sweep_fwd: dl_j = Ls_j^-T (ys_j - CUs_j' dl_{j-1}) for j = 0 .. L-1,
//     from dl_{-1} = droot.
// Each step hands its row to ``emit(j, value)``; sweep_fwd calls ``pre(j)``
// as step j starts (loads that emit needs can be in flight during the step). Every sum runs in the order
// of tq_dense.cuh's ltrsv_inplace / uttrsv_inplace walked over a chain's
// blocks by one thread, each product folded in by one FMA as nvcc
// contracts those bodies, and the divisions are true divisions: bit for
// bit the thread-per-chain kernels.

constexpr int kSweepStages = 3;

// A stage holds [Ls_j (n n) | CUs_j (n n) | v_j (n)], its stride rounded up
// to 4 floats so that every stage starts 16-byte aligned.
__host__ __device__ inline int sweep_stage_floats(int n) { return (2 * n * n + n + 3) & ~3; }

// A chain's group of G lanes and its ring (kSweepStages stages at ``ring``);
// a group past the last chain (s >= S) reads the last chain's data and is
// not live: its emits store nothing. The vector v is [S, L, n] with its
// entries ``vstride`` floats apart (one column of [S, L, n, vstride], v
// pointing at the column's first entry).
template <int G>
struct SweepGroup {
  int lane;     // the row of the step's vector this lane owns
  int s;        // the chain
  bool live;    // s < S
  size_t nn;
  size_t vs;    // the vector's stride
  float* ring;
  const float* Lc;  // the chain's Ls, CUs and vector slices
  const float* Cc;
  const float* vc;

  __device__ SweepGroup(float* ring_, int lane_, int s_, const float* Ls, const float* CUs,
                        const float* v, int S, int L, int n, int vstride = 1) {
    lane = lane_;
    s = s_;
    live = s < S;
    const size_t sl = live ? s : S - 1;
    nn = (size_t)n * n;
    vs = vstride;
    ring = ring_;
    Lc = Ls + sl * L * nn;
    Cc = CUs + sl * L * nn;
    vc = v + sl * L * n * vs;
  }

  __device__ float* stage(int t, int n) const {
    return ring + (t % kSweepStages) * sweep_stage_floats(n);
  }

  // Copy node j's blocks and vector into the stage of step t (none past the
  // last step), then close the thread's copy group.
  __device__ void fetch(int t, int j, int L, int n, bool vec16) const {
    if (t < L) {
      float* st = stage(t, n);
      const float* Lj = Lc + j * nn;
      const float* Cj = Cc + j * nn;
      if (vec16) {
        for (int q = 4 * lane; q < (int)nn; q += 4 * G) {
          cp_async16(st + q, Lj + q);
          cp_async16(st + nn + q, Cj + q);
        }
      } else {
        for (int e = lane; e < (int)nn; e += G) {
          cp_async4(st + e, Lj + e);
          cp_async4(st + nn + e, Cj + e);
        }
      }
      if (lane < n) cp_async4(st + 2 * nn + lane, vc + ((size_t)j * n + lane) * vs);
    }
    cp_async_commit();
  }

  // Step t's stage has landed and every lane of the group sees it.
  __device__ void arrive() const {
    cp_async_wait<kSweepStages - 1>();
    __syncwarp();
  }
};

template <int G, typename Emit>
__device__ __forceinline__ float sweep_bwd(const SweepGroup<G>& g, int L, int n, bool vec16,
                                           Emit emit) {
  constexpr int N = G < kMaxN ? G : kMaxN;  // rows a lane may own
  const int i = g.lane;
  // step t works on node j = L-1-t
  for (int t = 0; t < kSweepStages; ++t) g.fetch(t, L - 1 - t, L, n, vec16);
  float radd = 0.f;  // row i of CUs_{j+1} y_{j+1}
  for (int t = 0; t < L; ++t) {
    g.arrive();
    const float* st = g.stage(t, n);
    float Lrow[N], Crow[N];
    float diag = 1.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const bool in = k < n && i < n;
      Lrow[k] = in ? st[i * n + k] : 0.f;
      Crow[k] = in ? st[g.nn + i * n + k] : 0.f;
      if (in && k == i) diag = Lrow[k];
    }
    float acc = i < n ? st[2 * g.nn + i] - radd : 0.f;
    __syncwarp();  // the stage is read: refill it kSweepStages steps ahead
    g.fetch(t + kSweepStages, L - 1 - t - kSweepStages, L, n, vec16);
    float racc = 0.f;
    const float y = lane_ltrsv<N, G>(Lrow, diag, acc, i, n, [&](int k, float yk) {
      racc = __fmaf_rn(Crow[k], yk, racc);
    });
    radd = racc;
    emit(L - 1 - t, y);
  }
  return radd;
}

template <int G, typename Pre, typename Emit>
__device__ __forceinline__ void sweep_fwd(const SweepGroup<G>& g, const float* droot, int L,
                                          int n, bool vec16, Pre pre, Emit emit) {
  constexpr int N = G < kMaxN ? G : kMaxN;  // rows a lane may own
  const int i = g.lane;
  for (int t = 0; t < kSweepStages; ++t) g.fetch(t, t, L, n, vec16);
  // the previous node's direction, every entry in every lane
  float z[N];
#pragma unroll
  for (int k = 0; k < N; ++k) z[k] = k < n ? droot[k] : 0.f;
  for (int j = 0; j < L; ++j) {
    pre(j);
    g.arrive();
    const float* st = g.stage(j, n);
    float Lcol[N], Ccol[N];  // column i of Ls_j and of CUs_j
    float diag = 1.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const bool in = k < n && i < n;
      Lcol[k] = in ? st[k * n + i] : 0.f;
      Ccol[k] = in ? st[g.nn + k * n + i] : 0.f;
      if (in && k == i) diag = Lcol[k];
    }
    const float v = i < n ? st[2 * g.nn + i] : 0.f;
    __syncwarp();
    g.fetch(j + kSweepStages, j + kSweepStages, L, n, vec16);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < n) acc = __fmaf_rn(Ccol[k], z[k], acc);
    emit(j, lane_uttrsv<N, G>(Lcol, diag, v - acc, z, i, n));
  }
}

}  // namespace tq
