// Pieces of the lane-group kernels (chain_factor.cu, chain_blocks_factor.cu,
// chain_sweeps.cu, admm_identify.cu): the cp.async copies of the chain
// kernels' shared-memory rings, the broadcast lane's true division, and
// the step of the banded backward block Cholesky that both chain factor
// kernels run, a group of lanes per chain with lane i owning row i of the
// step's n x n block.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

}  // namespace tq
