// Block cyclic reduction of the sdunes Jay system in one launch: the SPD
// block-tridiagonal system over adjacent scenario pairs, P blocks of b.
//
// Replaces the Pallas kernel jay_cr_solve of treeqp_tpu/ops/jay_kernel.py
// (reached through sdunes._jay_solve), with its semantics:
// diag [P, b, b], off [P-1, b, b] (block (i+1, i)), rhs [P, b], shift
// [P, b] the per-row Levenberg-Marquardt diagonal (null: none), reg_tol < 0
// to add it always, >= 0 to add it on the fly to a block whose raw pivot
// a_kk rsqrt(max(a_kk, 1e-12)) is <= reg_tol or NaN. Each block's Cholesky
// floors its pivots at 1e-12 and writes d rsqrt(d) on its diagonal.
//
// Level h = 1, 2, 4, ... < P eliminates the lanes with idx % 2h == h and
// updates those with idx % 2h == 0 (C_i holds the block (i, i - h)):
//   odd p:   Z1 = D_p^-1 C_p,  Z2 = D_p^-1 C_{p+h}',  zr = D_p^-1 r_p (saved)
//   even e:  D_e -= C_e Z2_{e-h} + C_{e+h}' Z1_{e+h}
//            r_e -= C_e zr_{e-h} + C_{e+h}' zr_{e+h},  C_e = -C_e Z1_{e-h}
// then lane 0 is solved alone, and back substitution runs deepest level
// first: x_o = zr_o - Z1_o x_{o-h} - Z2_o x_{o+h}. A neighbour past P
// contributes nothing (the Pallas kernel's identity-padded lanes carry
// zeros there). Same operation order as the Pallas kernel and the plain
// twin (jay_kernel.jay_cr_solve_ref): every sum term by term.
//
// Design: one thread block; its threads loop over the blocks of a level,
// with __syncthreads() between the two halves of a level and between the
// levels; the working D, C, r and the saved Z1, Z2, zr per block live in
// global scratch that the wrapper allocates. Any P, b <= 16.
//
// What bounds it on the card: latency. The ceil(log2 P) levels are
// dependent, each a b x b Cholesky and 2b + 1 triangular solves per odd
// block and a few b x b products per even block; the bytes (the operands
// once, ~45 kB at P = 255, b = 4) take nanoseconds.

#include <cuda_runtime.h>

namespace {

constexpr float kJayFloor = 1e-12f;
constexpr int kMaxB = 16;
constexpr int kMaxThreads = 512;

// Lm = chol(W + diag(sh)) (sh may be null), column by column: a = W[:, k]
// (+ sh_k on row k) - sum_{m<k} L[:, m] L[k, m]; d = max(a_kk, 1e-12);
// below the diagonal a rsqrt(d), on it d rsqrt(d). Returns whether every
// raw pivot a_kk rsqrt(max(a_kk, 1e-12)) is > tol (false on NaN).
__device__ bool jay_chol(const float* W, const float* sh, float* Lm, int b, float tol) {
  bool ok = true;
  for (int k = 0; k < b; ++k) {
    for (int i = 0; i < k; ++i) Lm[i * b + k] = 0.f;
    float akk = W[k * b + k];
    if (sh != nullptr) akk = akk + sh[k];
    for (int m = 0; m < k; ++m) akk = akk - Lm[k * b + m] * Lm[k * b + m];
    const float d = fmaxf(akk, kJayFloor);
    const float dinv = rsqrtf(d);
    if (!(akk * dinv > tol)) ok = false;
    for (int i = k + 1; i < b; ++i) {
      float a = W[i * b + k];
      for (int m = 0; m < k; ++m) a = a - Lm[i * b + m] * Lm[k * b + m];
      Lm[i * b + k] = a * dinv;
    }
    Lm[k * b + k] = d * dinv;
  }
  return ok;
}

// The block's factor with the shift rule: mode 0 none, 1 always, 2 on the fly.
__device__ void jay_factor(const float* W, const float* sh, float* Lm, int b, int mode,
                           float reg_tol) {
  if (mode == 1) {
    jay_chol(W, sh, Lm, b, reg_tol);
  } else if (!jay_chol(W, nullptr, Lm, b, reg_tol) && mode == 2) {
    jay_chol(W, sh, Lm, b, reg_tol);
  }
}

// (L L') v = rhs, in place of the local vector v.
__device__ void jay_solve_vec(const float* Lm, float* v, int b) {
  for (int i = 0; i < b; ++i) {
    float a = v[i];
    for (int m = 0; m < i; ++m) a = a - Lm[i * b + m] * v[m];
    v[i] = a / Lm[i * b + i];
  }
  for (int i = b - 1; i >= 0; --i) {
    float a = v[i];
    for (int m = i + 1; m < b; ++m) a = a - Lm[m * b + i] * v[m];
    v[i] = a / Lm[i * b + i];
  }
}

__global__ void jay_cr_kernel(const float* __restrict__ diag, const float* __restrict__ off,
                              const float* __restrict__ rhs, const float* __restrict__ shift,
                              float reg_tol, float* __restrict__ x, float* __restrict__ D,
                              float* __restrict__ C, float* __restrict__ r,
                              float* __restrict__ Z1s, float* __restrict__ Z2s,
                              float* __restrict__ zrs, int P, int b) {
  const int bb = b * b;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int mode = shift == nullptr ? 0 : (reg_tol >= 0.f ? 2 : 1);
  for (int k = tid; k < P * bb; k += nt) {
    D[k] = diag[k];
    C[k] = k < bb ? 0.f : off[k - bb];
  }
  for (int k = tid; k < P * b; k += nt) r[k] = rhs[k];
  __syncthreads();
  float Lm[kMaxB * kMaxB];
  float v[kMaxB];
  int h = 1;
  for (; h < P; h *= 2) {
    // odd blocks: factor, save the elimination operators
    for (int p = h + 2 * h * tid; p < P; p += 2 * h * nt) {
      jay_factor(D + (size_t)p * bb, shift == nullptr ? nullptr : shift + (size_t)p * b,
                 Lm, b, mode, reg_tol);
      const float* Cp = C + (size_t)p * bb;
      const bool right = p + h < P;
      const float* Cr = C + (size_t)(right ? p + h : p) * bb;
      float* Z1 = Z1s + (size_t)p * bb;
      float* Z2 = Z2s + (size_t)p * bb;
      for (int c = 0; c < b; ++c) {
        for (int i = 0; i < b; ++i) v[i] = Cp[i * b + c];
        jay_solve_vec(Lm, v, b);
        for (int i = 0; i < b; ++i) Z1[i * b + c] = v[i];
        for (int i = 0; i < b; ++i) v[i] = right ? Cr[c * b + i] : 0.f;
        jay_solve_vec(Lm, v, b);
        for (int i = 0; i < b; ++i) Z2[i * b + c] = v[i];
      }
      for (int i = 0; i < b; ++i) v[i] = r[(size_t)p * b + i];
      jay_solve_vec(Lm, v, b);
      for (int i = 0; i < b; ++i) zrs[(size_t)p * b + i] = v[i];
    }
    __syncthreads();
    // even blocks: fold in both odd neighbours, row by row (row i of the
    // new D, r, C reads only row i of the old C_e)
    for (int e = 2 * h * tid; e < P; e += 2 * h * nt) {
      const bool left = e >= h;
      const bool right = e + h < P;
      const size_t l = left ? e - h : e;    // a neighbour index only when it exists
      const size_t rt = right ? e + h : e;
      float* Ce = C + (size_t)e * bb;
      float* De = D + (size_t)e * bb;
      const float* Z2l = Z2s + l * bb;
      const float* Z1l = Z1s + l * bb;
      const float* zrl = zrs + l * b;
      const float* Cr = C + rt * bb;
      const float* Z1r = Z1s + rt * bb;
      const float* zrr = zrs + rt * b;
      for (int i = 0; i < b; ++i) {
        for (int j = 0; j < b; ++j) {
          float t1 = 0.f, c1 = 0.f, t2 = 0.f;
          if (left) {
            for (int k = 0; k < b; ++k) {
              t1 += Ce[i * b + k] * Z2l[k * b + j];
              c1 += Ce[i * b + k] * Z1l[k * b + j];
            }
          }
          if (right) {
            for (int k = 0; k < b; ++k) t2 += Cr[k * b + i] * Z1r[k * b + j];
          }
          De[i * b + j] = (De[i * b + j] - t1) - t2;
          v[j] = -c1;
        }
        float rv1 = 0.f, rv2 = 0.f;
        if (left) {
          for (int k = 0; k < b; ++k) rv1 += Ce[i * b + k] * zrl[k];
        }
        if (right) {
          for (int k = 0; k < b; ++k) rv2 += Cr[k * b + i] * zrr[k];
        }
        r[(size_t)e * b + i] = (r[(size_t)e * b + i] - rv1) - rv2;
        for (int j = 0; j < b; ++j) Ce[i * b + j] = v[j];
      }
    }
    __syncthreads();
  }
  // the root, lane 0
  if (tid == 0) {
    jay_factor(D, shift, Lm, b, mode, reg_tol);
    for (int i = 0; i < b; ++i) v[i] = r[i];
    jay_solve_vec(Lm, v, b);
    for (int i = 0; i < b; ++i) x[i] = v[i];
  }
  __syncthreads();
  // back substitution, deepest level first
  for (h /= 2; h >= 1; h /= 2) {
    for (int o = h + 2 * h * tid; o < P; o += 2 * h * nt) {
      const bool right = o + h < P;
      const float* xl = x + (size_t)(o - h) * b;
      const float* xr = x + (size_t)(right ? o + h : o) * b;
      const float* Z1 = Z1s + (size_t)o * bb;
      const float* Z2 = Z2s + (size_t)o * bb;
      for (int i = 0; i < b; ++i) {
        float a1 = 0.f, a2 = 0.f;
        for (int k = 0; k < b; ++k) a1 += Z1[i * b + k] * xl[k];
        if (right) {
          for (int k = 0; k < b; ++k) a2 += Z2[i * b + k] * xr[k];
        }
        x[(size_t)o * b + i] = (zrs[(size_t)o * b + i] - a1) - a2;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// diag, off, rhs, shift (may be null), x, D, C, r, Z1s, Z2s, zrs (scratch:
// [P, b, b] or [P, b]), P, b, reg_tol, stream
extern "C" int tq_jay_cr_solve(const float* diag, const float* off, const float* rhs,
                               const float* shift, float* x, float* D, float* C, float* r,
                               float* Z1s, float* Z2s, float* zrs, int P, int b,
                               float reg_tol, void* stream) {
  int threads = ((P + 1) / 2 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  jay_cr_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      diag, off, rhs, shift, reg_tol, x, D, C, r, Z1s, Z2s, zrs, P, b);
  return (int)cudaGetLastError();
}
