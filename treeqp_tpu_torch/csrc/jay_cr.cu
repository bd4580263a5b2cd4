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
// Level h = 1, 2, 4, ... < P eliminates the blocks with idx % 2h == h and
// updates those with idx % 2h == 0 (C_i holds the block (i, i - h)):
//   odd p:   Z1 = D_p^-1 C_p,  Z2 = D_p^-1 C_{p+h}',  zr = D_p^-1 r_p (saved)
//   even e:  D_e -= C_e Z2_{e-h} + C_{e+h}' Z1_{e+h}
//            r_e -= C_e zr_{e-h} + C_{e+h}' zr_{e+h},  C_e = -C_e Z1_{e-h}
// then block 0 is solved alone, and back substitution runs deepest level
// first: x_o = zr_o - Z1_o x_{o-h} - Z2_o x_{o+h}. A neighbour past P
// contributes nothing (the Pallas kernel's identity-padded lanes carry
// zeros there).
//
// What bounds it on the card: latency. The ceil(log2 P) levels are
// dependent, each a b x b Cholesky and 2b + 1 triangular solves per odd
// block and three b x b products per even block, with a barrier between
// the halves of a level; the operands (~45 kB at P = 255, b = 4) take
// nanoseconds at the memory rate. The one-thread-per-block kernel this
// replaces spent ~23 us a level there: a thread did a whole Cholesky and
// its 2b + 1 solves alone, its factor and vectors in local memory, the
// operands in global scratch. Design:
// - One thread block. A group of GL lanes takes a block system: GL = 4 for
//   b <= 4, 8 for b <= 8, 16 for b <= 16 (8, 4 or 2 systems a warp), the
//   groups striding over a level's blocks (up to 1024 threads for b <= 4,
//   512 beyond, so that a thread's columns stay in registers).
// - The Cholesky is right-looking, lane i owning row i in registers: lane
//   k's pivot and the column's entries go out by width-GL shuffles, and
//   lanes i >= c fold a_ic -= L_ik L_ck by one FMA, so each entry meets its
//   products in ascending k, the order of the left-looking per-thread
//   factor. The factor goes to the group's slot of shared memory.
// - The 2b + 1 right-hand sides (Z1's b columns, Z2's b columns, zr) are
//   split over the group's lanes, a lane taking whole columns (at most
//   three), each solved forward and back in registers against the factor in
//   shared memory. A lane owning a row instead would have to keep every
//   solved entry of every column for the back substitution's ascending
//   sums (b (2b + 1) registers: 528 at b = 16).
// - The even blocks' updates and the back substitution run a lane per row,
//   the k-sums in the one-thread kernel's order.
// - D, C, Z1, Z2, r, zr and x live in shared memory when they fit one
//   block's 227 KB with the groups' factor slots (P = 255, b = 4: 86 KB);
//   otherwise in global scratch the wrapper allocates (tq_jay_cr_scratch),
//   which stays in L2, read by the same code. A block's b x b operands are
//   b^2 + 1 floats apart, so that the groups of a warp, which read
//   neighbouring blocks' entries at the same offset, hit different banks.
// Every product is the FMA or rounded multiply that nvcc made of the
// one-thread kernel's expressions, written out, and every division a true
// division: bit for bit that kernel. No tensor cores: the blocks are b <= 16
// and each step depends on the last.

#include <cuda_runtime.h>

#include "tq_lanes.cuh"

namespace {

constexpr float kJayFloor = 1e-12f;
constexpr int kMaxB = 16;
constexpr size_t kSmemBytes = 232448;  // a block's shared memory on sm_90

// Lanes a block system: 4 for b <= 4, 8 for b <= 8, 16 for b <= 16.
__host__ __device__ constexpr int jay_lanes(int b) { return b <= 4 ? 4 : (b <= 8 ? 8 : 16); }
// Threads a block at most: 1024 for b <= 4; 512 beyond, where a thread
// holds up to three 16-float columns and needs more than 64 registers.
__host__ __device__ constexpr int jay_max_threads(int b) { return b <= 4 ? 1024 : 512; }
// Right-hand-side columns a lane solves: ceil((2b + 1) / lanes).
__host__ __device__ constexpr int jay_cols(int b) {
  return (2 * b + 1 + jay_lanes(b) - 1) / jay_lanes(b);
}
// Floats between two b x b blocks of an operand, and of a group's factor slot.
__host__ __device__ constexpr int jay_stride(int b) { return b * b + 1; }

int jay_threads(int P, int b) {
  long t = (long)((P + 1) / 2) * jay_lanes(b);
  t = (t + 31) / 32 * 32;
  return t > jay_max_threads(b) ? jay_max_threads(b) : (int)t;
}

// Floats of the operands D, C, Z1, Z2 (blocks), r, zr (vectors), and x in
// shared memory.
size_t jay_operand_floats(int P, int b, bool with_x) {
  return (size_t)P * (4 * jay_stride(b) + (with_x ? 3 : 2) * b);
}

// Floats of the groups' factor slots.
size_t jay_slot_floats(int P, int b) {
  return (size_t)(jay_threads(P, b) / jay_lanes(b)) * jay_stride(b);
}

bool jay_in_shared(int P, int b) {
  return (jay_operand_floats(P, b, true) + jay_slot_floats(P, b)) * sizeof(float) <= kSmemBytes;
}

struct JayArgs {
  const float *diag, *off, *rhs, *shift;
  float *x, *scratch;  // scratch: null when the operands live in shared memory
  int P, mode;         // mode: 0 no shift, 1 always, 2 on the fly
  float reg_tol;
};

// Row i of the block W (entries k <= i), the shift sh_i on its diagonal
// when sh is given.
template <int B>
__device__ __forceinline__ void load_row(float (&a)[B], const float* W, const float* sh, int i) {
#pragma unroll
  for (int k = 0; k < B; ++k) {
    float v = i < B && k <= i ? W[i * B + k] : 0.f;
    if (sh != nullptr && k == i) v = v + sh[k];
    a[k] = v;
  }
}

// Right-looking Cholesky of the group's block, lane i holding row i in a
// (the lower entries); on return a holds row i of the factor. Returns
// whether every raw pivot a_kk rsqrt(max(a_kk, 1e-12)) is > tol (false on
// NaN); every lane returns the same.
template <int B>
__device__ __forceinline__ bool chol_rows(float (&a)[B], unsigned mask, int i, float tol) {
  constexpr int GL = jay_lanes(B);
  bool ok = true;
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const float akk = __shfl_sync(mask, a[k], k, GL);
    const float d = fmaxf(akk, kJayFloor);
    const float dinv = rsqrtf(d);
    if (!(__fmul_rn(akk, dinv) > tol)) ok = false;
    const float lik = __fmul_rn(i == k ? d : a[k], dinv);
    if (i >= k) a[k] = lik;
#pragma unroll
    for (int c = k + 1; c < B; ++c) {
      const float lck = __shfl_sync(mask, lik, c, GL);
      if (i >= c) a[c] = __fmaf_rn(-lik, lck, a[c]);
    }
  }
  return ok;
}

// The factor of block W (shift sh [B] or null) by the shift rule, into
// the group's slot Lg [B, B] (lower entries).
template <int B>
__device__ __forceinline__ void factor_block(float* Lg, const float* W, const float* sh, int mode,
                                             float tol, unsigned mask, int i) {
  float a[B];
  load_row<B>(a, W, mode == 1 ? sh : nullptr, i);
  const bool ok = chol_rows<B>(a, mask, i, tol);
  if (mode == 2 && !ok) {
    load_row<B>(a, W, sh, i);
    chol_rows<B>(a, mask, i, tol);
  }
#pragma unroll
  for (int k = 0; k < B; ++k)
    if (i < B && k <= i) Lg[i * B + k] = a[k];
  __syncwarp(mask);
}

// (L L') v = v for the lane's NC columns, L the group's factor: forward
// v_i = (v_i - sum_{m<i} L_im v_m) / L_ii, then back v_i = (v_i -
// sum_{m>i} L_mi v_m) / L_ii, each sum over m ascending.
template <int B, int NC>
__device__ __forceinline__ void solve_cols(float (&v)[NC][B], const float* Lg) {
#pragma unroll
  for (int r = 0; r < B; ++r) {
    float acc[NC];
#pragma unroll
    for (int t = 0; t < NC; ++t) acc[t] = v[t][r];
#pragma unroll
    for (int m = 0; m < r; ++m) {
      const float l = Lg[r * B + m];
#pragma unroll
      for (int t = 0; t < NC; ++t) acc[t] = __fmaf_rn(-l, v[t][m], acc[t]);
    }
    const float d = Lg[r * B + r];
#pragma unroll
    for (int t = 0; t < NC; ++t) v[t][r] = tq::quotient(acc[t], d);
  }
#pragma unroll
  for (int r = B - 1; r >= 0; --r) {
    float acc[NC];
#pragma unroll
    for (int t = 0; t < NC; ++t) acc[t] = v[t][r];
#pragma unroll
    for (int m = r + 1; m < B; ++m) {
      const float l = Lg[m * B + r];
#pragma unroll
      for (int t = 0; t < NC; ++t) acc[t] = __fmaf_rn(-l, v[t][m], acc[t]);
    }
    const float d = Lg[r * B + r];
#pragma unroll
    for (int t = 0; t < NC; ++t) v[t][r] = tq::quotient(acc[t], d);
  }
}

// The operands, at their stride; X is x itself when it is not in shared
// memory.
struct JayOps {
  float *D, *C, *Z1, *Z2, *r, *zr, *X;
};

// Odd block p of level h: its factor, then its 2B + 1 columns, column c of
// lane i's share being i + t GL: c < B column c of C_p (-> Z1), c < 2B row
// c - B of C_{p+h} (-> Z2; zeros past P), c = 2B r_p (-> zr).
template <int B>
__device__ __forceinline__ void odd_block(const JayArgs& a, const JayOps& o, int p, int h,
                                          float* Lg, unsigned mask, int i) {
  constexpr int GL = jay_lanes(B), NC = jay_cols(B), BS = jay_stride(B);
  factor_block<B>(Lg, o.D + (size_t)p * BS, a.shift == nullptr ? nullptr : a.shift + (size_t)p * B,
                  a.mode, a.reg_tol, mask, i);
  const bool right = p + h < a.P;
  float v[NC][B];
  float* dst[NC];
  int dstride[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    const int c = i + t * GL;
    const float* src = nullptr;
    int sstride = 1;
    dst[t] = nullptr;
    dstride[t] = 1;
    if (c < B) {
      src = o.C + (size_t)p * BS + c;
      sstride = B;
      dst[t] = o.Z1 + (size_t)p * BS + c;
      dstride[t] = B;
    } else if (c < 2 * B) {
      if (right) src = o.C + (size_t)(p + h) * BS + (c - B) * B;
      dst[t] = o.Z2 + (size_t)p * BS + (c - B);
      dstride[t] = B;
    } else if (c == 2 * B) {
      src = o.r + (size_t)p * B;
      dst[t] = o.zr + (size_t)p * B;
    }
#pragma unroll
    for (int m = 0; m < B; ++m) v[t][m] = src != nullptr ? src[m * sstride] : 0.f;
  }
  solve_cols<B, NC>(v, Lg);
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    if (dst[t] != nullptr) {
#pragma unroll
      for (int m = 0; m < B; ++m) dst[t][m * dstride[t]] = v[t][m];
    }
  }
  __syncwarp(mask);  // the slot is the group's next block's
}

// Even block e of level h, lane i its row i: row i of the new D_e, r_e and
// C_e read only row i of the old C_e, which the lane holds in registers.
template <int B>
__device__ __forceinline__ void even_block(const JayOps& o, int P, int e, int h, int i) {
  constexpr int BS = jay_stride(B);
  if (i >= B) return;
  const bool left = e >= h, right = e + h < P;
  const size_t l = left ? e - h : e, rt = right ? e + h : e;
  float* Ce = o.C + (size_t)e * BS + i * B;
  float* De = o.D + (size_t)e * BS + i * B;
  const float* Z2l = o.Z2 + l * BS;
  const float* Z1l = o.Z1 + l * BS;
  const float* zrl = o.zr + l * B;
  const float* Cr = o.C + rt * BS + i;
  const float* Z1r = o.Z1 + rt * BS;
  const float* zrr = o.zr + rt * B;
  float ce[B], cr[B];
#pragma unroll
  for (int k = 0; k < B; ++k) {
    ce[k] = Ce[k];
    cr[k] = Cr[k * B];
  }
#pragma unroll
  for (int j = 0; j < B; ++j) {
    float t1 = 0.f, c1 = 0.f, t2 = 0.f;
    if (left) {
#pragma unroll
      for (int k = 0; k < B; ++k) {
        t1 = __fmaf_rn(ce[k], Z2l[k * B + j], t1);
        c1 = __fmaf_rn(ce[k], Z1l[k * B + j], c1);
      }
    }
    if (right) {
#pragma unroll
      for (int k = 0; k < B; ++k) t2 = __fmaf_rn(cr[k], Z1r[k * B + j], t2);
    }
    De[j] = __fsub_rn(__fsub_rn(De[j], t1), t2);
    Ce[j] = -c1;  // row i of C_e is in ce
  }
  float rv1 = 0.f, rv2 = 0.f;
  if (left) {
#pragma unroll
    for (int k = 0; k < B; ++k) rv1 = __fmaf_rn(ce[k], zrl[k], rv1);
  }
  if (right) {
#pragma unroll
    for (int k = 0; k < B; ++k) rv2 = __fmaf_rn(cr[k], zrr[k], rv2);
  }
  float* re = o.r + (size_t)e * B + i;
  *re = __fsub_rn(__fsub_rn(*re, rv1), rv2);
}

// Back substitution of odd block q of level h, lane i its row i.
template <int B>
__device__ __forceinline__ void back_block(const JayOps& o, int P, int q, int h, int i) {
  constexpr int BS = jay_stride(B);
  if (i >= B) return;
  const bool right = q + h < P;
  const float* xl = o.X + (size_t)(q - h) * B;
  const float* xr = o.X + (size_t)(right ? q + h : q) * B;
  const float* Z1 = o.Z1 + (size_t)q * BS + i * B;
  const float* Z2 = o.Z2 + (size_t)q * BS + i * B;
  float a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int k = 0; k < B; ++k) a1 = __fmaf_rn(Z1[k], xl[k], a1);
  if (right) {
#pragma unroll
    for (int k = 0; k < B; ++k) a2 = __fmaf_rn(Z2[k], xr[k], a2);
  }
  o.X[(size_t)q * B + i] = __fsub_rn(__fsub_rn(o.zr[(size_t)q * B + i], a1), a2);
}

template <int B>
__global__ void __launch_bounds__(jay_max_threads(B)) jay_cr_kernel(const JayArgs a) {
  constexpr int GL = jay_lanes(B), BS = jay_stride(B), bb = B * B;
  extern __shared__ float smem[];
  const int P = a.P, tid = threadIdx.x, nt = blockDim.x;
  const int q = tid / GL, nq = nt / GL, i = tid % GL;
  const unsigned mask = ((1u << GL) - 1u) << (tid % 32 / GL * GL);
  const bool shared_ops = a.scratch == nullptr;
  JayOps o;
  o.D = shared_ops ? smem : a.scratch;
  o.C = o.D + (size_t)P * BS;
  o.Z1 = o.C + (size_t)P * BS;
  o.Z2 = o.Z1 + (size_t)P * BS;
  o.r = o.Z2 + (size_t)P * BS;
  o.zr = o.r + (size_t)P * B;
  o.X = shared_ops ? o.zr + (size_t)P * B : a.x;
  float* Lg = (shared_ops ? o.X + (size_t)P * B : smem) + q * BS;
  for (int k = tid; k < P * bb; k += nt) {
    const int p = k / bb, e = k % bb;
    o.D[(size_t)p * BS + e] = a.diag[k];
    o.C[(size_t)p * BS + e] = p == 0 ? 0.f : a.off[k - bb];
  }
  for (int k = tid; k < P * B; k += nt) o.r[k] = a.rhs[k];
  __syncthreads();
  int h = 1;
  for (; h < P; h *= 2) {
    for (int p = h + 2 * h * q; p < P; p += 2 * h * nq) odd_block<B>(a, o, p, h, Lg, mask, i);
    __syncthreads();
    for (int e = 2 * h * q; e < P; e += 2 * h * nq) even_block<B>(o, P, e, h, i);
    __syncthreads();
  }
  // the root, block 0, on group 0
  if (q == 0) {
    factor_block<B>(Lg, o.D, a.shift, a.mode, a.reg_tol, mask, i);
    if (i == 0) {
      float v[1][B];
#pragma unroll
      for (int m = 0; m < B; ++m) v[0][m] = o.r[m];
      solve_cols<B, 1>(v, Lg);
#pragma unroll
      for (int m = 0; m < B; ++m) o.X[m] = v[0][m];
    }
  }
  __syncthreads();
  // back substitution, deepest level first
  for (h /= 2; h >= 1; h /= 2) {
    for (int k = h + 2 * h * q; k < P; k += 2 * h * nq) back_block<B>(o, P, k, h, i);
    __syncthreads();
  }
  if (shared_ops)
    for (int k = tid; k < P * B; k += nt) a.x[k] = o.X[k];
}

template <int B>
int launch(const JayArgs& a, cudaStream_t st) {
  const int threads = jay_threads(a.P, B);
  const size_t bytes = ((a.scratch == nullptr ? jay_operand_floats(a.P, B, true) : 0)
                        + jay_slot_floats(a.P, B)) * sizeof(float);
  static size_t opted = 0;  // the dynamic shared memory this kernel may take
  if (bytes > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        jay_cr_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted = bytes;
  }
  jay_cr_kernel<B><<<1, threads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int B>
int dispatch(const JayArgs& a, int b, cudaStream_t st) {
  if constexpr (B < kMaxB) {
    if (b != B) return dispatch<B + 1>(a, b, st);
  }
  return launch<B>(a, st);
}

}  // namespace

// Floats of global scratch a launch at (P, b) needs: 0 when the operands
// live in shared memory.
extern "C" long tq_jay_cr_scratch(int P, int b) {
  return jay_in_shared(P, b) ? 0 : (long)jay_operand_floats(P, b, false);
}

// diag, off, rhs, shift (may be null), x, scratch (tq_jay_cr_scratch floats,
// or null when that is 0), P, b (1 .. 16), reg_tol, stream
extern "C" int tq_jay_cr_solve(const float* diag, const float* off, const float* rhs,
                               const float* shift, float* x, float* scratch, int P, int b,
                               float reg_tol, void* stream) {
  if (P < 1 || b < 1 || b > kMaxB) return (int)cudaErrorInvalidValue;
  JayArgs a;
  a.diag = diag; a.off = off; a.rhs = rhs; a.shift = shift;
  a.x = x; a.scratch = scratch;
  a.P = P;
  a.mode = shift == nullptr ? 0 : (reg_tol >= 0.f ? 2 : 1);
  a.reg_tol = reg_tol;
  return dispatch<1>(a, b, (cudaStream_t)stream);
}
