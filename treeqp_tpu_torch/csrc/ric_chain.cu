// The multistage IPM's chain Riccati sweeps: factorize, backward
// right-hand side and forward, each a group of lanes per scenario chain.
//
// Replaces the Pallas kernels ric_chain_factor, ric_chain_bwd and
// ric_chain_fwd of treeqp_tpu/ops/riccati_kernels.py (reached through
// ipm_multistage.ipm_ms_solve on its f32-factored iterations with
// chain_backend="pallas"). Tensors are [S, L, ...], j = 0 the chain node
// next to the crown. Per stage the arithmetic is tq_riccati.cuh's:
//   factor, j = L-1 .. 0: M = hbar_j + W (hbar diagonal [nz] or dense
//     [nz, nz]: general C/D rows), the stage factors P, Lu, K, Mxu, and
//     W = AB_j' P AB_j; W0 = W after j = 0;
//   rhs, j = L-1 .. 0: m = rg_j + w, p, k and w = AB_j'(P rb_j + p);
//     w0 = w after j = 0;
//   forward, j = 0 .. L-1: from z_root (the crown's step at each chain
//     root's parent), dx = AB_j z + rb_j, du = K dx + k, dlam = P dx + p.
//
// What bounds them on the card: latency. A chain is L dependent stages of
// ~(nu^3/3 + 2 nu^2 nx + 2 nx^2 nu + 2 nx^2 nz + 2 nx nz^2) flops (~2.7k at
// nx = 8, nz = 9); a factor launch moves each stage's AB_j and hbar_j once
// and writes its factors once (~1.2 MB at S = 256, L = 16, nx = 8, nz = 9).
//
// ric_chain_factor. The thread-per-chain kernel this replaces ran ~1300
// dependent FMAs a stage in one thread with W and T in local memory (S = 256
// chains on two SMs, 3.2 ms). Design:
// - A group of G lanes takes a chain: G = 8 for nz <= 8, 16 for nz <= 16,
//   32 for nz <= 32 (tq::ric_lanes), 32 / G chains a warp and one warp a
//   block. One instantiation per nz = 2 .. 16, nz a template parameter,
//   and one for 16 < nz <= 32 (tq_riccati.cuh's kRicWide, nz at run time,
//   built by ric_chain_wide.cu); nx is a run-time value.
// - Lane i owns row i of the stage's M = hbar_j + W in registers; the
//   stage is tq_riccati.cuh's ric_stage_factor_lanes (the crown's
//   crown_ric_factor runs it too): Lu right-looking by shuffles, K by
//   columns through Lu in shared memory, T, P, P AB and W = AB' (P AB) row
//   by lane: ~150 dependent FMAs a lane a stage at nz = 9.
// - AB_j and hbar_j stream through a ring of kStages stages of shared
//   memory per chain with cp.async, up to kStages - 1 stages ahead.
// - Each lane writes its rows of P_j, Lu_j, Mxu_j and its column of K_j
//   once; W0 row i by lane i.
// Every sum runs in the per-thread stage's loop order, each product folded
// in by one FMA as nvcc contracted the per-thread body (written out as
// __fmaf_rn), and the sums and scalings that stand alone are rounded on
// their own (__fadd_rn, __fmul_rn), with rsqrtf and true divisions: the
// results are the thread-per-chain kernel's bit for bit, whatever the
// compiler contracts. No tensor cores: a stage is a dependent factorization
// and product chain of nz <= 32 blocks; wgmma needs 64-row tiles.
//
// ric_chain_bwd. The thread-per-chain kernel this replaces ran ~150
// dependent FMAs a stage at nz = 9 in one thread, its operands read from
// global memory and v, y in local memory (S = 256 chains on two SMs, 0.38
// ms). Design:
// - The layout of ric_chain_factor: G = tq::ric_lanes(nz) lanes a chain,
//   32 / G chains a warp, one warp a block, the same instantiations.
// - Each stage's [P_j | Lu_j | Mxu_j | AB_j | rg_j | rb_j] (164 floats at
//   nx = 8, nz = 9) streams through a ring of kBwdStages stages of shared
//   memory per chain with cp.async, up to kBwdStages - 1 stages ahead.
// - Lane i owns row i of m = rg_j + w; the stage is tq_riccati.cuh's
//   ric_stage_bwd_lanes: nu rounds each way of a division and a shuffle
//   for k, p by lane x, P rb_j (which does not depend on w) summed before
//   the chain reaches it, and w by lane i from nx shuffles of v. About a
//   dozen dependent rounds a stage at nz = 9, nu = 1.
// - Lane x writes p_j row x, lane nx + c writes k_j row c, lane i writes
//   w0 row i.
// Bit for bit the thread-per-chain kernel.
// No tensor cores: a stage is a dependent solve and product chain of
// nz <= 32 rows.
//
// ric_chain_fwd. The thread-per-chain kernel this replaces ran ~150
// dependent FMAs a stage at nz = 9 in one thread, P_j, K_j and AB_j read
// from global memory and dx in local memory (S = 256 chains on two SMs,
// 0.26 ms in a CUDA graph). Design:
// - The layout of ric_chain_bwd: G = tq::ric_lanes(nz) lanes a chain,
//   32 / G chains a warp, one warp a block, the same instantiations.
// - Each stage's [P_j | K_j | AB_j | rb_j | p_j | k_j] (161 floats at
//   nx = 8, nz = 9) streams through a ring of kBwdStages stages of shared
//   memory per chain with cp.async, up to kBwdStages - 1 stages ahead.
// - Lane i holds row i of the parent's step zp; the stage is
//   tq_riccati.cuh's ric_stage_fwd_lanes: nz independent shuffles of zp,
//   dx_x by lane x, nx shuffles of dx and one fold giving du by lanes
//   nx .. nz-1 and dlam by lanes x; about nz + nx dependent FMA and
//   shuffle rounds a stage, no division.
// - Lane i writes dz_j row i and keeps it as the next stage's zp; lane x
//   writes dl_j row x.
// Bit for bit the thread-per-chain kernel.
// No tensor cores: a stage is a dependent product chain of nz <= 32 rows.

#include "tq_lanes.cuh"
#include "tq_riccati.cuh"

namespace {

// ---------------------------------------------------------------------------
// ric_chain_factor: a group of lanes per chain

constexpr int kStages = 3;

// A stage of the ring: [AB_j (nx nz) | hbar_j (nz, or nz nz dense)], its
// stride rounded up to 4 floats.
__host__ __device__ inline int ric_stage_floats(int nx, int nz, int dense) {
  return (nx * nz + (dense ? nz * nz : nz) + 3) & ~3;
}

// A chain's shared memory: the ring, then five nz x nz work areas
// (M, Lu, K, T = Mxx + Mxu K, P AB).
__host__ __device__ inline int ric_chain_floats(int nz, int nx, int dense) {
  return kStages * ric_stage_floats(nx, nz, dense) + 5 * nz * nz;
}

template <int NZ>
__global__ void __launch_bounds__(32) ric_chain_factor_kernel(
    const float* __restrict__ hbar, const float* __restrict__ AB, float* __restrict__ P,
    float* __restrict__ Lu, float* __restrict__ K, float* __restrict__ Mxu,
    float* __restrict__ W0, int S, int L, int nx, int nz_, int dense, float reg) {
  constexpr int G = tq::ric_lanes(NZ);
  const int nz = tq::ric_nz<NZ>(nz_);
  extern __shared__ __align__(16) float smem[];
  const int nu = nz - nx;
  const int i = threadIdx.x % G, q = threadIdx.x / G;
  const int s = blockIdx.x * (32 / G) + q;
  const bool live = s < S;
  const size_t sl = live ? s : S - 1;  // a group past the last chain stores nothing
  const int stf = ric_stage_floats(nx, nz, dense);
  const int hbf = dense ? nz * nz : nz;
  float* ring = smem + (size_t)q * ric_chain_floats(nz, nx, dense);
  float* work = ring + kStages * stf;  // the stage's five work areas
  const float* ABc = AB + sl * L * nx * nz;
  const float* hbc = hbar + sl * L * hbf;

  // step t works on node j = L-1-t
  auto fetch = [&](int t) {
    if (t < L) {
      const int j = L - 1 - t;
      float* st = ring + (t % kStages) * stf;
      for (int e = i; e < nx * nz; e += G) tq::cp_async4(st + e, ABc + (size_t)j * nx * nz + e);
      for (int e = i; e < hbf; e += G) tq::cp_async4(st + nx * nz + e, hbc + (size_t)j * hbf + e);
    }
    tq::cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) fetch(t);

  float w[NZ];  // row i of W, the term of the stage below
#pragma unroll
  for (int c = 0; c < NZ; ++c) w[c] = 0.f;
  const bool row = i < nz;
  for (int t = 0; t < L; ++t) {
    const size_t sj = sl * L + (L - 1 - t);
    fetch(t + kStages - 1);
    tq::cp_async_wait<kStages - 1>();
    __syncwarp();
    const float* ABj = ring + (t % kStages) * stf;
    const float* hb = ABj + nx * nz;

    // M row i = W row i + hbar_j row i
    float a[NZ];
#pragma unroll
    for (int c = 0; c < NZ; ++c) {
      if (!row || c >= nz) a[c] = 0.f;
      else if (dense) a[c] = __fadd_rn(w[c], hb[i * nz + c]);
      else a[c] = c == i ? __fadd_rn(w[c], hb[i]) : w[c];
    }
    tq::ric_stage_factor_lanes<NZ, G>(a, ABj, nx, nz, i, reg, work, live, P + sj * nx * nx,
                                      Lu + sj * nu * nu, K + sj * nu * nx, Mxu + sj * nx * nu,
                                      w);
    __syncwarp();  // the stage and the work areas are read: refill
  }
  tq::cp_async_wait<0>();
  if (live && row) {
#pragma unroll
    for (int c = 0; c < NZ; ++c)
      if (c < nz) W0[sl * nz * nz + i * nz + c] = w[c];
  }
}

template <int NZ>
int launch_factor(const float* hbar, const float* AB, float* P, float* Lu, float* K,
                  float* Mxu, float* W0, int S, int L, int nx, int nz, int dense, float reg,
                  cudaStream_t st) {
  static size_t opted = tq::kDefaultSmem;  // only the wide rings pass it
  constexpr int chains = 32 / tq::ric_lanes(NZ);
  const size_t bytes = (size_t)chains * ric_chain_floats(nz, nx, dense) * sizeof(float);
  const cudaError_t e = tq::opt_in(ric_chain_factor_kernel<NZ>, bytes, opted);
  if (e != cudaSuccess) return (int)e;
  ric_chain_factor_kernel<NZ><<<(S + chains - 1) / chains, 32, bytes, st>>>(
      hbar, AB, P, Lu, K, Mxu, W0, S, L, nx, nz, dense, reg);
  return (int)cudaGetLastError();
}

// The operand lists of the sweeps, passed by value (the host array of
// device pointers is copied into the launch's parameters).
struct Ops9 {
  const void* p[9];
};

// ---------------------------------------------------------------------------
// ric_chain_bwd: a group of lanes per chain

constexpr int kBwdStages = 8;

// A stage of the ring: [P_j (nx nx) | Lu_j (nu nu) | Mxu_j (nx nu) | AB_j
// (nx nz) | rg_j (nz) | rb_j (nx)], its stride rounded up to 4 floats.
struct BwdStage {
  int P, Lu, Mxu, AB, rg, rb, floats;
  __host__ __device__ BwdStage(int nx, int nz) {
    const int nu = nz - nx;
    P = 0;
    Lu = P + nx * nx;
    Mxu = Lu + nu * nu;
    AB = Mxu + nx * nu;
    rg = AB + nx * nz;
    rb = rg + nz;
    floats = (rb + nx + 3) & ~3;
  }
};

// operands: P, Lu, Mxu, AB, rg, rb, p, k, w0
template <int NZ>
__global__ void __launch_bounds__(32) ric_chain_bwd_kernel(Ops9 ops, int S, int L, int nx,
                                                           int nz_) {
  constexpr int G = tq::ric_lanes(NZ);
  const int nz = tq::ric_nz<NZ>(nz_);
  extern __shared__ __align__(16) float smem[];
  const float* P = static_cast<const float*>(ops.p[0]);
  const float* Lu = static_cast<const float*>(ops.p[1]);
  const float* Mxu = static_cast<const float*>(ops.p[2]);
  const float* AB = static_cast<const float*>(ops.p[3]);
  const float* rg = static_cast<const float*>(ops.p[4]);
  const float* rb = static_cast<const float*>(ops.p[5]);
  float* p = static_cast<float*>(const_cast<void*>(ops.p[6]));
  float* k = static_cast<float*>(const_cast<void*>(ops.p[7]));
  float* w0 = static_cast<float*>(const_cast<void*>(ops.p[8]));
  const int nu = nz - nx;
  const int i = threadIdx.x % G, q = threadIdx.x / G;
  const int s = blockIdx.x * (32 / G) + q;
  const bool live = s < S;
  const size_t sl = live ? s : S - 1;  // a group past the last chain stores nothing
  const BwdStage o(nx, nz);
  float* ring = smem + (size_t)q * kBwdStages * o.floats;

  // step t works on node j = L-1-t
  auto fetch = [&](int t) {
    if (t < L) {
      const size_t sj = sl * L + (L - 1 - t);
      float* st = ring + (t % kBwdStages) * o.floats;
      tq::copy_async(st + o.P, P + sj * nx * nx, nx * nx, i, G);
      tq::copy_async(st + o.Lu, Lu + sj * nu * nu, nu * nu, i, G);
      tq::copy_async(st + o.Mxu, Mxu + sj * nx * nu, nx * nu, i, G);
      tq::copy_async(st + o.AB, AB + sj * nx * nz, nx * nz, i, G);
      tq::copy_async(st + o.rg, rg + sj * nz, nz, i, G);
      tq::copy_async(st + o.rb, rb + sj * nx, nx, i, G);
    }
    tq::cp_async_commit();
  };
  for (int t = 0; t < kBwdStages - 1; ++t) fetch(t);

  float w = 0.f;  // row i of w, the term of the stage below
  for (int t = 0; t < L; ++t) {
    const size_t sj = sl * L + (L - 1 - t);
    fetch(t + kBwdStages - 1);
    tq::cp_async_wait<kBwdStages - 1>();
    __syncwarp();
    const float* st = ring + (t % kBwdStages) * o.floats;
    const float m = i < nz ? __fadd_rn(st[o.rg + i], w) : 0.f;
    float pi = 0.f, ki = 0.f;
    w = tq::ric_stage_bwd_lanes<NZ, G>(m, st + o.P, st + o.Lu, st + o.Mxu, st + o.AB,
                                       st + o.rb, nx, nz, i, pi, ki);
    if (live) {
      if (i < nx) p[sj * nx + i] = pi;
      else if (i < nz) k[sj * nu + i - nx] = ki;
    }
    __syncwarp();  // the stage is read: refill it
  }
  tq::cp_async_wait<0>();
  if (live && i < nz) w0[sl * nz + i] = w;
}

template <int NZ>
int launch_bwd(Ops9 ops, int S, int L, int nx, int nz, cudaStream_t st) {
  static size_t opted = tq::kDefaultSmem;  // only the wide rings pass it
  constexpr int chains = 32 / tq::ric_lanes(NZ);
  const size_t bytes = (size_t)chains * kBwdStages * BwdStage(nx, nz).floats * sizeof(float);
  const cudaError_t e = tq::opt_in(ric_chain_bwd_kernel<NZ>, bytes, opted);
  if (e != cudaSuccess) return (int)e;
  ric_chain_bwd_kernel<NZ><<<(S + chains - 1) / chains, 32, bytes, st>>>(ops, S, L, nx, nz);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ric_chain_fwd: a group of lanes per chain

// A stage of the ring: [P_j (nx nx) | K_j (nu nx) | AB_j (nx nz) | rb_j (nx)
// | p_j (nx) | k_j (nu)], its stride rounded up to 4 floats.
struct FwdStage {
  int P, K, AB, rb, p, k, floats;
  __host__ __device__ FwdStage(int nx, int nz) {
    const int nu = nz - nx;
    P = 0;
    K = P + nx * nx;
    AB = K + nu * nx;
    rb = AB + nx * nz;
    p = rb + nx;
    k = p + nx;
    floats = (k + nu + 3) & ~3;
  }
};

// operands: P, K, AB, rb, p, k, z_root, dz, dl
template <int NZ>
__global__ void __launch_bounds__(32) ric_chain_fwd_kernel(Ops9 ops, int S, int L, int nx,
                                                           int nz_) {
  constexpr int G = tq::ric_lanes(NZ);
  const int nz = tq::ric_nz<NZ>(nz_);
  extern __shared__ __align__(16) float smem[];
  const float* P = static_cast<const float*>(ops.p[0]);
  const float* K = static_cast<const float*>(ops.p[1]);
  const float* AB = static_cast<const float*>(ops.p[2]);
  const float* rb = static_cast<const float*>(ops.p[3]);
  const float* p = static_cast<const float*>(ops.p[4]);
  const float* k = static_cast<const float*>(ops.p[5]);
  const float* zroot = static_cast<const float*>(ops.p[6]);
  float* dz = static_cast<float*>(const_cast<void*>(ops.p[7]));
  float* dl = static_cast<float*>(const_cast<void*>(ops.p[8]));
  const int nu = nz - nx;
  const int i = threadIdx.x % G, q = threadIdx.x / G;
  const int s = blockIdx.x * (32 / G) + q;
  const bool live = s < S;
  const size_t sl = live ? s : S - 1;  // a group past the last chain stores nothing
  const FwdStage o(nx, nz);
  float* ring = smem + (size_t)q * kBwdStages * o.floats;

  // step t works on node j = t
  auto fetch = [&](int t) {
    if (t < L) {
      const size_t sj = sl * L + t;
      float* st = ring + (t % kBwdStages) * o.floats;
      tq::copy_async(st + o.P, P + sj * nx * nx, nx * nx, i, G);
      tq::copy_async(st + o.K, K + sj * nu * nx, nu * nx, i, G);
      tq::copy_async(st + o.AB, AB + sj * nx * nz, nx * nz, i, G);
      tq::copy_async(st + o.rb, rb + sj * nx, nx, i, G);
      tq::copy_async(st + o.p, p + sj * nx, nx, i, G);
      tq::copy_async(st + o.k, k + sj * nu, nu, i, G);
    }
    tq::cp_async_commit();
  };
  for (int t = 0; t < kBwdStages - 1; ++t) fetch(t);

  float z = i < nz ? zroot[sl * nz + i] : 0.f;  // row i of the parent's step
  for (int t = 0; t < L; ++t) {
    const size_t sj = sl * L + t;
    fetch(t + kBwdStages - 1);
    tq::cp_async_wait<kBwdStages - 1>();
    __syncwarp();
    const float* st = ring + (t % kBwdStages) * o.floats;
    float dli;
    z = tq::ric_stage_fwd_lanes<NZ, G>(z, st + o.P, st + o.K, st + o.AB, st + o.rb, st + o.p,
                                       st + o.k, nx, nz, i, dli);
    if (live) {
      if (i < nz) dz[sj * nz + i] = z;
      if (i < nx) dl[sj * nx + i] = dli;
    }
    __syncwarp();  // the stage is read: refill it
  }
  tq::cp_async_wait<0>();
}

template <int NZ>
int launch_fwd(Ops9 ops, int S, int L, int nx, int nz, cudaStream_t st) {
  static size_t opted = tq::kDefaultSmem;  // only the wide rings pass it
  constexpr int chains = 32 / tq::ric_lanes(NZ);
  const size_t bytes = (size_t)chains * kBwdStages * FwdStage(nx, nz).floats * sizeof(float);
  const cudaError_t e = tq::opt_in(ric_chain_fwd_kernel<NZ>, bytes, opted);
  if (e != cudaSuccess) return (int)e;
  ric_chain_fwd_kernel<NZ><<<(S + chains - 1) / chains, 32, bytes, st>>>(ops, S, L, nx, nz);
  return (int)cudaGetLastError();
}

Ops9 ops9(const void* const* p) {
  Ops9 o;
  for (int i = 0; i < 9; ++i) o.p[i] = p[i];
  return o;
}

}  // namespace

// The entry points. ric_chain_wide.cu builds this file again with
// TQ_RIC_WIDE defined, for the 32-lane instantiation alone (the _wide
// functions, which the entry points call for 16 < nz <= 32 once they have
// checked the shape): a translation unit of its own, which nvcc compiles
// beside this one's 15 narrow instantiations.
#ifdef TQ_RIC_WIDE

extern "C" int tq_ric_chain_factor_wide(const float* hbar, const float* AB, float* P,
                                        float* Lu, float* K, float* Mxu, float* W0, int S,
                                        int L, int nx, int nz, int dense, float reg,
                                        void* stream) {
  return launch_factor<tq::kRicWide>(hbar, AB, P, Lu, K, Mxu, W0, S, L, nx, nz, dense, reg,
                                     (cudaStream_t)stream);
}

extern "C" int tq_ric_chain_bwd_wide(const void* const* p, int S, int L, int nx, int nz,
                                     void* stream) {
  return launch_bwd<tq::kRicWide>(ops9(p), S, L, nx, nz, (cudaStream_t)stream);
}

extern "C" int tq_ric_chain_fwd_wide(const void* const* p, int S, int L, int nx, int nz,
                                     void* stream) {
  return launch_fwd<tq::kRicWide>(ops9(p), S, L, nx, nz, (cudaStream_t)stream);
}

#else

extern "C" int tq_ric_chain_factor_wide(const float*, const float*, float*, float*, float*,
                                        float*, float*, int, int, int, int, int, float,
                                        void*);
extern "C" int tq_ric_chain_bwd_wide(const void* const*, int, int, int, int, void*);
extern "C" int tq_ric_chain_fwd_wide(const void* const*, int, int, int, int, void*);

// hbar, AB, P, Lu, K, Mxu, W0, S, L, nx, nz, dense, reg, stream
extern "C" int tq_ric_chain_factor(const float* hbar, const float* AB, float* P,
                                   float* Lu, float* K, float* Mxu, float* W0, int S,
                                   int L, int nx, int nz, int dense, float reg,
                                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define TQ_RIC(NZ_) \
  case NZ_:         \
    return launch_factor<NZ_>(hbar, AB, P, Lu, K, Mxu, W0, S, L, nx, nz, dense, reg, st);
  TQ_RIC_SWITCH(nx, nz, TQ_RIC,
                tq_ric_chain_factor_wide(hbar, AB, P, Lu, K, Mxu, W0, S, L, nx, nz, dense,
                                         reg, stream))
#undef TQ_RIC
}

// pointers (P, Lu, Mxu, AB, rg, rb, p, k, w0), S, L, nx, nz, stream
extern "C" int tq_ric_chain_bwd(const void* const* p, int S, int L, int nx, int nz,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Ops9 ops = ops9(p);
#define TQ_RIC(NZ_) \
  case NZ_:         \
    return launch_bwd<NZ_>(ops, S, L, nx, nz, st);
  TQ_RIC_SWITCH(nx, nz, TQ_RIC, tq_ric_chain_bwd_wide(p, S, L, nx, nz, stream))
#undef TQ_RIC
}

// pointers (P, K, AB, rb, p, k, z_root, dz, dl), S, L, nx, nz, stream
extern "C" int tq_ric_chain_fwd(const void* const* p, int S, int L, int nx, int nz,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Ops9 ops = ops9(p);
#define TQ_RIC(NZ_) \
  case NZ_:         \
    return launch_fwd<NZ_>(ops, S, L, nx, nz, st);
  TQ_RIC_SWITCH(nx, nz, TQ_RIC, tq_ric_chain_fwd_wide(p, S, L, nx, nz, stream))
#undef TQ_RIC
}

#endif  // TQ_RIC_WIDE
