// What the four RBF projection kernels share: the class-specialised forward
// (rbf_classed.cu) and its weight gradient (rbf_classed_dw.cu), the dense
// forward (rbf_edge.cu) and its weight gradient (rbf_edge_dw.cu).
//
// Operands, in every one of them: query rows Xq [Nq, 3*18] (x|y|z planes)
// with atom masks Mq [Nq, 18], key rows Xk [Nk, 3*18] with masks Mk [Nk, 18],
// and for each edge e its key row nbr[e]; the query row of edge e is e / K.
// On one device the keys are the queries (Xk == Xq); on the graph-parallel
// route the queries are a shard's rows and the keys the all-gathered
// structure, so nothing here assumes the two come from one array.
//
// The bins are those of the plain version (models/features.py::all_pair_rbf):
// 16 Gaussians, mu = 2..22 A, sigma = 1.25, of the distance between query
// atom qa and key atom na, exactly 0 where either atom is absent. The sum of
// a dense and a class-split projection then agree, and every kernel computes
// a bin alike, so a backward recomputes what its forward used.
//
// The bf16 trunk's classed projection takes the TPU kernels' bf16 bins
// instead (rbf_bin_damped, JAX rbf_classed.py:259-303): bin r of a pair is
// max(u_r, d_{R-1-r}), the damped two-sided geometric walk, whose missing
// factor e^{c r (R-1-r)} the weight rows carry (the fold scales).
#pragma once
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

constexpr int kA = 18;   // augmented atom slots
constexpr int kR = 16;   // RBF bins
constexpr int kTE = 32;  // edges per tile

// Gather the query and key rows of the tile's edges [e0, e0 + kTE) into
// shared memory: qx, nx [kTE][3*kA]; qm, nm [kTE][kA]; zeros past E.
__device__ __forceinline__ void load_edge_tile(
    const float* __restrict__ Xq, const float* __restrict__ Mq,
    const float* __restrict__ Xk, const float* __restrict__ Mk,
    const long long* __restrict__ nbr, int E, int K, int e0, float* qx,
    float* nx, float* qm, float* nm) {
  for (int idx = threadIdx.x; idx < kTE * 3 * kA; idx += blockDim.x) {
    const int e = idx / (3 * kA), c = idx % (3 * kA);
    const int ge = e0 + e;
    float q = 0.f, n = 0.f;
    if (ge < E) {
      q = Xq[(size_t)(ge / K) * 3 * kA + c];
      n = Xk[(size_t)nbr[ge] * 3 * kA + c];
    }
    qx[idx] = q;
    nx[idx] = n;
  }
  for (int idx = threadIdx.x; idx < kTE * kA; idx += blockDim.x) {
    const int e = idx / kA, c = idx % kA;
    const int ge = e0 + e;
    float q = 0.f, n = 0.f;
    if (ge < E) {
      q = Mq[(size_t)(ge / K) * kA + c];
      n = Mk[(size_t)nbr[ge] * kA + c];
    }
    qm[idx] = q;
    nm[idx] = n;
  }
}

__device__ __forceinline__ float bin_mu(int r) {
  return (float)(2.0 + r * (20.0 / (kR - 1)));
}

// The distance between query atom qa of row xq and key atom na of row xn
// (x|y|z planes of kA slots each), as the exact bins take it.
__device__ __forceinline__ float pair_distance(const float* xq,
                                               const float* xn, int qa,
                                               int na) {
  const float dx = xq[qa] - xn[na];
  const float dy = xq[kA + qa] - xn[kA + na];
  const float dz = xq[2 * kA + qa] - xn[2 * kA + na];
  return sqrtf(dx * dx + dy * dy + dz * dz + 1e-6f);
}

// The exact bin of centre mu at distance D.
__device__ __forceinline__ float gauss_bin(float D, float mu) {
  const float z = (D - mu) / 1.25f;
  return expf(-z * z);
}

// Bin r (centre mu) of the distance between query atom qa and key atom na of
// tile edge e; 0 where either atom is absent.
__device__ __forceinline__ float rbf_bin(const float* qx, const float* nx,
                                         const float* qm, const float* nm,
                                         int e, int qa, int na, float mu) {
  if (qm[e * kA + qa] == 0.f || nm[e * kA + na] == 0.f) return 0.f;
  return gauss_bin(pair_distance(qx + e * 3 * kA, nx + e * 3 * kA, qa, na), mu);
}

// fp32 constants of the recursion, as the JAX package rounds them
// (sigma = 1.25, step = 20/15, c = step^2 / sigma^2, R = 16).
constexpr float kInvS2 = 0x1.47ae14p-1f;     // 1 / sigma^2
constexpr float kGen = 0x1.b4e81cp+0f;       // 2 step / sigma^2
constexpr float kDamp = 0x1.4caedep-25f;     // e^{-(R-1)c}
constexpr float kUndamp = 0x1.89fc0ep+24f;   // e^{(R-1)c}
constexpr float kTiny = 0x1.05563cp-126f;    // seeds below are flushed to 0
constexpr float kDistCap = 50.0f;

// The damped walk of the pair (query atom qa of row xq, key atom na of row
// xn): the fp32 operations of the JAX package's _bins_recursive in its
// order, with the distance rounded step by step (no contraction into FMAs),
// as the plain version computes them:
//   D = min(sqrt(dx^2 + dy^2 + dz^2 + 1e-6), 50), t0 = D - 2, t1 = D - 22,
//   f_lo = exp(-(t0 t0) / s^2), f_hi = exp(-(t1 t1) / s^2) (< kTiny: 0),
//   g = exp(kGen t0), up = g kDamp, down = kUndamp / g.
// Bin r is max(f_lo up^r, f_hi down^(R-1-r)), each power taken by repeated
// rounded multiplication. 3 exps and a division per pair.
struct DampedWalk {
  float f_lo, f_hi, up, down;
};

__device__ __forceinline__ DampedWalk damped_walk(const float* xq,
                                                  const float* xn, int qa,
                                                  int na) {
  const float dx = __fsub_rn(xq[qa], xn[na]);
  const float dy = __fsub_rn(xq[kA + qa], xn[kA + na]);
  const float dz = __fsub_rn(xq[2 * kA + qa], xn[2 * kA + na]);
  const float d2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                       __fmul_rn(dz, dz)),
                             1e-6f);
  const float D = fminf(sqrtf(d2), kDistCap);
  const float t0 = __fsub_rn(D, 2.0f), t1 = __fsub_rn(D, 22.0f);
  DampedWalk w;
  w.f_lo = expf(__fmul_rn(-__fmul_rn(t0, t0), kInvS2));
  w.f_hi = expf(__fmul_rn(-__fmul_rn(t1, t1), kInvS2));
  if (w.f_lo < kTiny) w.f_lo = 0.f;
  if (w.f_hi < kTiny) w.f_hi = 0.f;
  const float g = expf(__fmul_rn(kGen, t0));
  w.up = __fmul_rn(g, kDamp);
  w.down = __fdiv_rn(kUndamp, g);
  return w;
}

// Damped bin r of the pair (query atom qa, key atom na) of tile edge e, 0
// where either atom is absent; R - 1 multiplications after the walk.
__device__ __forceinline__ float rbf_bin_damped(const float* qx,
                                                const float* nx,
                                                const float* qm,
                                                const float* nm, int e,
                                                int qa, int na, int r) {
  if (qm[e * kA + qa] == 0.f || nm[e * kA + na] == 0.f) return 0.f;
  const DampedWalk w = damped_walk(qx + e * 3 * kA, nx + e * 3 * kA, qa, na);
  float up = w.f_lo, down = w.f_hi;
  for (int i = 0; i < r; ++i) up = __fmul_rn(up, w.up);
  for (int i = 0; i < kR - 1 - r; ++i) down = __fmul_rn(down, w.down);
  return fmaxf(up, down);
}

// All 16 bins of the pair (query atom qa of row xq, key atom na of row xn),
// the distance or walk taken once: fp32 the exact Gaussians of rbf_bin,
// bf16 (kLow) the damped bins of rbf_bin_damped rounded to bf16. The caller
// handles absent atoms.
template <bool kLow>
__device__ __forceinline__ void pair_bins(const float* xq, const float* xn,
                                          int qa, int na, float (&b)[kR]) {
  if constexpr (!kLow) {
    const float D = pair_distance(xq, xn, qa, na);
#pragma unroll
    for (int r = 0; r < kR; ++r) b[r] = gauss_bin(D, bin_mu(r));
  } else {
    const DampedWalk w = damped_walk(xq, xn, qa, na);
    float up = w.f_lo, down[kR];
    down[0] = w.f_hi;
#pragma unroll
    for (int m = 1; m < kR; ++m) down[m] = __fmul_rn(down[m - 1], w.down);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      b[r] = rnd<bf16>(fmaxf(up, down[kR - 1 - r]));
      up = __fmul_rn(up, w.up);
    }
  }
}

// The weight-gradient tile product: acc[i][c] += sum_e bins[ty + 8i][e] *
// gs[e][tx + 32c] over the tile's kTE edges, for a block of 256 threads
// (8 x 32) that owns 8 * NI weight rows; bins [8*NI][kTE], gs [kTE][H].
template <int H, int NI>
__device__ __forceinline__ void dw_tile_product(const float* bins,
                                                const float* gs,
                                                float (&acc)[NI][H / 32]) {
  constexpr int CPT = H / 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int e4 = 0; e4 < kTE; e4 += 4) {
    float4 bv[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      bv[i] = *reinterpret_cast<const float4*>(bins + (ty + 8 * i) * kTE + e4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float gv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) gv[c] = gs[(e4 + j) * H + tx + 32 * c];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float b = j == 0 ? bv[i].x : j == 1 ? bv[i].y : j == 2 ? bv[i].z : bv[i].w;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(b, gv[c], acc[i][c]);
      }
    }
  }
}

// dW[rowmap ? rowmap[row] : row][h] = sum_s part[s][row][h], s in order
// (deterministic: no atomics anywhere in a weight gradient).
__global__ void dw_reduce(const float* __restrict__ part, int splits,
                          const long long* __restrict__ rowmap, int rows,
                          int H, float* __restrict__ dW) {
  const size_t n = (size_t)rows * H;
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int c = 0; c < splits; ++c) s += part[c * n + j];
  const size_t row = j / H, h = j % H;
  dW[(size_t)(rowmap ? rowmap[row] : (long long)row) * H + h] = s;
}

}  // namespace
