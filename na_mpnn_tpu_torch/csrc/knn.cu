// Masked exact k-nearest-neighbour graph for Hopper (sm_90a), in two entry
// points over one kernel:
//   knn_forward     replaces na_mpnn_tpu/ops/knn.py::knn_graph_pallas
//                   (knn.py:106): the L rows of a structure against each other;
//   knn_qk_forward  replaces knn_graph_pallas_qk (knn.py:54): Lq query rows
//                   against Lk key rows (the graph-parallel forward: a shard's
//                   rows against the all-gathered structure).
// Both TPU kernels (_kernel, knn.py:26) give each grid step a [256, Lk] tile
// of the distance matrix in VMEM and run K min/argmin sweeps over it.
//
// Semantics (those of the plain version, ops/knn.py::knn_graph_qk_plain):
//   D[i,j] = m_i*m_j * sqrt((dx*dx + dy*dy) + dz*dz + eps), j over the keys
//   invalid pairs get the row max added (they sort last)
//   the k smallest, ascending, ties to the lowest key index.
// E_idx must equal the plain version exactly, so the distance is built with
// the round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsqrt_rn) in the
// plain version's order: no multiply-add is contracted into an FMA.
//
// Non-finite values (coordinates that are inf or NaN, or whose squared
// differences overflow): a NaN distance is never selected and +inf is taken
// only after every finite value; when a row holds fewer than k finite
// values, each remaining slot gets (+inf, j*), j* the lowest key index whose
// value is not NaN (the key count when there is none). That is what the
// earlier one-block-per-row kernel wrote, which re-selected its lowest
// +inf entry once the finite ones ran out; the plain version's sort puts
// NaN last instead, so the two agree only on finite inputs.
//
// What bounds it on the card: operations (chip_smoke.py::_knn_bound, 14 per
// pair: the masked distance, the row max, about one comparison to select);
// the bytes are a few per row in and 12*k out. The earlier kernel ran one
// block per query row and k argmin passes over the row, each with two block
// barriers and a serial reduction over 8 warps: at L = 389 every thread held
// 1-2 values, so a pass was nearly all synchronisation.
//
// Design: one warp per query row, 16 rows of one structure per block. The
// block stages the structure's keys once in shared memory, 16 B per key
// (x, y, z, m) by cp.async (96 KB at Lk = 6144); above kTileKeys keys they
// stream through in tiles. Each lane scans keys lane, lane + 32, ..., four
// chunks of 32 in flight, starting from the chunk of the row's own index.
// Pass 1 scans the row for its max and each lane's T smallest values
// (T = 2, or S for k > 32), whose k-th smallest (a bitonic sort by shuffles)
// bounds the row's k-th from above: T0. Pass 2 selects exactly over (value,
// key index) pairs: the warp keeps a sorted list of the 32*S best (S per
// lane, element s*32 + lane); each lane drops a candidate that is not below
// the list's k-th or T0, and a ballot packs the rest into the warp's queue
// in shared memory; once 32 are queued the warp sorts them (bitonic, by
// shuffles) and merges them into the list (one min against the reversed
// queue, then a bitonic merge). There is no block barrier in either pass
// (but between key tiles), and lane l writes slots l, l + 32, ...
//
// Two facts let the scan skip work on masked pairs when the masks are 0 or
// 1 and the values finite (the fast form, checked per block and per row):
//   * a masked pair's adjusted value is exactly the row max, 0 + 1*D_max,
//     and a valid pair's is exactly its D, D + 0*D_max; so pass 1 needs
//     only the valid pairs' squared distances q, D_max = sqrt(max q), and a
//     masked key is a candidate of value D_max;
//   * a masked query row is all zeros, so it selects keys 0..k-1 at D = 0
//     (as does a row with no valid key), with no pass at all.
// Since sqrt_rn is monotone, pass 2 then filters on q against a bound that
// holds every q whose rounded root is at most the threshold, and takes the
// root only of the few that pass. Anything else (fractional or signed-zero
// masks, non-finite or huge coordinates, more than kTileKeys keys) takes the
// general form, which evaluates the plain formula for every pair.
// Per-lane slots: S = 1 for k <= 32 (every main path), else 4 (128 slots);
// a k above 128 selects in rounds of 128, each over the pairs above the
// previous round's last.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;             // query rows per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTileKeys = 8192;        // keys staged at once (128 KB)
constexpr int kQueue = 2;              // the warp's queue: kQueue*32 slots
constexpr int kUnroll = 4;             // chunks of 32 keys a lane has in flight
constexpr unsigned kAll = 0xffffffffu;
constexpr float kInf = __builtin_huge_valf();

struct Args {
  const float* Xq;
  const float* mq;
  const float* Xk;
  const float* mk;
  int Lq, Lk, k, blocks_per_b, fast_eps;
  float eps;
  float* D;
  long long* E;
};

__device__ __forceinline__ bool lex_less(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// Squared distance plus eps, in the plain version's order.
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 kp, float eps) {
  const float dx = __fsub_rn(qx, kp.x);
  const float dy = __fsub_rn(qy, kp.y);
  const float dz = __fsub_rn(qz, kp.z);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return __fadd_rn(s, eps);
}

// Every q >= 0 whose rounded root is at most x satisfies q <= qbound(x):
// sqrt(q) <= x + ulp/2 < nextafter(x), squared rounding up.
__device__ __forceinline__ float qbound(float x) {
  if (!(x < kInf)) return kInf;
  const float n = nextafterf(x, kInf);
  return __fmul_ru(n, n);
}

// Coordinates whose squared differences (and their sum with eps) stay
// finite, and masks that are +0 or 1 exactly.
__device__ __forceinline__ bool safe_coord(float c) {
  return fabsf(c) <= 1.152921504606847e18f;   // 2^60; false for NaN
}
__device__ __forceinline__ bool safe_mask(float m) {
  return __float_as_uint(m) == 0u || m == 1.0f;
}

// ---- warp sorting network over N chunks (element c*32 + lane) ----

template <int N>
__device__ __forceinline__ void cx_lane(float (&v)[N], int (&ix)[N], int c,
                                        int stride, bool up, int lane) {
  const float pv = __shfl_xor_sync(kAll, v[c], stride);
  const int pi = __shfl_xor_sync(kAll, ix[c], stride);
  const bool lower = (lane & stride) == 0;
  const bool take = (lower == up) ? lex_less(pv, pi, v[c], ix[c])
                                  : lex_less(v[c], ix[c], pv, pi);
  if (take) {
    v[c] = pv;
    ix[c] = pi;
  }
}

template <int N>
__device__ __forceinline__ void cx_reg(float (&v)[N], int (&ix)[N], int c,
                                       int c2, bool up) {
  const bool swap = up ? lex_less(v[c2], ix[c2], v[c], ix[c])
                       : lex_less(v[c], ix[c], v[c2], ix[c2]);
  if (swap) {
    const float tv = v[c];
    const int ti = ix[c];
    v[c] = v[c2];
    ix[c] = ix[c2];
    v[c2] = tv;
    ix[c2] = ti;
  }
}

// Ascending bitonic sort of the 32*N elements.
template <int N>
__device__ __forceinline__ void warp_sort(float (&v)[N], int (&ix)[N],
                                          int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * N; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const bool up = ((c * 32 + lane) & size) == 0;
        if (stride >= 32) {
          const int c2 = c ^ (stride / 32);
          if (c2 > c) cx_reg(v, ix, c, c2, up);
        } else {
          cx_lane(v, ix, c, stride, up, lane);
        }
      }
    }
  }
}

// Sorts a bitonic sequence of 32*N elements ascending.
template <int N>
__device__ __forceinline__ void warp_merge(float (&v)[N], int (&ix)[N],
                                           int lane) {
#pragma unroll
  for (int stride = 16 * N; stride > 0; stride >>= 1) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (stride >= 32) {
        const int c2 = c ^ (stride / 32);
        if (c2 > c) cx_reg(v, ix, c, c2, true);
      } else {
        cx_lane(v, ix, c, stride, true, lane);
      }
    }
  }
}

// Element kk-1 of the sorted list, broadcast to the warp.
template <int S>
__device__ __forceinline__ void list_at(const float (&lv)[S],
                                        const int (&li)[S], int kk, float& v,
                                        int& i) {
  const int c = (kk - 1) >> 5;
  float x = lv[0];
  int j = li[0];
#pragma unroll
  for (int s = 1; s < S; ++s)
    if (s == c) {
      x = lv[s];
      j = li[s];
    }
  v = __shfl_sync(kAll, x, (kk - 1) & 31);
  i = __shfl_sync(kAll, j, (kk - 1) & 31);
}

// The list of the 32*S best keeps the 32*S smallest of itself and the
// warp's queue (n < 2*32 candidates in shared memory): sort the queue as two
// chunks (the rest sentinels), take the elementwise min of the list's tail
// and the reversed queue (a bitonic sequence), merge.
template <int S>
__device__ __forceinline__ void flush(float (&lv)[S], int (&li)[S],
                                      const float* sv, const int* si, int n,
                                      int sentinel, int lane) {
  __syncwarp();
  float qv[kQueue];
  int qi[kQueue];
#pragma unroll
  for (int t = 0; t < kQueue; ++t) {
    const int e = t * 32 + lane;
    qv[t] = e < n ? sv[e] : kInf;
    qi[t] = e < n ? si[e] : sentinel;
  }
  __syncwarp();
  warp_sort<kQueue>(qv, qi, lane);
  constexpr int M = kQueue < S ? kQueue : S;
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const float bv = __shfl_xor_sync(kAll, qv[t], 31);
    const int bi = __shfl_xor_sync(kAll, qi[t], 31);
    if (lex_less(bv, bi, lv[S - 1 - t], li[S - 1 - t])) {
      lv[S - 1 - t] = bv;
      li[S - 1 - t] = bi;
    }
  }
  warp_merge<S>(lv, li, lane);
}

template <int S>
__device__ __forceinline__ void keep_smallest(float (&m)[S], float x) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float lo = fminf(m[s], x);
    x = fmaxf(m[s], x);
    m[s] = lo;
  }
}

// The kk-th smallest of the lanes' kept values (kk <= 32*S).
template <int S>
__device__ __forceinline__ float kth_smallest(float (&m)[S], int kk, int lane) {
  int ix[S];
#pragma unroll
  for (int s = 0; s < S; ++s) ix[s] = s * 32 + lane;
  warp_sort<S>(m, ix, lane);
  float v;
  int i;
  list_at<S>(m, ix, kk, v, i);
  return v;
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Keys j0 .. j0+n-1 of the structure into keys[0 .. n-1] as (x, y, z, m).
__device__ __forceinline__ void stage(float4* keys, const float* Xb,
                                      const float* mb, int j0, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float* d = reinterpret_cast<float*>(keys + j);
    const float* s = Xb + 3 * (size_t)(j0 + j);
    copy4(d, s);
    copy4(d + 1, s + 1);
    copy4(d + 2, s + 2);
    copy4(d + 3, mb + j0 + j);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Chunk t of a tile's n keys in the scan order (rotated to start at chunk
// c0): this lane's key, and whether it exists.
__device__ __forceinline__ int chunk_key(int t, int nch, int n, int c0,
                                         int lane, bool& ok) {
  int c = c0 + t;
  if (c >= nch) c -= nch;
  const int jl = (c << 5) + lane;
  ok = t < nch && jl < n;
  return ok ? jl : 0;
}

// Pass 1 over one tile: the row max and the lane's T smallest. Fast form:
// q of the valid keys (the query is valid); general form: D of every pair,
// the T smallest over pairs with m_i*m_j == 1, and whether all D are finite.
template <int T, bool kFast>
__device__ __forceinline__ void pass1(const float4* keys, int n, int c0,
                                      int lane, float qx, float qy, float qz,
                                      float mi, float eps, float& rmax,
                                      float (&lmin)[T], bool& finite) {
  const int nch = (n + 31) >> 5;
  for (int t = 0; t < nch; t += kUnroll) {
    float x[kUnroll];
    bool use[kUnroll], keep[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int jl = chunk_key(t + u, nch, n, c0, lane, use[u]);
      const float4 kp = keys[jl];
      const float q = sq_dist(qx, qy, qz, kp, eps);
      if (kFast) {
        x[u] = q;
        use[u] = use[u] && kp.w != 0.0f;
        keep[u] = use[u];
      } else {
        const float m2 = __fmul_rn(kp.w, mi);
        x[u] = __fmul_rn(m2, __fsqrt_rn(q));
        keep[u] = use[u] && m2 == 1.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (use[u]) {
        rmax = fmaxf(rmax, x[u]);
        if (!kFast) finite = finite && isfinite(x[u]);
      }
      if (keep[u]) keep_smallest<T>(lmin, x[u]);
    }
  }
}

// The selection's state in one round: the sorted list of the P best, the
// warp's queue in shared memory and its length, the list's kk-th (tv, ti),
// the prefilter bound on q (fast form), the lower bound (lbv, lbi) of the
// round and, general form, the lane's lowest key whose value is not NaN.
template <int S>
struct Select {
  float lv[S];
  int li[S];
  float* sv;
  int* si;
  int nq;
  float tv, qb, t0, lbv;
  int ti, lbi, kk, jmin;
};

// Queue the lanes' candidates (take); flush once 32 are queued.
template <int S>
__device__ __forceinline__ void enqueue(Select<S>& st, bool take, float v,
                                        int j, int sentinel, int lane) {
  const unsigned m = __ballot_sync(kAll, take);
  if (m == 0) return;
  if (take) {
    const int e = st.nq + __popc(m & ((1u << lane) - 1));
    st.sv[e] = v;
    st.si[e] = j;
  }
  st.nq += __popc(m);
  if (st.nq >= 32) {
    flush<S>(st.lv, st.li, st.sv, st.si, st.nq, sentinel, lane);
    st.nq = 0;
    list_at<S>(st.lv, st.li, st.kk, st.tv, st.ti);
    st.qb = qbound(fminf(st.t0, st.tv));
  }
}

// Pass 2 over one tile. Fast form: the candidate's q (D_max's q, rmax, for
// a masked key) against the bound, the root only of those that pass;
// general form: the plain formula's value, finite values only.
template <int S, bool kFast>
__device__ __forceinline__ void pass2(const float4* keys, int j0, int n,
                                      int c0, int lane, float qx, float qy,
                                      float qz, float mi, float eps,
                                      float rmax, float dmax, int sentinel,
                                      Select<S>& st) {
  const int nch = (n + 31) >> 5;
  for (int t = 0; t < nch; t += kUnroll) {
    float x[kUnroll];
    int jj[kUnroll];
    bool use[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int jl = chunk_key(t + u, nch, n, c0, lane, use[u]);
      const float4 kp = keys[jl];
      const float q = sq_dist(qx, qy, qz, kp, eps);
      jj[u] = j0 + jl;
      if (kFast) {
        x[u] = kp.w != 0.0f ? q : rmax;
      } else {
        const float m2 = __fmul_rn(kp.w, mi);
        const float d = __fmul_rn(m2, __fsqrt_rn(q));
        x[u] = __fadd_rn(d, __fmul_rn(__fsub_rn(1.0f, m2), dmax));
        if (use[u] && !isnan(x[u])) st.jmin = min(st.jmin, jj[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bool take;
      float v;
      if (kFast) {
        take = use[u] && x[u] <= st.qb;
        v = take ? __fsqrt_rn(x[u]) : kInf;
      } else {
        v = x[u];
        take = use[u] && v < kInf && v <= st.t0;
      }
      take = take && lex_less(v, jj[u], st.tv, st.ti) &&
             lex_less(st.lbv, st.lbi, v, jj[u]);
      enqueue<S>(st, take, v, jj[u], sentinel, lane);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const Args a) {
  extern __shared__ float4 keys[];
  __shared__ float queue_v[kWarps][kQueue * 32];
  __shared__ int queue_i[kWarps][kQueue * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / a.blocks_per_b;
  const int row = (blockIdx.x % a.blocks_per_b) * kWarps + warp;
  const bool active = row < a.Lq;     // warp-uniform
  const int Lk = a.Lk, k = a.k;
  const float eps = a.eps;
  const int ntiles = (Lk + kTileKeys - 1) / kTileKeys;
  const float* Xb = a.Xk + (size_t)b * Lk * 3;
  const float* mb = a.mk + (size_t)b * Lk;

  bool fast = false;
  if (ntiles == 1) {
    stage(keys, Xb, mb, 0, Lk);
    __syncthreads();
    bool ok = a.fast_eps != 0;
    for (int j = threadIdx.x; j < Lk; j += kThreads) {
      const float4 kp = keys[j];
      ok = ok && safe_coord(kp.x) && safe_coord(kp.y) && safe_coord(kp.z) &&
           safe_mask(kp.w);
    }
    fast = __syncthreads_and(ok) != 0;
  }

  const size_t qrow = (size_t)b * a.Lq + (active ? row : 0);
  const float qx = a.Xq[qrow * 3], qy = a.Xq[qrow * 3 + 1],
              qz = a.Xq[qrow * 3 + 2], mi = a.mq[qrow];
  fast = fast && safe_coord(qx) && safe_coord(qy) && safe_coord(qz) &&
         safe_mask(mi);
  float* Drow = a.D + qrow * k;
  long long* Erow = a.E + qrow * k;
  // Scan order: single-tile rows start at the chunk of their own index, so
  // near keys (of a structure against itself) fill the list first.
  const int c0 = ntiles == 1 ? (min(row, Lk - 1) >> 5) : 0;

  // Pass 1 (none for a masked query row of the fast form).
  // Each lane keeps its T smallest (T*32 >= k): their k-th is T0.
  constexpr int T = S == 1 ? 2 : S;
  float rmax = -kInf;
  float lmin[T];
#pragma unroll
  for (int s = 0; s < T; ++s) lmin[s] = kInf;
  bool finite = true;
  const bool skip_all = fast && mi == 0.0f;
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * kTileKeys, n = min(kTileKeys, Lk - j0);
    if (ntiles > 1) {
      __syncthreads();
      stage(keys, Xb, mb, j0, n);
      __syncthreads();
    }
    if (!active || skip_all) continue;
    if (fast)
      pass1<T, true>(keys, n, c0, lane, qx, qy, qz, mi, eps, rmax, lmin, finite);
    else
      pass1<T, false>(keys, n, c0, lane, qx, qy, qz, mi, eps, rmax, lmin, finite);
  }
  for (int off = 16; off > 0; off >>= 1)
    rmax = fmaxf(rmax, __shfl_xor_sync(kAll, rmax, off));
  finite = __all_sync(kAll, finite);
  constexpr int P = 32 * S;
  // fast: no valid pair (or a masked query row) -> every value is 0
  const bool zeros = fast && (skip_all || rmax == -kInf);
  // fast: rmax is the largest q, and D_max its root
  const float dmax = fast ? (zeros ? 0.0f : __fsqrt_rn(rmax)) : rmax;
  float T0 = kInf;
  if (active && !zeros && (fast || finite)) {
    T0 = kth_smallest<T>(lmin, min(k, P), lane);
    if (fast && T0 < kInf) T0 = __fsqrt_rn(T0);
  }

  // Pass 2, in rounds of P: the P smallest above (lbv, lbi).
  Select<S> st;
  st.sv = queue_v[warp];
  st.si = queue_i[warp];
  st.lbv = -kInf;
  st.lbi = -1;
  int jstar = Lk;
  for (int r0 = 0; r0 < k; r0 += P) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      st.lv[s] = kInf;
      st.li[s] = Lk;
    }
    st.nq = 0;
    st.kk = min(P, k - r0);
    st.tv = kInf;
    st.ti = Lk;
    st.t0 = r0 == 0 ? T0 : kInf;
    st.qb = qbound(st.t0);
    st.jmin = Lk;
    for (int t = 0; t < ntiles; ++t) {
      const int j0 = t * kTileKeys, n = min(kTileKeys, Lk - j0);
      if (ntiles > 1) {
        __syncthreads();
        stage(keys, Xb, mb, j0, n);
        __syncthreads();
      }
      if (!active || zeros) continue;
      if (fast)
        pass2<S, true>(keys, j0, n, c0, lane, qx, qy, qz, mi, eps, rmax, dmax,
                       Lk, st);
      else
        pass2<S, false>(keys, j0, n, c0, lane, qx, qy, qz, mi, eps, rmax,
                        dmax, Lk, st);
    }
    if (!active) continue;
    if (zeros) {
      for (int e = lane; e < st.kk; e += 32) {
        Drow[r0 + e] = 0.0f;
        Erow[r0 + e] = r0 + e;
      }
      continue;
    }
    if (st.nq > 0) flush<S>(st.lv, st.li, st.sv, st.si, st.nq, Lk, lane);
    if (!fast && r0 == 0) jstar = __reduce_min_sync(kAll, st.jmin);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int e = s * 32 + lane;
      if (e < st.kk) {
        const bool none = st.li[s] == Lk;   // fewer finite values than slots
        Drow[r0 + e] = none ? kInf : st.lv[s];
        Erow[r0 + e] = none ? jstar : st.li[s];
      }
    }
    list_at<S>(st.lv, st.li, st.kk, st.lbv, st.lbi);
  }
}

template <int S>
int launch_s(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(a.Lk < kTileKeys ? a.Lk : kTileKeys) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_kernel<S><<<B * a.blocks_per_b, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch(const float* Xq, const float* mask_q, const float* Xk,
           const float* mask_k, int B, int Lq, int Lk, int k, float eps,
           float* D_out, long long* E_out, cudaStream_t stream) {
  if (B < 1 || Lq < 1 || k < 1 || k > Lk) return (int)cudaErrorInvalidValue;
  const int fast_eps = eps >= 0.0f && eps <= 1e30f;
  const Args a{Xq, mask_q, Xk, mask_k, Lq, Lk, k, (Lq + kWarps - 1) / kWarps,
               fast_eps, eps, D_out, E_out};
  return k <= 32 ? launch_s<1>(a, B, stream) : launch_s<4>(a, B, stream);
}

}  // namespace

// X [B, L, 3], mask [B, L] -> D_out [B, L, k], E_out [B, L, k].
extern "C" int knn_forward(const float* X, const float* mask, int B, int L,
                           int k, float eps, float* D_out, long long* E_out,
                           cudaStream_t stream) {
  return launch(X, mask, X, mask, B, L, L, k, eps, D_out, E_out, stream);
}

// Xq [B, Lq, 3], mask_q [B, Lq], Xk [B, Lk, 3], mask_k [B, Lk]
// -> D_out [B, Lq, k], E_out [B, Lq, k] (key indices).
extern "C" int knn_qk_forward(const float* Xq, const float* mask_q,
                              const float* Xk, const float* mask_k, int B,
                              int Lq, int Lk, int k, float eps, float* D_out,
                              long long* E_out, cudaStream_t stream) {
  return launch(Xq, mask_q, Xk, mask_k, B, Lq, Lk, k, eps, D_out, E_out,
                stream);
}
