// Message MLP with the neighbour-table gather inside, for Hopper (sm_90a),
// forward, in three modes; fp32, and bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/message_kernels.py::
// _message_table_fwd_call (_fwd_kernel_table, message_kernels.py:314).
// Per edge row e = (node n, neighbour slot k), with j = eidx[e] local to the
// structure b = n / L and table row t = b*Lk + j (the table holds Lk rows per
// structure: Lk = L on one device; on the graph-parallel route the nodes are a
// shard's L rows and the table the all-gathered structure's Lk rows):
//   enc modes: x = h_V[n]@Wa + e_in[e]@Wb + table[t] + b1
//   dec mode:  x = h_V[n]@Wa + m1d[e]*(e_in[e]@Wb)
//                  + mbw[e]*A[t] + m1d[e]*B[t] + b1,   table = [A | B]
//   m = W3 . gelu(W2 . gelu(x) + b2) + b3          (exact erf GELU)
//   enc-node: out[n] = sum_k mask_att[e]*m / 30     -> [N, H]
//   enc-edge: out[e] = m                            -> [N*K, H]
//   dec:      out[n] = sum_k m / 30 (no mask)       -> [N, H]
// x_out, when not null, receives the pre-GELU x of every edge row [N*K, H]:
// the backward kernel (message_table_bwd.cu) resumes from it, as the TPU
// kernel's save_x output (message_kernels.py:553-567) does.
// The TPU kernel maps a whole structure's table into VMEM and selects rows
// with a one-hot matmul, which is why it needs L % 32 == 0. Here each block
// reads its rows by their flat global index, so any L is taken.
//
// bf16 (message_table_forward_bf16; the TPU kernel's compute_dtype=bfloat16
// branch, message_kernels.py:165, :336-356): every operand, weight and
// output is bf16; x is computed in fp32 and saved rounded to bf16; gelu(x)
// and gelu(y) are rounded to bf16 before the next product; the K-sum of
// the summing modes runs in fp32 and is rounded once. Each product sums
// exact bf16 x bf16 products in fp32 (FMA on widened operands).
//
// What bounds it on the card: operations. Three H x H products per edge
// (2*3*H*H = 98 kFLOP at H = 128) against about 1 KB per edge of e_in,
// gathered table row and output (fp32, outside the tensor cores in this
// first version).
// Design: one block of 256 threads per tile of T = 64/K nodes (64 edge rows).
// The tile's activations stay in shared memory ([64, H], 32 KB at H = 128)
// through all three products; the weights stream through shared memory in
// chunks of 32 rows; each thread owns 8 rows x H/32 columns of every product
// in registers. h_V@Wa is computed once per node and added to its K rows,
// b1 once per row, and the K-reduction of the agg modes runs in fp32 over
// the rows in shared memory.
#include "message_common.cuh"

namespace {

template <typename T>
struct Params {
  const T* h_V;
  const T* e_in;
  const T* table;
  const long long* eidx;
  const T* m_att;
  const T* mbw;
  const T* wa;
  const T* wb;
  const T* b1;
  const T* w2;
  const T* b2;
  const T* w3;
  const T* b3;
  T* out;
  T* x_out;
  int N, K, L, Lk, tn;  // tn: nodes per tile
};

template <int H, typename T>
__global__ void __launch_bounds__(kThreads)
message_table_kernel(Params<T> p, int mode) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;               // [kRows][H] activations
  float* Ws = Xs + kRows * H;     // [kKC][H] weight chunk
  float* AI = Ws + kKC * H;       // [tn][H] h_V @ Wa of the tile's nodes
  float* HV = AI + p.tn * H;      // [tn][H] h_V of the tile's nodes
  constexpr int CPT = H / 32;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int n0 = blockIdx.x * p.tn;
  const int nodes = min(p.tn, p.N - n0);
  const int rows = nodes * p.K;
  const size_t e0 = (size_t)n0 * p.K;

  for (int idx = tid; idx < p.tn * H; idx += kThreads)
    HV[idx] = idx < nodes * H ? to_f(p.h_V[(size_t)n0 * H + idx]) : 0.f;
  for (int idx = tid; idx < kRows * H; idx += kThreads)
    Xs[idx] = idx < rows * H ? to_f(p.e_in[e0 * H + idx]) : 0.f;
  __syncthreads();
  for (int idx = tid; idx < p.tn * H; idx += kThreads) {
    const int t = idx / H, h = idx % H;
    float s = 0.f;
    for (int k = 0; k < H; ++k) s = fmaf(HV[t * H + k], ldf(p.wa + k * H + h), s);
    AI[idx] = s;
  }

  float acc[8][CPT];
  gemm<H>(Xs, p.wb, Ws, acc);  // e_in @ Wb (its first barrier publishes AI)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r >= rows) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) Xs[r * H + tx * CPT + c] = 0.f;
      continue;
    }
    const size_t e = e0 + r;
    const int t = r / p.K;
    const size_t grow = (size_t)((n0 + t) / p.L) * p.Lk + p.eidx[e];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx * CPT + c;
      float x;
      if (mode == kDec) {
        const float m1 = to_f(p.m_att[e]), mb = to_f(p.mbw[e]);
        const T* tr = p.table + grow * 2 * H;
        x = AI[t * H + h] + m1 * acc[i][c] + mb * to_f(tr[h]) + m1 * to_f(tr[H + h]) +
            to_f(p.b1[h]);
      } else {
        x = AI[t * H + h] + acc[i][c] + to_f(p.table[grow * H + h]) + to_f(p.b1[h]);
      }
      if (p.x_out) p.x_out[e * H + h] = from_f<T>(x);
      Xs[r * H + h] = rnd<T>(gelu(x));
    }
  }
  __syncthreads();
  gemm<H>(Xs, p.w2, Ws, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx * CPT + c;
      Xs[r * H + h] = rnd<T>(gelu(acc[i][c] + to_f(p.b2[h])));
    }
  }
  __syncthreads();
  gemm<H>(Xs, p.w3, Ws, acc);

  if (mode == kEncEdge) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      if (r >= rows) continue;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int h = tx * CPT + c;
        p.out[(e0 + r) * H + h] = from_f<T>(acc[i][c] + to_f(p.b3[h]));
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    const float w = r >= rows ? 0.f : (mode == kEncNode ? to_f(p.m_att[e0 + r]) : 1.f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx * CPT + c;
      Xs[r * H + h] = (acc[i][c] + to_f(p.b3[h])) * w;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nodes * H; idx += kThreads) {
    const int t = idx / H, h = idx % H;
    float s = 0.f;
    for (int k = 0; k < p.K; ++k) s += Xs[(t * p.K + k) * H + h];
    p.out[(size_t)(n0 + t) * H + h] = from_f<T>(s / 30.0f);
  }
}

template <int H, typename T>
int launch(const Params<T>& p, int mode, cudaStream_t stream) {
  const size_t smem = (size_t)(kRows + kKC + 2 * p.tn) * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      message_table_kernel<H, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.N + p.tn - 1) / p.tn;
  message_table_kernel<H, T><<<blocks, kThreads, smem, stream>>>(p, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(int mode, const T* h_V, const T* e_in, const T* table,
            const long long* eidx, const T* m_att, const T* mbw, const T* wa,
            const T* wb, const T* b1, const T* w2, const T* b2, const T* w3,
            const T* b3, T* out, T* x_out, int N, int K, int L, int Lk, int H,
            cudaStream_t stream) {
  if (K < 1 || K > kRows || mode < kEncNode || mode > kDec || L < 1 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  Params<T> p{h_V, e_in, table, eidx, m_att, mbw, wa, wb, b1, w2, b2,
              w3,  b3,   out,   x_out, N,   K,   L,  Lk, kRows / K};
  switch (H) {
    case 32: return launch<32>(p, mode, stream);
    case 64: return launch<64>(p, mode, stream);
    case 128: return launch<128>(p, mode, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int message_table_forward(
    int mode, const float* h_V, const float* e_in, const float* table,
    const long long* eidx, const float* m_att, const float* mbw,
    const float* wa, const float* wb, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, float* out,
    float* x_out, int N, int K, int L, int Lk, int H, cudaStream_t stream) {
  return forward<float>(mode, h_V, e_in, table, eidx, m_att, mbw, wa, wb, b1,
                        w2, b2, w3, b3, out, x_out, N, K, L, Lk, H, stream);
}

// The same with every operand and output bf16.
extern "C" int message_table_forward_bf16(
    int mode, const bf16* h_V, const bf16* e_in, const bf16* table,
    const long long* eidx, const bf16* m_att, const bf16* mbw, const bf16* wa,
    const bf16* wb, const bf16* b1, const bf16* w2, const bf16* b2,
    const bf16* w3, const bf16* b3, bf16* out, bf16* x_out, int N, int K,
    int L, int Lk, int H, cudaStream_t stream) {
  return forward<bf16>(mode, h_V, e_in, table, eidx, m_att, mbw, wa, wb, b1,
                       w2, b2, w3, b3, out, x_out, N, K, L, Lk, H, stream);
}
