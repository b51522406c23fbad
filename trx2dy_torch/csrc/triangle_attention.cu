// Triangle attention core, forward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel trx2dy/ops/triangle_attention.py:
// _tri_attn_kernel (launched by triangle_attention_flash). For row r,
// query i and head h it computes
//
//   out[r,i,h,:] = sum_j softmax_j( q[r,i,h,:].k[r,j,h,:] / sqrt(D)
//                                   + bias[i,j,h] ) v[r,j,h,:]
//
// with an online softmax over key tiles, so the (L, L, L, H) logits never
// reach device memory. Column-wise attention is the same function with the
// row and position axes of q, k, v and out exchanged: the kernel takes a
// row stride and a position stride for every tensor, so the caller passes
// swapped strides and makes no transposed copy. The bias keeps its
// (query, key, head) meaning in both directions.
//
// What bounds it on an H100: at L=400, H=4, D=32 one call does
// 4 L^3 H D = 32.8 GFLOP and moves about 328 MB of q, k, v and out.
// Against 67 TFLOP/s of float32 outside the tensor cores (0.49 ms) and
// 3.35 TB/s (0.10 ms), it is bound by operations. The TF32 (495 TFLOP/s)
// and bf16 (989 TFLOP/s) tensor-core rates would move that bound below
// the memory one; wgmma, TMA and bf16 are left to later work.
//
// Design: one block per (query tile of BQ=64, head, row); one thread per
// query, holding its 32 scaled q values, its running max and sum and a
// 32-wide accumulator in registers. K and V tiles of BK=32 keys and the
// (BQ, BK) bias tile sit in shared memory; every thread of a warp reads
// the same K/V element at once, which shared memory broadcasts. The
// ragged L edge is masked in the kernel: keys past L score -inf, queries
// past L load zeros and store nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 32;    // head width of the trunk (dim 128 / 4 heads)
constexpr int BQ = 64;   // queries per block, one per thread
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int D4 = D / 4;

__global__ void __launch_bounds__(BQ)
tri_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int L, long long q_sr, long long q_sp, long long k_sr,
                    long long k_sp, long long v_sr, long long v_sp,
                    long long o_sr, long long o_sp, long long b_si,
                    long long b_sj, long long b_sh, float scale) {
  __shared__ __align__(16) float Ks[BK][D];
  __shared__ __align__(16) float Vs[BK][D];
  __shared__ float Bs[BQ][BK + 1];   // +1: conflict-free reads by row

  const int t = threadIdx.x;
  const int h = blockIdx.y;
  const long long r = blockIdx.z;
  const int i0 = blockIdx.x * BQ;
  const int i = i0 + t;
  const bool active = i < L;

  float qr[D];
  if (active) {
    const float4* qp = reinterpret_cast<const float4*>(
        q + r * q_sr + (long long)i * q_sp + h * D);
#pragma unroll
    for (int c = 0; c < D4; ++c) {
      const float4 x = qp[c];
      qr[4 * c + 0] = x.x * scale;
      qr[4 * c + 1] = x.y * scale;
      qr[4 * c + 2] = x.z * scale;
      qr[4 * c + 3] = x.w * scale;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  const float* kr = k + r * k_sr + h * D;
  const float* vr = v + r * v_sr + h * D;

  for (int j0 = 0; j0 < L; j0 += BK) {
    const int nk = min(BK, L - j0);
    __syncthreads();   // the previous tile has been consumed
    for (int e = t; e < BK * D4; e += BQ) {
      const int jj = e / D4;
      const int c = e % D4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (jj < nk) {
        kx = reinterpret_cast<const float4*>(
            kr + (long long)(j0 + jj) * k_sp)[c];
        vx = reinterpret_cast<const float4*>(
            vr + (long long)(j0 + jj) * v_sp)[c];
      }
      reinterpret_cast<float4*>(&Ks[jj][0])[c] = kx;
      reinterpret_cast<float4*>(&Vs[jj][0])[c] = vx;
    }
    for (int e = t; e < BQ * BK; e += BQ) {
      const int ii = e / BK;
      const int jj = e % BK;
      float b = 0.f;
      if (i0 + ii < L && jj < nk)
        b = bias[(long long)(i0 + ii) * b_si + (long long)(j0 + jj) * b_sj +
                 (long long)h * b_sh];
      Bs[ii][jj] = b;
    }
    __syncthreads();

    float s[BK];
    float m_new = m;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float4* kx4 = reinterpret_cast<const float4*>(&Ks[jj][0]);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 kx = kx4[c];
        dot = fmaf(qr[4 * c + 0], kx.x, dot);
        dot = fmaf(qr[4 * c + 1], kx.y, dot);
        dot = fmaf(qr[4 * c + 2], kx.z, dot);
        dot = fmaf(qr[4 * c + 3], kx.w, dot);
      }
      s[jj] = jj < nk ? dot + Bs[t][jj] : -INFINITY;
      m_new = fmaxf(m_new, s[jj]);
    }

    const float corr = expf(m - m_new);   // 0 on the first tile
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = expf(s[jj] - m_new);   // 0 for masked keys
      l += p;
      const float4* vx4 = reinterpret_cast<const float4*>(&Vs[jj][0]);
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 vx = vx4[c];
        acc[4 * c + 0] = fmaf(p, vx.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(p, vx.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vx.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vx.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / l;
    float4* op = reinterpret_cast<float4*>(
        out + r * o_sr + (long long)i * o_sp + h * D);
#pragma unroll
    for (int c = 0; c < D4; ++c)
      op[c] = make_float4(acc[4 * c + 0] * inv, acc[4 * c + 1] * inv,
                          acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. Every tensor is
// float32 with head stride D and unit element stride; strides are in
// elements. Returns cudaGetLastError() after the launch.
extern "C" int trx2dy_tri_attn_fwd(
    const float* q, const float* k, const float* v, const float* bias,
    float* out, int L, int H, int head_dim, long long q_sr, long long q_sp,
    long long k_sr, long long k_sp, long long v_sr, long long v_sp,
    long long o_sr, long long o_sp, long long b_si, long long b_sj,
    long long b_sh, void* stream) {
  if (L <= 0 || H <= 0 || H > 65535 || L > 65535 || head_dim != D)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((L + BQ - 1) / BQ, H, L);
  tri_attn_fwd_kernel<<<grid, BQ, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, bias, out, L, q_sr, q_sp, k_sr, k_sp, v_sr, v_sp, o_sr, o_sp,
      b_si, b_sj, b_sh, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}
