// K3: the IMU preintegration factor and its block of the Gauss-Newton
// normal equations.
//
// Replaces no Pallas kernel. It replaces an autodiff composition: the JAX
// package's xrslam_tpu/estimation/factors.py:179 (preint_residual_jac,
// jax.jacfwd under jax.vmap) with the one-hot einsum scatter of its blocks in
// solver.assemble, which the port ran as torch.func.jacrev under vmap
// (factors.preint_residual_jac) and gram.preint_blocks: about 2,800 ATen
// operations a call, some 1,450 of them kernels on the card, for at most 31
// pairs of 15 residuals.
//
// One launch, for every pair j = 1..K-1 of a window (entry j couples frames
// i = j-1 and j; entry 0 couples no two frames and is never a factor):
//   - the 15-residual of factors._preint_residual_core, weighted by the
//     delta's sqrt information U, and its Jacobians J_i, J_j (15x15 each)
//     against the error state (theta, p, v, bg, ba) of both frames under the
//     retraction q*exp(dtheta), additive for the rest, in closed form
//     (factors.preint_residual_jac_closed: the bias correction through
//     dq_dbg and Jr(phi0), the logmap through Jr^-1(r_q)), masked by the
//     pair mask;
//   - J^T J added to the block-tridiagonal part of H (K,15,K,15) and J^T r
//     to b (K,15), in place, in the plain version's order
//     (gram.preint_blocks): diagonal block k gets pair k+1's J_i^T J_i, then
//     pair k's J_j^T J_j; b[k] pair k+1's J_i^T r, then pair k's J_j^T r;
//   - the cost 0.5 * sum |r|^2.
//
// What bounds it on the card: at the main path's K=12 in float64 it reads
// about 30 KB of window inputs (U is 225 of a pair's ~310 values) and reads
// and writes the 3K-2 touched blocks of H, 2 x 61 KB; the arithmetic is about
// 43 kFLOP a pair. That is 0.05 us of memory traffic at 3.35 TB/s and
// nothing of the card's float64 rate: the kernel is latency-bound, a chain of
// dependent float64 operations and transcendentals per pair. The design
// answers with one launch in place of ~1,450, not with a roofline:
//  - Grid (K + 1, N), 8 warps a CTA. CTA m < K owns block row m of its
//    window: warp 0 computes pair m, warp 1 pair m+1 into shared memory
//    (r and both Jacobians, 15 x 31), then all warps form the three blocks
//    (m, m-1), (m, m) and (m, m+1) and b[m]. CTA K computes the cost, its
//    warps taking the pairs in turn. A pair is computed by the CTAs of both
//    rows it touches, through the one call site below, so both copies are
//    the same instructions on the same inputs and bit-equal.
//  - In a warp, lane 0 builds the unweighted factor (its few 3x3 blocks,
//    quaternion and SO(3) functions of lie.py), and lane c < 31 then forms
//    column c of U*[r | J_i | J_j], with the pair's U in shared memory.
//  - Deterministic, no floating-point atomics: each entry of H, b and the
//    cost has one writer, which sums in a fixed order. Every dot product goes
//    through one call site, so the term lists of H[a,b] and H[b,a] are
//    computed alike: H stays exactly symmetric if it came in so, and two
//    launches on the same inputs give bit-equal outputs.
//  - H and b are updated in place (the wrapper hands in a fresh copy of the
//    caller's accumulators); nothing is allocated or synchronised here.
//  - A batch of N windows of one K (solver.assemble_batch) is a grid
//    dimension: window w's arrays sit at w times each array's per-window size.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lie.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 31;               // a pair's columns: r, J_i, J_j
constexpr int kPair = 15 * kCols;       // its 15 rows, row-major
constexpr int kStage = kPair + 225;     // and its sqrt information
constexpr int kBlockItems = 3 * 225 + 15;  // a block row's entries and b's

template <typename T>
struct PreintIn {
  const T* q;       // (K,4) body-to-world
  const T* p;       // (K,3)
  const T* v;
  const T* bg;
  const T* ba;
  const T* q_bi;    // (K,4) IMU extrinsic
  const T* p_bi;    // (K,3)
  const T* t;       // (K,) preintegration: time
  const T* dq;      // (K,4)
  const T* dp;      // (K,3)
  const T* dv;
  const T* U;       // (K,15,15) sqrt information
  const T* dq_dbg;  // (K,3,3)
  const T* dp_dbg;
  const T* dp_dba;
  const T* dv_dbg;
  const T* dv_dba;
  const T* bg_lin;  // (K,3)
  const T* ba_lin;
  const uint8_t* mask;  // (K,)
  T* H;             // (K,15,K,15), updated in place
  T* b;             // (K,15), updated in place
  T* cost;          // ()
};

// Window w of a batch: every array advanced by w windows.
template <typename T>
__device__ __forceinline__ void batch_row(PreintIn<T>& in, int w, int K) {
  const size_t k = static_cast<size_t>(w) * K;
  in.q += 4 * k;
  in.p += 3 * k;
  in.v += 3 * k;
  in.bg += 3 * k;
  in.ba += 3 * k;
  in.q_bi += 4 * k;
  in.p_bi += 3 * k;
  in.t += k;
  in.dq += 4 * k;
  in.dp += 3 * k;
  in.dv += 3 * k;
  in.U += 225 * k;
  in.dq_dbg += 9 * k;
  in.dp_dbg += 9 * k;
  in.dp_dba += 9 * k;
  in.dv_dbg += 9 * k;
  in.dv_dba += 9 * k;
  in.bg_lin += 3 * k;
  in.ba_lin += 3 * k;
  in.mask += k;
  in.H += 225 * k * K;
  in.b += 15 * k;
  in.cost += w;
}

// W[(r0 + r) * kCols + c0 + c] = s * op(M)[r][c]
template <typename T, bool tm = false>
__device__ __forceinline__ void put(T* W, int r0, int c0, const T* M, T s) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      W[(r0 + r) * kCols + c0 + c] = s * (tm ? M[3 * c + r] : M[3 * r + c]);
}

// Pair n (frames i = n-1 and j = n) into W (15 x 31: column 0 the weighted
// residual, 1-15 J_i, 16-30 J_j), masked; one warp. Us holds the pair's U.
template <typename T>
__device__ void pair_factor(const PreintIn<T>& in, int n, T* W, T* Us, int lane) {
  const int i = n - 1, j = n;
  for (int e = lane; e < 225; e += 32) Us[e] = in.U[225 * j + e];
  for (int e = lane; e < kPair; e += 32) W[e] = T(0);
  __syncwarp();
  if (lane == 0) {
    T q_i[4], q_j[4], q_bi[4], q_bj[4], p_bi[3], p_bj[3];
    load<T, 4>(in.q + 4 * i, q_i);
    load<T, 4>(in.q + 4 * j, q_j);
    load<T, 4>(in.q_bi + 4 * i, q_bi);
    load<T, 4>(in.q_bi + 4 * j, q_bj);
    load<T, 3>(in.p_bi + 3 * i, p_bi);
    load<T, 3>(in.p_bi + 3 * j, p_bj);
    T R_i[9], R_j[9], R_bi[9], R_bj[9], R_qi[9], R_qj[9], qi[4], qj[4];
    qmat(q_i, R_i);
    qmat(q_j, R_j);
    qmat(q_bi, R_bi);
    qmat(q_bj, R_bj);
    qmul(q_i, q_bi, qi);
    qmul(q_j, q_bj, qj);
    qmat(qi, R_qi);
    qmat(qj, R_qj);
    T pi[3], pj[3], dbg[3], dba[3], ap[3], av[3];
    rot(q_i, p_bi, pi);
    rot(q_j, p_bj, pj);
    const T t = in.t[j];
    const T g[3] = {T(0), T(0), T(-9.80665)};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pi[c] += in.p[3 * i + c];
      pj[c] += in.p[3 * j + c];
      dbg[c] = in.bg[3 * i + c] - in.bg_lin[3 * j + c];
      dba[c] = in.ba[3 * i + c] - in.ba_lin[3 * j + c];
      ap[c] = pj[c] - pi[c] - t * in.v[3 * i + c] - T(0.5) * t * t * g[c];
      av[c] = in.v[3 * j + c] - in.v[3 * i + c] - t * g[c];
    }
    // r_q = log(q_corr* qi* qj), q_corr = dq exp(dq_dbg dbg)
    T A[9], phi0[3], e[4], qc[4], qa[4], qb[4], E[4], r_q[3];
    load<T, 9>(in.dq_dbg + 9 * j, A);
    mv<T, false>(A, dbg, phi0);
    expmap(phi0, e);
    qmul(in.dq + 4 * j, e, qc);
    qconj(qi, qa);
    qmul(qa, qj, qb);
    qconj(qc, qa);
    qmul(qa, qb, E);
    logmap(E, r_q);
    // r_p, r_v: y - (delta + bias terms)
    T Mg[9], Ma[9], y_p[3], y_v[3], u[3], w[3];
    mv<T, true>(R_qi, ap, y_p);
    mv<T, true>(R_qi, av, y_v);
    load<T, 9>(in.dp_dbg + 9 * j, Mg);
    load<T, 9>(in.dp_dba + 9 * j, Ma);
    mv<T, false>(Mg, dbg, u);
    mv<T, false>(Ma, dba, w);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      W[c * kCols] = r_q[c];
      W[(3 + c) * kCols] = y_p[c] - (in.dp[3 * j + c] + (u[c] + w[c]));
    }
    put(W, 3, 10, Mg, T(-1));
    put(W, 3, 13, Ma, T(-1));
    load<T, 9>(in.dv_dbg + 9 * j, Mg);
    load<T, 9>(in.dv_dba + 9 * j, Ma);
    mv<T, false>(Mg, dbg, u);
    mv<T, false>(Ma, dba, w);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      W[(6 + c) * kCols] = y_v[c] - (in.dv[3 * j + c] + (u[c] + w[c]));
      W[(9 + c) * kCols] = in.bg[3 * j + c] - in.bg[3 * i + c];
      W[(12 + c) * kCols] = in.ba[3 * j + c] - in.ba[3 * i + c];
      W[(9 + c) * kCols + 10 + c] = T(-1);   // d r_bg / d bg_i
      W[(9 + c) * kCols + 25 + c] = T(1);    // d r_bg / d bg_j
      W[(12 + c) * kCols + 13 + c] = T(-1);  // d r_ba / d ba_i
      W[(12 + c) * kCols + 28 + c] = T(1);   // d r_ba / d ba_j
    }
    put(W, 6, 10, Mg, T(-1));
    put(W, 6, 13, Ma, T(-1));
    // the rotation rows
    T Jri[9], M[9], M2[9], Hh[9];
    right_jacobian<T, true>(r_q, Jri);
    mm<T, true, false>(R_qj, R_i, M);
    mm<T, false, false>(Jri, M, M2);
    put(W, 0, 1, M2, T(-1));                 // -Jr^-1 R_qj^T R_i
    right_jacobian<T, false>(phi0, M);
    mm<T, false, false>(M, A, M2);
    qmat(E, M);
    mm<T, true, false>(M, M2, Hh);
    mm<T, false, false>(Jri, Hh, M);
    put(W, 0, 10, M, T(-1));                 // -Jr^-1 R(E)^T Jr(phi0) dq_dbg
    mm<T, false, true>(Jri, R_bj, M);
    put(W, 0, 16, M, T(1));                  // Jr^-1 R_bj^T
    // the position and velocity rows against theta
    hat(y_p, Hh);
    mm<T, false, true>(Hh, R_bi, M);
    hat(p_bi, Hh);
    mm<T, true, false>(R_bi, Hh, M2);
#pragma unroll
    for (int e2 = 0; e2 < 9; ++e2) M[e2] += M2[e2];
    put(W, 3, 1, M, T(1));                   // [y_p]x R_bi^T + R_bi^T [p_bi]x
    hat(y_v, Hh);
    mm<T, false, true>(Hh, R_bi, M);
    put(W, 6, 1, M, T(1));                   // [y_v]x R_bi^T
    hat(p_bj, Hh);
    mm<T, false, false>(R_j, Hh, M);
    mm<T, true, false>(R_qi, M, M2);
    put(W, 3, 16, M2, T(-1));                // -R_qi^T R_j [p_bj]x
    put<T, true>(W, 3, 4, R_qi, T(-1));      // d r_p / d p_i
    put<T, true>(W, 3, 7, R_qi, -t);         // d r_p / d v_i
    put<T, true>(W, 3, 19, R_qi, T(1));      // d r_p / d p_j
    put<T, true>(W, 6, 7, R_qi, T(-1));      // d r_v / d v_i
    put<T, true>(W, 6, 22, R_qi, T(1));      // d r_v / d v_j
  }
  __syncwarp();
  // lane c: column c of U * W, masked, back into W
  T acc[15];
  if (lane < kCols) {
#pragma unroll
    for (int a = 0; a < 15; ++a) {
      T s = 0;
#pragma unroll
      for (int k = 0; k < 15; ++k) s += Us[15 * a + k] * W[k * kCols + lane];
      acc[a] = s;
    }
  }
  __syncwarp();
  const T mf = in.mask[j] ? T(1) : T(0);
  if (lane < kCols) {
#pragma unroll
    for (int a = 0; a < 15; ++a) W[a * kCols + lane] = acc[a] * mf;
  }
  __syncwarp();
}

// sum_r x[r * kCols] * y[r * kCols], rows in order
template <typename T>
__device__ __forceinline__ T dot15(const T* x, const T* y) {
  T s = 0;
#pragma unroll
  for (int r = 0; r < 15; ++r) s += x[r * kCols] * y[r * kCols];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
preint_block_row_kernel(PreintIn<T> in, int K) {
  __shared__ T smem[kWarps * kStage + kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x;  // block row m, or m == K: the cost
  batch_row(in, blockIdx.y, K);
  T* W = smem + warp * kStage;
  // the pairs this warp takes; pair 0 is never a factor
  const bool cost_cta = m == K;
  int n = cost_cta ? 1 + warp : (warp < 2 && m + warp >= 1 ? m + warp : K);
  const int step = cost_cta ? kWarps : K;
  T c = 0;
  for (; n < K; n += step) {
    pair_factor(in, n, W, W + kPair, lane);
    if (cost_cta && lane == 0)
      for (int r = 0; r < 15; ++r) c += W[r * kCols] * W[r * kCols];
    __syncwarp();
  }
  if (cost_cta) {
    T* part = smem + kWarps * kStage;
    if (lane == 0) part[warp] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
      T s = 0;
      for (int w = 0; w < kWarps; ++w) s += part[w];
      *in.cost = T(0.5) * s;
    }
    return;
  }
  __syncthreads();
  // block row m: pair m (warp 0's stage, present when m >= 1) gives
  // J_j^T [J_i J_j] at columns (m-1, m) and J_j^T r; pair m+1 (warp 1's,
  // present when m+1 < K) J_i^T [J_i J_j] at (m, m+1) and J_i^T r.
  const T* S0 = smem;           // pair m
  const T* S1 = smem + kStage;  // pair m+1
  const bool has0 = m >= 1, has1 = m + 1 < K;
  for (int e = threadIdx.x; e < kBlockItems; e += kThreads) {
    T* dst;
    const T* x[2];
    const T* y[2];
    int terms = 0;
    if (e < 3 * 225) {
      const int blk = e / 225, a = e % 225 / 15, bb = e % 15;
      const int col = m - 1 + blk;
      if (col < 0 || col >= K) continue;
      dst = in.H + (static_cast<size_t>(m) * 15 + a) * K * 15 + col * 15 + bb;
      if (blk == 0) {
        x[terms] = S0 + 16 + a;
        y[terms++] = S0 + 1 + bb;
      } else if (blk == 2) {
        x[terms] = S1 + 1 + a;
        y[terms++] = S1 + 16 + bb;
      } else {
        if (has1) {
          x[terms] = S1 + 1 + a;
          y[terms++] = S1 + 1 + bb;
        }
        if (has0) {
          x[terms] = S0 + 16 + a;
          y[terms++] = S0 + 16 + bb;
        }
      }
    } else {
      const int a = e - 3 * 225;
      dst = in.b + m * 15 + a;
      if (has1) {
        x[terms] = S1 + 1 + a;
        y[terms++] = S1;
      }
      if (has0) {
        x[terms] = S0 + 16 + a;
        y[terms++] = S0;
      }
    }
    T v = *dst;
#pragma unroll 1
    for (int t = 0; t < terms; ++t) v += dot15(x[t], y[t]);
    *dst = v;
  }
}

template <typename T>
int launch(const PreintIn<T>& in, int K, int N, cudaStream_t stream) {
  preint_block_row_kernel<T><<<dim3(K + 1, N), kThreads, 0, stream>>>(in, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
PreintIn<T> inputs(const void* const* a, void* H, void* b, void* cost) {
  PreintIn<T> in;
  const T** f[] = {&in.q,      &in.p,      &in.v,      &in.bg,     &in.ba,
                   &in.q_bi,   &in.p_bi,   &in.t,      &in.dq,     &in.dp,
                   &in.dv,     &in.U,      &in.dq_dbg, &in.dp_dbg, &in.dp_dba,
                   &in.dv_dbg, &in.dv_dba, &in.bg_lin, &in.ba_lin};
  for (int k = 0; k < 19; ++k) *f[k] = static_cast<const T*>(a[k]);
  in.mask = static_cast<const uint8_t*>(a[19]);
  in.H = static_cast<T*>(H);
  in.b = static_cast<T*>(b);
  in.cost = static_cast<T*>(cost);
  return in;
}

}  // namespace

// K >= 1 frames, N >= 1 windows of that K, each array holding them one after
// another (a leading axis of N), contiguous; the mask one byte per pair.
// H (N,K,15,K,15) and b (N,K,15) are read and updated in place, cost (N,)
// written.
extern "C" int preint_gram_launch(
    const void* q, const void* p, const void* v, const void* bg,
    const void* ba, const void* q_bi, const void* p_bi, const void* t,
    const void* dq, const void* dp, const void* dv, const void* sqrt_inv_cov,
    const void* dq_dbg, const void* dp_dbg, const void* dp_dba,
    const void* dv_dbg, const void* dv_dba, const void* bg_lin,
    const void* ba_lin, const void* mask, void* H, void* b, void* cost, int K,
    int N, int is_double, void* stream) {
  const void* const a[] = {q,      p,      v,      bg,     ba,
                           q_bi,   p_bi,   t,      dq,     dp,
                           dv,     sqrt_inv_cov, dq_dbg, dp_dbg, dp_dba,
                           dv_dbg, dv_dba, bg_lin, ba_lin, mask};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) return launch(inputs<double>(a, H, b, cost), K, N, st);
  return launch(inputs<float>(a, H, b, cost), K, N, st);
}
