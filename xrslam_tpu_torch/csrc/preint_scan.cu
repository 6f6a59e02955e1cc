// K4: IMU preintegration, the whole sample recurrence of a batch of
// intervals in one launch.
//
// Replaces no Pallas kernel. It replaces the port's Python loop over the
// samples (imu/preintegration.integrate_batch_plain, the counterpart of the
// JAX package's lax.scan in xrslam_tpu/imu/preintegration.py:191): one
// _increment a sample, some 440 ATen operations (about 280 kernels on the
// card) for a few intervals of 15x15 covariance.
//
// Each interval n steps through the call's first `steps` samples, as the
// loop does, from the identity delta. Sample s covers dt_s (sample_dts: to
// the next sample, the last valid one to t_end; 0 from `count` on, where the
// step still runs and renormalizes q). A step, in the loop's order:
//   w = w_s - bg, a = a_s - ba, dq = exp(w dt), R = R(q), Rhat = R [a]x,
//   P9 <- (A P9) A^T + (B W) B^T with
//     A = [[R(dq)^T, 0, 0], [-dt^2/2 Rhat, I, dt I], [-dt Rhat, 0, I]],
//     B = [[dt Jr(w dt), 0], [0, dt^2/2 R], [0, dt R]],
//     W = diag(cov_w, cov_a) / max(dt, 1e-7);
//   the bias blocks += cov_bg dt, cov_ba dt; the bias Jacobians' recurrences;
//   p += dt v + dt^2/2 R a, v += dt R a, q <- normalize(q dq), t += dt.
// Only the order of the small products' sums differs from the loop.
//
// What bounds it on the card: nothing of the card's rates. A step reads 7
// numbers of an interval and does about 3 kFLOP, so a call at the main
// path's 12 intervals x 132 steps reads 90 KB and computes 5 MFLOP. The
// recurrence is serial in the samples: the kernel is latency-bound, its floor
// `steps` x the dependent chain of one step. The design shortens that chain:
//  - One warp per interval (grid N, 32 threads a CTA); the samples go in
//    chunks of 32.
//  - Everything that does not depend on the recurrence is computed off its
//    chain, one lane per sample of the chunk: the sample's dt, dq, R(dq)^T
//    and Jr with their transcendentals (phase A). The quaternion chain, the
//    only serial part that the rest of a step reads, runs on lane 0 alone
//    (phase B: q, and p, v, t beside it). Then each lane builds its sample's
//    A blocks, B blocks and the 5 non-zero 3x3 blocks of B W B^T (phase C).
//  - What is left on the chain per step (phase D): the 81 entries of A P9,
//    then of (A P9) A^T + B W B^T, three entries a lane, each a dot product of
//    the five non-zero terms of its row of A, with P9 in shared memory and
//    __syncwarp between the two; the bias Jacobians' columns in the
//    registers of lanes 0-2 (d./dbg) and 3-11 (d./dba, the bias blocks).
//  - Samples are read from global memory as the chunk needs them, so the
//    buffer's capacity (up to 2,048 samples) costs nothing.
//  - Deterministic: no atomics, each output written by one lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lie.cuh"

namespace {

constexpr int kChunk = 32;  // samples a chunk, one lane each

// shared memory of the warp: per sample of the chunk, then P9 and A P9
constexpr int kDt = 0;                     // dt            [kChunk]
constexpr int kDq = kDt + kChunk;          // exp(w dt)     [kChunk][4]
constexpr int kA = kDq + 4 * kChunk;       // a = a_s - ba  [kChunk][3]
constexpr int kQ = kA + 3 * kChunk;        // q before      [kChunk][4]
constexpr int kRst = kQ + 4 * kChunk;      // R(dq)^T       [kChunk][9]
constexpr int kX = kRst + 9 * kChunk;      // -dt^2/2 Rhat
constexpr int kY = kX + 9 * kChunk;        // -dt Rhat
constexpr int kBq = kY + 9 * kChunk;       // dt Jr
constexpr int kBp = kBq + 9 * kChunk;      // dt^2/2 R
constexpr int kBv = kBp + 9 * kChunk;      // dt R
constexpr int kQw = kBv + 9 * kChunk;      // B W B^T blocks [kChunk][45]
constexpr int kP = kQw + 45 * kChunk;      // P9 [81]
constexpr int kT = kP + 81;                // A P9 [81]
constexpr int kShared = kT + 81;

// B W B^T's non-zero 3x3 blocks (block row, block column) -> slot in kQw;
// -1: a zero block
__device__ __forceinline__ int qw_slot(int br, int bc) {
  if (br == 0) return bc == 0 ? 0 : -1;
  return bc == 0 ? -1 : 2 * br + bc - 2;  // (1,1) 1, (1,2) 2, (2,1) 3, (2,2) 4
}

// Row i of A's block row br, as its five non-zero terms: m[0..2] at columns
// 0-2, alpha at column 3 + i, beta at column 6 + i.
template <typename T>
__device__ __forceinline__ void a_row(const T* sm, int k, int br, int i, T dt, const T*& m,
                                      T& alpha, T& beta) {
  m = sm + (br == 0 ? kRst : br == 1 ? kX : kY) + 9 * k + 3 * i;
  alpha = br == 1 ? T(1) : T(0);
  beta = br == 1 ? dt : br == 2 ? T(1) : T(0);
}

template <typename T>
__global__ void __launch_bounds__(32)
preint_scan_kernel(const T* __restrict__ ts, const T* __restrict__ ws,
                   const T* __restrict__ accs, const T* __restrict__ t_end,
                   const T* __restrict__ bg, const T* __restrict__ ba,
                   const long long* __restrict__ count, const T* __restrict__ cov_w,
                   const T* __restrict__ cov_a, const T* __restrict__ cov_bg,
                   const T* __restrict__ cov_ba, T* __restrict__ out, int N, int S,
                   int steps) {
  __shared__ T sm[kShared];
  const int n = blockIdx.x, lane = threadIdx.x;
  ts += static_cast<size_t>(n) * S;
  ws += static_cast<size_t>(n) * S * 3;
  accs += static_cast<size_t>(n) * S * 3;
  const long long cnt = count[n];
  const T te = t_end[n];
  T bgv[3], bav[3];
  load<T, 3>(bg + 3 * n, bgv);
  load<T, 3>(ba + 3 * n, bav);

  for (int e = lane; e < 81; e += 32) sm[kP + e] = T(0);
  // lane 0: t, q, p, v; lanes 0-2: column `lane` of dq_dbg, dp_dbg, dv_dbg;
  // lanes 3-11: entry lane - 3 of dp_dba, dv_dba and of the bias blocks
  T t = 0, q[4] = {T(1), T(0), T(0), T(0)}, p[3] = {0, 0, 0}, v[3] = {0, 0, 0};
  T jq[3] = {0, 0, 0}, jp[3] = {0, 0, 0}, jv[3] = {0, 0, 0};
  T pa = 0, va = 0, pbg = 0, pba = 0;
  const int e9 = lane - 3;
  const T cbg = e9 >= 0 && e9 < 9 ? cov_bg[e9] : T(0);
  const T cba = e9 >= 0 && e9 < 9 ? cov_ba[e9] : T(0);

  for (int s0 = 0; s0 < steps; s0 += kChunk) {
    const int kc = min(kChunk, steps - s0);
    // phase A: lane k takes sample s0 + k
    const int k = lane, s = s0 + lane;
    T dt = 0, inv_dt = 0, a[3] = {0, 0, 0}, Rst[9], Jr[9];
    if (k < kc) {
      const T ts_s = ts[s];
      const T t_next = s + 1 < S ? ts[s + 1] : ts[S - 1];
      const T d = s == cnt - 1 ? te - ts_s : t_next - ts_s;
      dt = s < cnt ? (d < T(0) ? T(0) : d) : T(0);
      T phi[3], dq[4], R[9];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a[c] = accs[3 * s + c] - bav[c];
        phi[c] = (ws[3 * s + c] - bgv[c]) * dt;
      }
      expmap(phi, dq);
      qmat(dq, R);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) Rst[3 * r + c] = R[3 * c + r];
      right_jacobian<T, false>(phi, Jr);
      inv_dt = T(1) / (dt < T(1e-7) ? T(1e-7) : dt);
      sm[kDt + k] = dt;
#pragma unroll
      for (int c = 0; c < 4; ++c) sm[kDq + 4 * k + c] = dq[c];
#pragma unroll
      for (int c = 0; c < 3; ++c) sm[kA + 3 * k + c] = a[c];
    }
    __syncwarp();
    // phase B: the quaternion chain, and p, v, t beside it
    if (lane == 0) {
      for (int j = 0; j < kc; ++j) {
        const T dtj = sm[kDt + j];
        T aw[3], qn[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) sm[kQ + 4 * j + c] = q[c];
        rot(q, sm + kA + 3 * j, aw);
        const T h = T(0.5) * dtj * dtj;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          p[c] = p[c] + dtj * v[c] + h * aw[c];
          v[c] = v[c] + dtj * aw[c];
        }
        qmul(q, sm + kDq + 4 * j, qn);
        qnormalize(qn);
        load<T, 4>(qn, q);
        t = t + dtj;
      }
    }
    __syncwarp();
    // phase C: lane k builds sample s0 + k's blocks of A, B and B W B^T
    if (k < kc) {
      T R[9], Ha[9], Rhat[9];
      qmat(sm + kQ + 4 * k, R);
      hat(a, Ha);
      mm<T, false, false>(R, Ha, Rhat);
      const T hn = T(-0.5) * dt * dt, h = T(0.5) * dt * dt;
      T Bq[9], Bp[9], Bv[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        sm[kRst + 9 * k + e] = Rst[e];
        sm[kX + 9 * k + e] = hn * Rhat[e];
        sm[kY + 9 * k + e] = -dt * Rhat[e];
        Bq[e] = dt * Jr[e];
        Bp[e] = h * R[e];
        Bv[e] = dt * R[e];
        sm[kBq + 9 * k + e] = Bq[e];
        sm[kBp + 9 * k + e] = Bp[e];
        sm[kBv + 9 * k + e] = Bv[e];
      }
      T Cw[9], Ca[9], BW[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        Cw[e] = cov_w[e] * inv_dt;
        Ca[e] = cov_a[e] * inv_dt;
      }
      T* Qw = sm + kQw + 45 * k;
      mm<T, false, false>(Bq, Cw, BW);
      mm<T, false, true>(BW, Bq, Qw);           // (0, 0)
      mm<T, false, false>(Bp, Ca, BW);
      mm<T, false, true>(BW, Bp, Qw + 9);       // (1, 1)
      mm<T, false, true>(BW, Bv, Qw + 18);      // (1, 2)
      mm<T, false, false>(Bv, Ca, BW);
      mm<T, false, true>(BW, Bp, Qw + 27);      // (2, 1)
      mm<T, false, true>(BW, Bv, Qw + 36);      // (2, 2)
    }
    __syncwarp();
    // phase D: the covariance and the bias Jacobians, sample by sample
    for (int j = 0; j < kc; ++j) {
      const T dtj = sm[kDt + j];
      const T* P = sm + kP;
      T* Tm = sm + kT;
      for (int e = lane; e < 81; e += 32) {
        const int r = e / 9, c = e % 9;
        const T* m;
        T al, be;
        a_row(sm, j, r / 3, r % 3, dtj, m, al, be);
        const int i = r % 3;
        Tm[e] = m[0] * P[c] + m[1] * P[9 + c] + m[2] * P[18 + c] + al * P[9 * (3 + i) + c] +
                be * P[9 * (6 + i) + c];
      }
      if (lane < 3) {
        const T* X = sm + kX + 9 * j;
        const T* Y = sm + kY + 9 * j;
        const T* Rs = sm + kRst + 9 * j;
        const T* Bq = sm + kBq + 9 * j;
        T xq[3], yq[3], rq[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          xq[r] = X[3 * r] * jq[0] + X[3 * r + 1] * jq[1] + X[3 * r + 2] * jq[2];
          yq[r] = Y[3 * r] * jq[0] + Y[3 * r + 1] * jq[1] + Y[3 * r + 2] * jq[2];
          rq[r] = Rs[3 * r] * jq[0] + Rs[3 * r + 1] * jq[1] + Rs[3 * r + 2] * jq[2];
        }
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          jp[r] = jp[r] + dtj * jv[r] + xq[r];
          jv[r] = jv[r] + yq[r];
          jq[r] = rq[r] - Bq[3 * r + lane];
        }
      } else if (e9 < 9) {
        pa = pa + dtj * va - sm[kBp + 9 * j + e9];
        va = va - sm[kBv + 9 * j + e9];
        pbg = pbg + cbg * dtj;
        pba = pba + cba * dtj;
      }
      __syncwarp();
      T* Pw = sm + kP;
      const T* Qw = sm + kQw + 45 * j;
      for (int e = lane; e < 81; e += 32) {
        const int r = e / 9, c = e % 9, bc = c / 3, jc = c % 3;
        const T* m;
        T al, be;
        a_row(sm, j, bc, jc, dtj, m, al, be);
        const T* tr = Tm + 9 * r;
        const int slot = qw_slot(r / 3, bc);
        const T qv = slot < 0 ? T(0) : Qw[9 * slot + 3 * (r % 3) + jc];
        Pw[e] = tr[0] * m[0] + tr[1] * m[1] + tr[2] * m[2] + al * tr[3 + jc] +
                be * tr[6 + jc] + qv;
      }
      __syncwarp();
    }
  }

  // the delta, field after field (PreintDelta's order), N intervals each
  T* o_t = out;
  T* o_q = out + N;
  T* o_p = out + 5 * static_cast<size_t>(N);
  T* o_v = out + 8 * static_cast<size_t>(N);
  T* o_cov = out + 11 * static_cast<size_t>(N) + 225 * static_cast<size_t>(n);
  T* o_sqrt = out + 236 * static_cast<size_t>(N) + 225 * static_cast<size_t>(n);
  T* o_jac = out + 461 * static_cast<size_t>(N) + 9 * static_cast<size_t>(n);
  const size_t jac_stride = 9 * static_cast<size_t>(N);  // dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba
  if (lane == 0) {
    o_t[n] = t;
#pragma unroll
    for (int c = 0; c < 4; ++c) o_q[4 * n + c] = q[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o_p[3 * n + c] = p[c];
      o_v[3 * n + c] = v[c];
    }
  }
  T* bias = sm + kT;  // the bias blocks, for the covariance's writers
  if (lane < 3) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      o_jac[3 * r + lane] = jq[r];
      o_jac[jac_stride + 3 * r + lane] = jp[r];
      o_jac[3 * jac_stride + 3 * r + lane] = jv[r];
    }
  } else if (e9 < 9) {
    o_jac[2 * jac_stride + e9] = pa;
    o_jac[4 * jac_stride + e9] = va;
    bias[e9] = pbg;
    bias[9 + e9] = pba;
  }
  __syncwarp();
  for (int e = lane; e < 225; e += 32) {
    const int r = e / 15, c = e % 15;
    T x = T(0);
    if (r < 9 && c < 9) {
      x = sm[kP + 9 * r + c];
    } else if (r >= 9 && c >= 9 && (r < 12) == (c < 12)) {
      x = bias[(r < 12 ? 0 : 9) + 3 * ((r - 9) % 3) + (c - 9) % 3];
    }
    o_cov[e] = x;
    o_sqrt[e] = T(0);
  }
}

template <typename T>
int launch(const void* const* a, void* out, int N, int S, int steps, cudaStream_t stream) {
  preint_scan_kernel<T><<<N, 32, 0, stream>>>(
      static_cast<const T*>(a[0]), static_cast<const T*>(a[1]), static_cast<const T*>(a[2]),
      static_cast<const T*>(a[3]), static_cast<const T*>(a[4]), static_cast<const T*>(a[5]),
      static_cast<const long long*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<const T*>(a[8]), static_cast<const T*>(a[9]),
      static_cast<const T*>(a[10]), static_cast<T*>(out), N, S, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// N >= 1 intervals of S >= 1 sample slots each, contiguous: ts (N,S),
// ws/accs (N,S,3), t_end (N,), bg/ba (N,3), count (N,) int64, the four
// noise covariances (3,3); 0 <= steps <= S. `out` (506 N values) receives
// t (N), q (N,4), p, v (N,3), cov (N,15,15), sqrt_inv_cov (N,15,15) as
// zeros, dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba (N,3,3), one after another.
extern "C" int preint_scan_launch(const void* ts, const void* ws, const void* accs,
                                  const void* t_end, const void* bg, const void* ba,
                                  const void* count, const void* cov_w, const void* cov_a,
                                  const void* cov_bg, const void* cov_ba, void* out, int N,
                                  int S, int steps, int is_double, void* stream) {
  const void* const a[] = {ts, ws, accs, t_end, bg, ba, count, cov_w, cov_a, cov_bg, cov_ba};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) return launch<double>(a, out, N, S, steps, st);
  return launch<float>(a, out, N, S, steps, st);
}
