// K2: the reprojection block of the Gauss-Newton normal equations.
//
// Replaces the Pallas kernel xrslam_tpu/estimation/gram.py
// (reproj_gram_pallas, kernels _kernel/_col_block), which computes the
// same outputs as the einsum branch of solver.assemble. Two entries share
// the device code below:
//
//   reproj_gram_launch         the JAX signature: Cauchy-weighted r (K,L,2),
//                              Jt, Jr6 (K,L,2,6), Jd (K,L,2) and the masked
//                              anchor one-hot R1 (L,K) come from device
//                              memory;
//   reproj_factor_gram_launch  the fused entry solver.assemble takes: the
//                              residual and its 2x13 Jacobian per observation
//                              in closed form (factors.reproj_residual_jac_closed),
//                              the active mask, the Cauchy weight and the
//                              robust cost are computed in registers from the
//                              window state and data; r, Jt, Jr6, Jd and R1
//                              never reach device memory.
//
// Both form
//   P    (K,6,K,6) pose Hessian: target-target, target-anchor, its
//        transpose and anchor-anchor blocks,
//   b6   (K,6)     pose gradient,
//   Hll  (L,)      landmark diagonal,  bl (L,) landmark gradient,
//   Hfl6 (K,6,L)   frame-landmark block,
// and the fused entry also cost (), the sum of 0.5*log1p(|r|^2) over the
// active observations.
//
// What bounds it on the card: at the main path's K=12, L=384 in float64 the
// first entry reads 1.07 MB and both write 0.27 MB, and the arithmetic is
// 2-5 MFLOP: 0.4 us of memory traffic at 3.35 TB/s (0.1 us for the fused
// entry, which reads 0.13 MB) against 0.1 us of float64 arithmetic. Either
// way it is a few microseconds of launch and memory latency, so the design
// spreads one short dependent chain over the whole card and launches little.
// Tensor cores and TMA have nothing to win at 5 MFLOP in 6x6 blocks; this is
// plain CUDA-core code.
//
// What the design does:
//  - The work of one landmark follows the block structure. One warp takes one
//    landmark, lane k holds frame k's observation (K <= 32) in registers:
//    its target-target 6x6 block (21 unique entries) and gradient, its
//    target-anchor block (36, column `ref` only) and its share of the
//    anchor-anchor block are added to the warp's accumulator; the anchor's
//    part of Hfl6, Hll and bl are warp shuffles over the lanes.
//  - Landmarks are bucketed by anchor without a sort: the grid is
//    (splits, K); CTA (s, a) scans ref_idx over its slice of the landmarks,
//    32 per ballot, and its 4 warps take the landmarks anchored at frame a in
//    turn (masked landmarks, which add no anchor terms, go round the
//    columns). So a CTA's partial is one block column, K x 63 values plus
//    the 27 of the anchor-anchor block: 47 KB of shared memory at K=12 in
//    float64 and 117 KB at K=32, not the dense 6K x 6K partial (295 KB at
//    K=32).
//    splits = 132 / K, so 120-132 CTAs for any K: one for nearly every SM.
//  - Deterministic, no floating-point atomics: lanes own their accumulator
//    column, the warps of a CTA are summed in warp order, and a second kernel
//    sums the CTA partials, one warp per output element, lanes striding a
//    fixed term list and a butterfly at the end. The term list of P[a,b] and
//    P[b,a] is the same, so P is exactly symmetric. Two launches on the same
//    inputs give bit-equal outputs.
//  - The first entry reads the frame-major Jacobians 16 bytes a thread with
//    neighbouring lanes on neighbouring addresses (6 or 3 chunks per
//    observation row) and transposes them once through shared memory into
//    lane = frame order; r and Jd are one 16-byte (float: 8-byte) load a lane.
//    It derives ref_idx and the landmark mask from R1 in a first small kernel.
//  - Every output element is written by a kernel (no zero fill), a call is 2
//    launches (3 for the first entry), and nothing is allocated or
//    synchronised here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// Rows of a warp's accumulator; each row holds one value per frame lane.
constexpr int kTT = 0;      // 21: upper triangle of Jt^T Jt
constexpr int kBT = 21;     //  6: Jt^T r
constexpr int kTA = 27;     // 36: Jt^T Jr (row from Jt, column from Jr)
constexpr int kCol = 63;    // rows kept per frame in a CTA's column partial
constexpr int kRR = 63;     // 21: upper triangle of Jr^T Jr
constexpr int kBA = 84;     //  6: Jr^T r
constexpr int kAcc = 90;
constexpr int kAnchor = 27;  // RR and BA summed over the frames of a CTA

// Index of (i, j), i <= j, in the upper triangle of a 6x6 block.
__host__ __device__ constexpr int tri(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// One observation: weighted residual and Jacobian rows ([row][6]).
template <typename T>
struct Obs {
  T r[2];
  T jt[12];
  T jr[12];
  T jd[2];
};

template <typename T>
struct GramIn {  // first entry
  const T* r;
  const T* Jt;
  const T* Jr6;
  const T* Jd;
};

template <typename T>
struct FactorIn {  // fused entry
  const T* q;          // (K,4)
  const T* p;          // (K,3)
  const T* inv_depth;  // (L,)
  const T* q_bc;       // (K,4)
  const T* p_bc;       // (K,3)
  const T* bearings;   // (K,L,3)
  const uint8_t* obs_mask;  // (K,L)
  const T* w2;         // (K,2,2)
};

template <typename T>
struct GramOut {
  T* colpart;     // (K*S, 63, K)
  T* anchorpart;  // (K*S, 27)
  T* costpart;    // (K*S,), fused entry only
  T* Hll;
  T* Hfl6;
  T* bl;
};

template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---- small vector algebra of the factor stage ------------------------------

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> operator+(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> operator-(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> operator*(T s, V3<T> a) {
  return {s * a.x, s * a.y, s * a.z};
}
template <typename T>
__device__ __forceinline__ V3<T> operator/(V3<T> a, T s) {
  return {a.x / s, a.y / s, a.z / s};
}
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// lie.quat_rotate: v + qw*t + qv x t with t = 2 qv x v; q = [w, x, y, z].
template <typename T>
__device__ __forceinline__ V3<T> rot(const T* q, V3<T> v) {
  const V3<T> qv = {q[1], q[2], q[3]};
  const V3<T> t = T(2) * cross(qv, v);
  return v + q[0] * t + cross(qv, t);
}
template <typename T>
__device__ __forceinline__ V3<T> rot_inv(const T* q, V3<T> v) {
  const V3<T> qv = {-q[1], -q[2], -q[3]};
  const V3<T> t = T(2) * cross(qv, v);
  return v + q[0] * t + cross(qv, t);
}

// lie._safe_norm's unit vector: zero where the norm underflows.
template <typename T>
__device__ __forceinline__ V3<T> safe_unit(V3<T> v) {
  const T sq = dot(v, v);
  if (!(sq > T(0))) return {T(0), T(0), T(0)};
  return v / sqrt(sq);
}

// A frame's pose and camera extrinsic.
template <typename T>
struct Pose {
  T q[4];
  T p[3];
  T qc[4];
  T pc[3];
};

template <typename T>
__device__ __forceinline__ void load_pose(const FactorIn<T>& fi, int k,
                                          Pose<T>& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.q[i] = fi.q[4 * k + i];
    f.qc[i] = fi.q_bc[4 * k + i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f.p[i] = fi.p[3 * k + i];
    f.pc[i] = fi.p_bc[3 * k + i];
  }
}

template <typename T>
__device__ __forceinline__ V3<T> load_bearing(const FactorIn<T>& fi, int k,
                                              int l, int L) {
  const size_t o = static_cast<size_t>(k) * L + l;
  if (!fi.obs_mask[o]) return {T(0), T(0), T(1)};  // factors._safe_bearings
  const T* b = fi.bearings + 3 * o;
  return {b[0], b[1], b[2]};
}

template <typename T>
__device__ __forceinline__ void store_row(T* dst, V3<T> a, V3<T> b, T w) {
  dst[0] = w * a.x;
  dst[1] = w * a.y;
  dst[2] = w * a.z;
  dst[3] = w * b.x;
  dst[4] = w * b.y;
  dst[5] = w * b.z;
}

// The factor stage for (frame = lane, landmark l) anchored at the CTA's
// frame a: factors.reproj_residual_jac_closed, the active mask and
// factors.cauchy_weights. Fills the weighted observation and returns its
// robust cost; an inactive observation is all zero.
template <typename T>
__device__ __forceinline__ T factor_obs(const FactorIn<T>& fi,
                                        const Pose<T>& ft, const Pose<T>& fa,
                                        const T* w2, bool active, int lane,
                                        int a, int l, int L, Obs<T>& o) {
  o = Obs<T>{};
  if (!active) return T(0);
  T d = fi.inv_depth[l];
  if (fabs(d) < T(1e-12)) d = T(1e-12);
  const V3<T> z_ref = load_bearing(fi, a, l, L);
  const V3<T> b = load_bearing(fi, lane, l, L);
  const V3<T> pca = {fa.pc[0], fa.pc[1], fa.pc[2]};
  const V3<T> pa = {fa.p[0], fa.p[1], fa.p[2]};
  const V3<T> pt = {ft.p[0], ft.p[1], ft.p[2]};
  const V3<T> pct = {ft.pc[0], ft.pc[1], ft.pc[2]};
  const V3<T> w = rot(fa.qc, z_ref / d);
  const V3<T> av = w + pca;
  const V3<T> x = rot(fa.q, av) + pa;
  const V3<T> yc = rot_inv(ft.q, x - pt);
  const V3<T> y = rot_inv(ft.qc, yc - pct);
  // lie.s2_tangential_basis: e is the axis after the largest |b_i|
  const T ax = fabs(b.x), ay = fabs(b.y), az = fabs(b.z);
  int dmax = 0;
  T big = ax;
  if (ay > big) { dmax = 1; big = ay; }
  if (az > big) dmax = 2;
  const V3<T> e = {dmax == 2 ? T(1) : T(0), dmax == 0 ? T(1) : T(0),
                   dmax == 1 ? T(1) : T(0)};
  const V3<T> b1 = safe_unit(cross(b, e));
  const V3<T> b2 = safe_unit(cross(b, b1));
  const T u2 = dot(b, y);
  const T n0 = dot(b1, y) / u2;
  const T n1 = dot(b2, y) / u2;
  const T r0 = w2[0] * n0 + w2[1] * n1;
  const T r1 = w2[2] * n0 + w2[3] * n1;
  const V3<T> e0 = (b1 - n0 * b) / u2;
  const V3<T> e1 = (b2 - n1 * b) / u2;
  const T s = r0 * r0 + r1 * r1;
  const T wgt = sqrt(T(1) / (T(1) + s));
  const V3<T> wd = w / d;
  o.r[0] = wgt * r0;
  o.r[1] = wgt * r1;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const V3<T> h = w2[2 * row] * e0 + w2[2 * row + 1] * e1;  // dr/dy
    const V3<T> A = rot(ft.qc, h);                            // dr/dy_c
    const V3<T> G = rot(ft.q, A);                             // dr/dx
    const V3<T> Gr = rot_inv(fa.q, G);                        // dr/da
    store_row(o.jt + 6 * row, cross(A, yc), G, wgt);
    store_row(o.jr + 6 * row, cross(Gr, av), G, wgt);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o.jt[6 * row + 3 + i] = -o.jt[6 * row + 3 + i];  // dr/dp_t = -G
      o.jr[6 * row + i] = -o.jr[6 * row + i];          // dr/dth_ref = -Gr x a
    }
    o.jd[row] = -wgt * dot(Gr, wd);
  }
  return T(0.5) * log1p(s);
}

// First entry: the observation of (frame = lane, landmark l) from the
// frame-major arrays. The Jacobian rows of all K frames are read 16 bytes a
// thread in chunk order and transposed through the warp's staging buffer.
template <typename T>
__device__ __forceinline__ void load_obs(const GramIn<T>& gi, T* stage,
                                         bool lane_on, int lane, int l, int K,
                                         int L, Obs<T>& o) {
  constexpr int kChunks = 12 * sizeof(T) / 16;  // per (frame, landmark) row
  const int4* gJt = reinterpret_cast<const int4*>(gi.Jt);
  const int4* gJr = reinterpret_cast<const int4*>(gi.Jr6);
  int4* sJt = reinterpret_cast<int4*>(stage);
  int4* sJr = sJt + K * kChunks;
  for (int idx = lane; idx < K * kChunks; idx += 32) {
    const int k = idx / kChunks, c = idx - k * kChunks;
    const size_t src = (static_cast<size_t>(k) * L + l) * kChunks + c;
    sJt[idx] = gJt[src];
    sJr[idx] = gJr[src];
  }
  __syncwarp();
  o = Obs<T>{};
  if (lane_on) {
    using P2 = typename Pair<T>::type;
    const size_t kl = static_cast<size_t>(lane) * L + l;
    const P2 rv = reinterpret_cast<const P2*>(gi.r)[kl];
    const P2 dv = reinterpret_cast<const P2*>(gi.Jd)[kl];
    o.r[0] = rv.x;
    o.r[1] = rv.y;
    o.jd[0] = dv.x;
    o.jd[1] = dv.y;
    const T* jt = stage + 12 * lane;
    const T* jr = stage + 12 * (K + lane);
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      o.jt[i] = jt[i];
      o.jr[i] = jr[i];
    }
  }
  __syncwarp();  // the staging buffer is free for the next landmark
}

// The Gram stage of one landmark, shared by both entries. `acc` is the
// warp's accumulator ([kAcc][K]); lane k touches column k only.
template <typename T>
__device__ __forceinline__ void gram_landmark(const Obs<T>& o, bool lane_on,
                                              bool ok, int ref, int lane,
                                              int K, int L, int l, T* acc,
                                              const GramOut<T>& out) {
  T red[8] = {};  // Jr^T Jd (6), Jd.Jd, Jd.r: summed over the frames
  if (lane_on) {
    T* a = acc + lane;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j)
        a[(kTT + tri(i, j)) * K] +=
            o.jt[i] * o.jt[j] + o.jt[6 + i] * o.jt[6 + j];
      a[(kBT + i) * K] += o.jt[i] * o.r[0] + o.jt[6 + i] * o.r[1];
    }
    if (ok) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 6; ++j)
          a[(kTA + 6 * i + j) * K] +=
              o.jt[i] * o.jr[j] + o.jt[6 + i] * o.jr[6 + j];
#pragma unroll
        for (int j = i; j < 6; ++j)
          a[(kRR + tri(i, j)) * K] +=
              o.jr[i] * o.jr[j] + o.jr[6 + i] * o.jr[6 + j];
        a[(kBA + i) * K] += o.jr[i] * o.r[0] + o.jr[6 + i] * o.r[1];
        red[i] = o.jr[i] * o.jd[0] + o.jr[6 + i] * o.jd[1];
      }
    }
    red[6] = o.jd[0] * o.jd[0] + o.jd[1] * o.jd[1];
    red[7] = o.jd[0] * o.r[0] + o.jd[1] * o.r[1];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[i] = warp_sum(red[i]);
  if (lane_on) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T v = o.jt[i] * o.jd[0] + o.jt[6 + i] * o.jd[1];
      if (lane == ref) v += red[i];
      out.Hfl6[(static_cast<size_t>(lane) * 6 + i) * L + l] = v;
    }
  }
  if (lane == 0) {
    out.Hll[l] = red[6];
    out.bl[l] = red[7];
  }
}

// CTA (s, a): the landmarks of slice s anchored at frame a. A masked
// landmark adds no anchor terms, so any column can take it: landmark l goes
// to column l % K, which spreads the empty slots of a window over the grid.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
gram_main_kernel(GramIn<T> gi, FactorIn<T> fi,
                 const int* __restrict__ ref_idx,
                 const uint8_t* __restrict__ lm_mask, GramOut<T> out, int K,
                 int L, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double wcost[kWarps];
  T* acc_all = reinterpret_cast<T*>(smem_raw);  // [kWarps][kAcc][K]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = gridDim.x, s = blockIdx.x, a = blockIdx.y;
  T* acc = acc_all + warp * kAcc * K;
  for (int e = lane; e < kAcc * K; e += 32) acc[e] = T(0);
  __syncwarp();
  const bool lane_on = lane < K;

  Pose<T> ft, fa;
  T w2[4];
  T cost = T(0);
  if constexpr (kFused) {
    const int k = lane_on ? lane : 0;
    load_pose(fi, k, ft);
    load_pose(fi, a, fa);
#pragma unroll
    for (int i = 0; i < 4; ++i) w2[i] = fi.w2[4 * k + i];
  }

  const int l_begin = s * chunk;
  const int l_end = min(L, l_begin + chunk);
  int seen = 0;
  for (int base = l_begin; base < l_end; base += 32) {
    const int lq = base + lane;
    bool okq = false, mine = false;
    if (lq < l_end) {
      const int rq = ref_idx[lq];
      okq = lm_mask[lq] != 0 &&
            static_cast<unsigned>(rq) < static_cast<unsigned>(K);
      mine = (okq ? rq : lq % K) == a;
    }
    unsigned todo = __ballot_sync(kFull, mine);
    const unsigned okm = __ballot_sync(kFull, okq);
    while (todo) {  // uniform across the warp
      const int bit = __ffs(todo) - 1;
      todo &= todo - 1;
      if (seen++ % kWarps != warp) continue;
      const int l = base + bit;
      const bool ok = (okm >> bit) & 1u;
      Obs<T> o;
      if constexpr (kFused) {
        if (!ok) {  // no active observation: only its outputs, all zero
          if (lane_on) {
#pragma unroll
            for (int i = 0; i < 6; ++i)
              out.Hfl6[(static_cast<size_t>(lane) * 6 + i) * L + l] = T(0);
          }
          if (lane == 0) out.Hll[l] = out.bl[l] = T(0);
          continue;
        }
        const bool active =
            lane_on && ok && lane != a &&
            fi.obs_mask[static_cast<size_t>(lane) * L + l] != 0;
        cost += factor_obs(fi, ft, fa, w2, active, lane, a, l, L, o);
      } else {
        T* stage = acc_all + kWarps * kAcc * K + warp * 24 * K;
        load_obs(gi, stage, lane_on, lane, l, K, L, o);
      }
      gram_landmark(o, lane_on, ok, a, lane, K, L, l, acc, out);
    }
  }

  if constexpr (kFused) {
    cost = warp_sum(cost);
    if (lane == 0) wcost[warp] = static_cast<double>(cost);
  }
  __syncthreads();
  // the CTA's partial: its warps summed in warp order
  const size_t cta = static_cast<size_t>(a) * S + s;
  T* col = out.colpart + cta * kCol * K;
  for (int e = threadIdx.x; e < kCol * K; e += kThreads) {
    T v = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += acc_all[w * kAcc * K + e];
    col[e] = v;
  }
  if (threadIdx.x < kAnchor) {
    T v = T(0);
    for (int w = 0; w < kWarps; ++w)
      for (int k = 0; k < K; ++k)
        v += acc_all[w * kAcc * K + (kCol + threadIdx.x) * K + k];
    out.anchorpart[cta * kAnchor + threadIdx.x] = v;
  }
  if constexpr (kFused) {
    if (threadIdx.x == 0) {
      double c = 0.0;
      for (int w = 0; w < kWarps; ++w) c += wcost[w];
      out.costpart[cta] = static_cast<T>(c);
    }
  }
}

// Sums the CTA partials: one warp per element of P, b6 and cost. The lanes
// stride a fixed list of terms and end in a butterfly, so the order is fixed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const T* __restrict__ colpart,
                   const T* __restrict__ anchorpart,
                   const T* __restrict__ costpart, T* __restrict__ P,
                   T* __restrict__ b6, T* __restrict__ cost, int K, int S) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int N6 = 6 * K, NP = N6 * N6, KS = K * S;
  const int n_out = NP + N6 + (costpart != nullptr ? 1 : 0);
  if (o >= n_out) return;  // the whole warp
  const size_t cstride = static_cast<size_t>(kCol) * K;
  T v = T(0);
  if (o < NP) {
    int row = o / N6, colm = o - (o / N6) * N6;
    if (row > colm) {  // P[a,b] and P[b,a] take the same terms
      const int t = row;
      row = colm;
      colm = t;
    }
    const int m = row / 6, i = row - 6 * m, n = colm / 6, j = colm - 6 * n;
    const int nterms = 2 * S + (m == n ? S + KS : 0);
    for (int t = lane; t < nterms; t += 32) {
      if (t < S)  // target m anchored at n
        v += colpart[(static_cast<size_t>(n) * S + t) * cstride +
                     (kTA + 6 * i + j) * K + m];
      else if (t < 2 * S)  // target n anchored at m, transposed
        v += colpart[(static_cast<size_t>(m) * S + (t - S)) * cstride +
                     (kTA + 6 * j + i) * K + n];
      else if (t < 3 * S)  // anchor-anchor block of frame m
        v += anchorpart[(static_cast<size_t>(m) * S + (t - 2 * S)) * kAnchor +
                        tri(i, j)];
      else  // target-target block of frame m, from every CTA
        v += colpart[static_cast<size_t>(t - 3 * S) * cstride +
                     (kTT + tri(i, j)) * K + m];
    }
  } else if (o < NP + N6) {
    const int f = o - NP, m = f / 6, i = f - 6 * m;
    for (int t = lane; t < KS + S; t += 32) {
      if (t < KS)
        v += colpart[static_cast<size_t>(t) * cstride + (kBT + i) * K + m];
      else
        v += anchorpart[(static_cast<size_t>(m) * S + (t - KS)) * kAnchor +
                        (kBA - kCol) + i];
    }
  } else {
    for (int t = lane; t < KS; t += 32) v += costpart[t];
  }
  v = warp_sum(v);
  if (lane == 0) {
    if (o < NP)
      P[o] = v;
    else if (o < NP + N6)
      b6[o - NP] = v;
    else
      cost[0] = v;
  }
}

// First entry only: each landmark's anchor (first largest entry of its R1
// row, as torch.argmax) and whether the row has a nonzero entry.
template <typename T>
__global__ void onehot_ref_kernel(const T* __restrict__ R1,
                                  int* __restrict__ ref_idx,
                                  uint8_t* __restrict__ lm_mask, int K,
                                  int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const T* row = R1 + static_cast<size_t>(l) * K;
  T best = row[0];
  int arg = 0;
  bool any = row[0] != T(0);
  for (int k = 1; k < K; ++k) {
    const T v = row[k];
    if (v > best) {
      best = v;
      arg = k;
    }
    any = any || v != T(0);
  }
  ref_idx[l] = arg;
  lm_mask[l] = any ? 1 : 0;
}

template <typename T, bool kFused>
cudaError_t launch_stages(const GramIn<T>& gi, const FactorIn<T>& fi,
                          const int* ref_idx, const uint8_t* lm_mask,
                          const GramOut<T>& out, T* P, T* b6, T* cost, int K,
                          int L, int S, cudaStream_t stream) {
  const int chunk = (L + S - 1) / S;
  const size_t smem =
      sizeof(T) * static_cast<size_t>(kWarps) * (kAcc + (kFused ? 0 : 24)) * K;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gram_main_kernel<T, kFused>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  gram_main_kernel<T, kFused><<<dim3(S, K), kThreads, smem, stream>>>(
      gi, fi, ref_idx, lm_mask, out, K, L, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n_out = 36 * K * K + 6 * K + (kFused ? 1 : 0);
  gram_reduce_kernel<T><<<(n_out + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      out.colpart, out.anchorpart, kFused ? out.costpart : nullptr, P, b6,
      cost, K, S);
  return cudaGetLastError();
}

template <typename T>
int launch_gram(const void* r, const void* Jt, const void* Jr6, const void* Jd,
                const void* R1, void* ref_idx, void* lm_mask, void* colpart,
                void* anchorpart, void* P, void* b6, void* Hll, void* Hfl6,
                void* bl, int K, int L, int S, cudaStream_t stream) {
  if (L > 0) {
    onehot_ref_kernel<T><<<(L + 127) / 128, 128, 0, stream>>>(
        static_cast<const T*>(R1), static_cast<int*>(ref_idx),
        static_cast<uint8_t*>(lm_mask), K, L);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const GramIn<T> gi = {static_cast<const T*>(r), static_cast<const T*>(Jt),
                        static_cast<const T*>(Jr6), static_cast<const T*>(Jd)};
  const GramOut<T> out = {static_cast<T*>(colpart),
                          static_cast<T*>(anchorpart), nullptr,
                          static_cast<T*>(Hll), static_cast<T*>(Hfl6),
                          static_cast<T*>(bl)};
  return static_cast<int>(launch_stages<T, false>(
      gi, FactorIn<T>{}, static_cast<const int*>(ref_idx),
      static_cast<const uint8_t*>(lm_mask), out, static_cast<T*>(P),
      static_cast<T*>(b6), nullptr, K, L, S, stream));
}

template <typename T>
int launch_factor_gram(const void* q, const void* p, const void* inv_depth,
                       const void* q_bc, const void* p_bc,
                       const void* bearings, const void* obs_mask,
                       const void* ref_idx, const void* w2,
                       const void* lm_mask, void* colpart, void* anchorpart,
                       void* costpart, void* P, void* b6, void* Hll,
                       void* Hfl6, void* bl, void* cost, int K, int L, int S,
                       cudaStream_t stream) {
  const FactorIn<T> fi = {
      static_cast<const T*>(q),        static_cast<const T*>(p),
      static_cast<const T*>(inv_depth), static_cast<const T*>(q_bc),
      static_cast<const T*>(p_bc),     static_cast<const T*>(bearings),
      static_cast<const uint8_t*>(obs_mask), static_cast<const T*>(w2)};
  const GramOut<T> out = {static_cast<T*>(colpart),
                          static_cast<T*>(anchorpart),
                          static_cast<T*>(costpart), static_cast<T*>(Hll),
                          static_cast<T*>(Hfl6), static_cast<T*>(bl)};
  return static_cast<int>(launch_stages<T, true>(
      GramIn<T>{}, fi, static_cast<const int*>(ref_idx),
      static_cast<const uint8_t*>(lm_mask), out, static_cast<T*>(P),
      static_cast<T*>(b6), static_cast<T*>(cost), K, L, S, stream));
}

}  // namespace

// Both entries: K <= 32 frames, S CTAs per anchor frame (the caller sized
// colpart (K*S,63,K), anchorpart (K*S,27) and costpart (K*S,) for it), every
// array contiguous and 16-byte aligned. ref_idx is int32, the masks one byte
// per element.
extern "C" int reproj_gram_launch(const void* r, const void* Jt,
                                  const void* Jr6, const void* Jd,
                                  const void* R1, void* ref_idx,
                                  void* lm_mask, void* colpart,
                                  void* anchorpart, void* P, void* b6,
                                  void* Hll, void* Hfl6, void* bl, int K,
                                  int L, int S, int is_double, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_gram<double>(r, Jt, Jr6, Jd, R1, ref_idx, lm_mask, colpart,
                               anchorpart, P, b6, Hll, Hfl6, bl, K, L, S, st);
  return launch_gram<float>(r, Jt, Jr6, Jd, R1, ref_idx, lm_mask, colpart,
                            anchorpart, P, b6, Hll, Hfl6, bl, K, L, S, st);
}

extern "C" int reproj_factor_gram_launch(
    const void* q, const void* p, const void* inv_depth, const void* q_bc,
    const void* p_bc, const void* bearings, const void* obs_mask,
    const void* ref_idx, const void* w2, const void* lm_mask, void* colpart,
    void* anchorpart, void* costpart, void* P, void* b6, void* Hll,
    void* Hfl6, void* bl, void* cost, int K, int L, int S, int is_double,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_factor_gram<double>(q, p, inv_depth, q_bc, p_bc, bearings,
                                      obs_mask, ref_idx, w2, lm_mask, colpart,
                                      anchorpart, costpart, P, b6, Hll, Hfl6,
                                      bl, cost, K, L, S, st);
  return launch_factor_gram<float>(q, p, inv_depth, q_bc, p_bc, bearings,
                                   obs_mask, ref_idx, w2, lm_mask, colpart,
                                   anchorpart, costpart, P, b6, Hll, Hfl6, bl,
                                   cost, K, L, S, st);
}
