// Small vector algebra on the device, the functions of geometry/lie.py, for
// the kernels that need them (preint_gram.cu, preint_scan.cu).
// 3x3 matrices row-major in T[9], quaternions [w, x, y, z].
#pragma once

namespace {

template <typename T, int n>
__device__ __forceinline__ void load(const T* src, T* dst) {
#pragma unroll
  for (int e = 0; e < n; ++e) dst[e] = src[e];
}

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// lie.quat_rotate: v + qw*t + qv x t with t = 2 qv x v.
template <typename T>
__device__ __forceinline__ void rot(const T* q, const T* v, T* out) {
  T t[3], u[3];
  cross(q + 1, v, t);
#pragma unroll
  for (int c = 0; c < 3; ++c) t[c] *= T(2);
  cross(q + 1, t, u);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = v[c] + q[0] * t[c] + u[c];
}

template <typename T>
__device__ __forceinline__ void qmul(const T* a, const T* b, T* c) {
  c[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  c[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  c[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  c[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

template <typename T>
__device__ __forceinline__ void qconj(const T* a, T* c) {
  c[0] = a[0];
  c[1] = -a[1];
  c[2] = -a[2];
  c[3] = -a[3];
}

// lie.quat_normalize: q / |q|, left as it is where |q| is 0.
template <typename T>
__device__ __forceinline__ void qnormalize(T* q) {
  const T sq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const T n = sq > T(0) ? sqrt(sq) : T(0);
  const T d = n > T(0) ? n : T(1);
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = q[c] / d;
}

// lie.quat_to_matrix
template <typename T>
__device__ __forceinline__ void qmat(const T* q, T* R) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1 - 2 * (yy + zz);
  R[1] = 2 * (xy - wz);
  R[2] = 2 * (xz + wy);
  R[3] = 2 * (xy + wz);
  R[4] = 1 - 2 * (xx + zz);
  R[5] = 2 * (yz - wx);
  R[6] = 2 * (xz - wy);
  R[7] = 2 * (yz + wx);
  R[8] = 1 - 2 * (xx + yy);
}

// C = op(A) * op(B), with ta / tb transposing A / B.
template <typename T, bool ta, bool tb>
__device__ __forceinline__ void mm(const T* A, const T* B, T* C) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T s = 0;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        s += (ta ? A[3 * k + r] : A[3 * r + k]) * (tb ? B[3 * c + k] : B[3 * k + c]);
      C[3 * r + c] = s;
    }
}

// y = op(A) * x
template <typename T, bool ta>
__device__ __forceinline__ void mv(const T* A, const T* x, T* y) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    T s = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) s += (ta ? A[3 * k + r] : A[3 * r + k]) * x[k];
    y[r] = s;
  }
}

template <typename T>
__device__ __forceinline__ void hat(const T* w, T* H) {
  H[0] = 0;
  H[1] = -w[2];
  H[2] = w[1];
  H[3] = w[2];
  H[4] = 0;
  H[5] = -w[0];
  H[6] = -w[1];
  H[7] = w[0];
  H[8] = 0;
}

template <typename T>
__device__ __forceinline__ T norm3(const T* w) {
  const T sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  return sq > T(0) ? sqrt(sq) : T(0);
}

constexpr double kSmallAngle = 1e-3;  // lie._SMALL_ANGLE

// lie.expmap
template <typename T>
__device__ __forceinline__ void expmap(const T* w, T* q) {
  const T angle = norm3(w);
  const T half = T(0.5) * angle;
  const T h2 = half * half;
  const T sinc = angle > T(kSmallAngle) ? sin(half) / half
                                        : T(1) - h2 / T(6) + h2 * h2 / T(120);
  q[0] = cos(half);
#pragma unroll
  for (int c = 0; c < 3; ++c) q[c + 1] = T(0.5) * sinc * w[c];
}

// lie.logmap: the angle in [0, pi]
template <typename T>
__device__ __forceinline__ void logmap(const T* q_in, T* out) {
  const T s = q_in[0] < T(0) ? T(-1) : T(1);
  const T q[4] = {s * q_in[0], s * q_in[1], s * q_in[2], s * q_in[3]};
  const T vnorm = norm3(q + 1);
  const T w = fmin(fmax(q[0], T(-1)), T(1));
  T factor;
  if (vnorm <= T(kSmallAngle)) {
    const T ws = w > T(0) ? w : T(1);
    const T ws2 = w > T(0) ? w * w : T(1);
    factor = T(2) / ws * (T(1) - vnorm * vnorm / (T(3) * ws2));
  } else {
    factor = T(2) * atan2(vnorm, w) / vnorm;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = factor * q[c + 1];
}

// lie.right_jacobian (inv = false) and lie.right_jacobian_inv (inv = true):
// I + a*[w]x + b*[w]x^2.
template <typename T, bool inv>
__device__ __forceinline__ void right_jacobian(const T* w, T* J) {
  const T angle = norm3(w);
  const T a2 = angle * angle;
  const bool small = angle <= T(kSmallAngle);
  T a, b;
  if (inv) {
    a = T(0.5);
    b = small ? T(1) / T(12) + a2 / T(720)
              : T(1) / a2 - (T(1) + cos(angle)) / (T(2) * angle * sin(angle));
  } else {
    a = -(small ? T(0.5) - a2 / T(24) : (T(1) - cos(angle)) / a2);
    b = small ? T(1) / T(6) - a2 / T(120) : (angle - sin(angle)) / (a2 * angle);
  }
  T H[9], H2[9];
  hat(w, H);
  mm<T, false, false>(H, H, H2);
#pragma unroll
  for (int e = 0; e < 9; ++e) J[e] = (e % 4 == 0 ? T(1) : T(0)) + a * H[e] + b * H2[e];
}

}  // namespace
