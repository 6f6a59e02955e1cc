// K1: one pyramid level of forward-additive Lucas-Kanade per keypoint.
//
// Replaces the Pallas kernel xrslam_tpu/frontend/klt_pallas.py
// (track_level_pallas, kernel _kernel), with the semantics of its TPU
// twin klt._track_level_mxu: per point, one (search x search) block of
// the next image around the initial guess (zero past the image edge),
// the 21x21 template and Scharr gradient windows bilinearly sampled at
// the previous point, the 2x2 structure tensor with its min-eigenvalue
// and determinant gates, then <= iters LK steps with the iterate's
// window corner clamped to [0, search - win - 1] inside the block, a
// per-point stop at |step| < eps, and (final level) the template
// residual err = mean |J - T|.
//
// What bounds it on the card: latency, not bytes or FLOPs. One level
// reads ~16 KB (search block) + 3 x 1.9 KB (windows) per point and does
// ~30 x 441 x 8 flops; 256 points are 256 small, serial 30-step
// dependency chains (sample -> reduce -> 2x2 solve -> next sample).
//
// What the design does about it: one CTA (128 threads) per point, so
// 256 chains run side by side on 132 SMs; the search block and the
// three windows stay in shared memory for all iterations, so an
// iteration touches no device memory; each bilinear tap is read
// straight from shared memory (the hat-selector matmuls of the TPU
// version exist only because Mosaic cannot slice at sub-128-lane
// offsets); each step's two sums are one warp-shuffle + cross-warp
// reduction in a fixed order, so every thread sees the same step and
// the per-point stop is uniform across the CTA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Sums NV values over the CTA; every thread returns the same totals
// (fixed summation order).
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV],
                                          float (*red)[kWarps]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) red[i][wid] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[i][w];
    v[i] = s;
  }
}

__device__ __forceinline__ float bilerp(const float* p, int stride, float fx,
                                        float fy) {
  return (1.f - fy) * (1.f - fx) * p[0] + (1.f - fy) * fx * p[1] +
         fy * (1.f - fx) * p[stride] + fy * fx * p[stride + 1];
}

__global__ void __launch_bounds__(kThreads)
klt_level_kernel(const float* __restrict__ prev, const float* __restrict__ pix,
                 const float* __restrict__ piy, const float* __restrict__ next,
                 const float* __restrict__ pts, const float* __restrict__ guess,
                 const uint8_t* __restrict__ valid,
                 float* __restrict__ guess_out, uint8_t* __restrict__ valid_out,
                 float* __restrict__ err_out, int* __restrict__ steps_out,
                 int H, int W, int win, int iters, float eps_sq,
                 float min_eig_floor, int final_level, int search) {
  extern __shared__ float smem[];
  float* S = smem;                     // (search, search) block of next
  float* T = S + search * search;      // (win, win) template
  float* Ix = T + win * win;           // (win, win) x gradient
  float* Iy = Ix + win * win;          // (win, win) y gradient
  __shared__ float red[3][kWarps];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int r = win / 2;
  const int ntap = win * win;
  const float px = pts[2 * n], py = pts[2 * n + 1];
  const float gx0 = guess[2 * n], gy0 = guess[2 * n + 1];
  const bool ok_in = valid[n] != 0;

  // search block around the initial guess (_track_level_mxu.gather_block)
  const int cx = min(max(static_cast<int>(floorf(gx0)) - search / 2, 0),
                     max(W - search, 0));
  const int cy = min(max(static_cast<int>(floorf(gy0)) - search / 2, 0),
                     max(H - search, 0));
  for (int e = tid; e < search * search; e += kThreads) {
    const int yy = cy + e / search, xx = cx + e % search;
    S[e] = (yy < H && xx < W) ? next[yy * W + xx] : 0.f;
  }

  // template + gradient windows at the fixed previous point
  // (klt._sample_window: clamped block corner, shared fractional offset)
  const float x0f = px - r, y0f = py - r;
  const int tx = min(max(static_cast<int>(floorf(x0f)), 0), max(W - win - 1, 0));
  const int ty = min(max(static_cast<int>(floorf(y0f)), 0), max(H - win - 1, 0));
  const float fx = x0f - static_cast<float>(tx);
  const float fy = y0f - static_cast<float>(ty);
  float g[3] = {0.f, 0.f, 0.f};
  for (int e = tid; e < ntap; e += kThreads) {
    const int base = (ty + e / win) * W + tx + e % win;
    const float t = bilerp(prev + base, W, fx, fy);
    const float gx = bilerp(pix + base, W, fx, fy);
    const float gy = bilerp(piy + base, W, fx, fy);
    T[e] = t;
    Ix[e] = gx;
    Iy[e] = gy;
    g[0] += gx * gx;
    g[1] += gx * gy;
    g[2] += gy * gy;
  }
  block_sum<3>(g, red);  // also orders the shared-memory writes above
  const float gxx = g[0], gxy = g[1], gyy = g[2];
  const float det = gxx * gyy - gxy * gxy;
  const float small_eig =
      0.5f * (gxx + gyy - sqrtf((gxx - gyy) * (gxx - gyy) + 4.f * gxy * gxy));
  const bool cond_ok = (gxx + gyy) > 0.f &&
                       small_eig / static_cast<float>(ntap) > min_eig_floor &&
                       det > 1e-12f;
  const float inv_det = det > 1e-12f ? 1.f / det : 0.f;
  const bool inb0 = px >= r && px < W - r && py >= r && py < H - r;
  const float lmax = static_cast<float>(search - win - 1);

  float lx = gx0 - static_cast<float>(cx);
  float ly = gy0 - static_cast<float>(cy);
  bool conv = !(cond_ok && inb0 && ok_in);
  int steps = 0;  // LK steps this point took (reported for the bound)
  for (; steps < iters && !conv; ++steps) {
    const float wx = fminf(fmaxf(lx - r, 0.f), lmax);
    const float wy = fminf(fmaxf(ly - r, 0.f), lmax);
    const int jx = static_cast<int>(floorf(wx));
    const int jy = static_cast<int>(floorf(wy));
    const float ax = wx - static_cast<float>(jx);
    const float ay = wy - static_cast<float>(jy);
    float b[2] = {0.f, 0.f};
    for (int e = tid; e < ntap; e += kThreads) {
      const float J = bilerp(S + (jy + e / win) * search + jx + e % win,
                             search, ax, ay);
      const float d = J - T[e];
      b[0] += d * Ix[e];
      b[1] += d * Iy[e];
    }
    block_sum<2>(b, red);
    const float dx = -(gyy * b[0] - gxy * b[1]) * inv_det;
    const float dy = -(-gxy * b[0] + gxx * b[1]) * inv_det;
    lx += dx;
    ly += dy;
    conv = (dx * dx + dy * dy) < eps_sq;
  }

  const bool use = ok_in && cond_ok && inb0;
  float err = 0.f;
  if (final_level) {
    const float wx = fminf(fmaxf(lx - r, 0.f), lmax);
    const float wy = fminf(fmaxf(ly - r, 0.f), lmax);
    const int jx = static_cast<int>(floorf(wx));
    const int jy = static_cast<int>(floorf(wy));
    const float ax = wx - static_cast<float>(jx);
    const float ay = wy - static_cast<float>(jy);
    float s[1] = {0.f};
    for (int e = tid; e < ntap; e += kThreads) {
      const float J = bilerp(S + (jy + e / win) * search + jx + e % win,
                             search, ax, ay);
      s[0] += fabsf(J - T[e]);
    }
    block_sum<1>(s, red);
    err = s[0] / static_cast<float>(ntap);
  }
  if (tid == 0) {
    guess_out[2 * n] = use ? lx + static_cast<float>(cx) : gx0;
    guess_out[2 * n + 1] = use ? ly + static_cast<float>(cy) : gy0;
    valid_out[n] = (final_level ? use : ok_in) ? 1 : 0;
    err_out[n] = err;
    if (steps_out != nullptr) steps_out[n] = steps;
  }
}

}  // namespace

extern "C" int klt_level_launch(const void* prev, const void* pix,
                                const void* piy, const void* next,
                                const void* pts, const void* guess,
                                const void* valid, void* guess_out,
                                void* valid_out, void* err_out,
                                void* steps_out, int n_points, int H, int W,
                                int win, int iters, float eps_sq,
                                float min_eig_floor, int final_level,
                                int search, void* stream) {
  if (n_points == 0) return 0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(search) * search + 3 * win * win);
  klt_level_kernel<<<n_points, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(pix),
      static_cast<const float*>(piy), static_cast<const float*>(next),
      static_cast<const float*>(pts), static_cast<const float*>(guess),
      static_cast<const uint8_t*>(valid), static_cast<float*>(guess_out),
      static_cast<uint8_t*>(valid_out), static_cast<float*>(err_out),
      static_cast<int*>(steps_out), H, W, win, iters, eps_sq, min_eig_floor,
      final_level, search);
  return static_cast<int>(cudaGetLastError());
}
