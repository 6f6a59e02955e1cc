// K1: pyramidal forward-additive Lucas-Kanade per keypoint.
//
// Replaces the Pallas kernel xrslam_tpu/frontend/klt_pallas.py
// (track_level_pallas, kernel _kernel), with the semantics of its TPU
// twin klt._track_level_mxu: per point and pyramid level, one
// (search x search) block of the next image around the guess (zero past
// the image edge), the 21x21 template and Scharr gradient windows
// bilinearly sampled at the previous point, the 2x2 structure tensor
// with its min-eigenvalue and determinant gates, then <= iters LK steps
// with the iterate's window corner clamped to [0, search - win - 1]
// inside the block, a per-point stop at |step| < eps, and (final level)
// the template residual err = mean |J - T|.
//
// Two entries share the device code, one warp per point:
//  - klt_track_launch: all of klt.track_keypoints for a frame pair in
//    one launch. Per point: the forward chain from the top level down to
//    level 0 (guess x 2 between levels), the forward gates (border,
//    displacement <= H/4, err <= max_residual), the level-0 backward
//    pass seeded at the previous point with its template at the forward
//    result, and the round-trip gate. The Scharr gradients are computed
//    here, on each point's clamped (win+3)^2 block of the previous image
//    (the replicate border of image._sep_filter), so no image-wide
//    gradient exists.
//  - klt_level_launch: one pyramid level with the gradient images as
//    inputs (the JAX signature); off the main path.
//
// What bounds it on the card: latency. A frame pair reads a few MB and
// does ~0.1 GFLOP, but every point is a serial chain of up to
// 5 x 30 LK steps (sample -> reduce -> 2x2 solve -> next sample).
//
// What the design does about it: a point's whole chain runs in one warp,
// so a frame waits for its longest single chain, not for the sum of five
// per-level maxima. Reductions are xor-butterfly shuffles in a fixed
// order (every lane holds the same bits, so the per-point stop is
// uniform, and repeats are bit-equal); the LK loop has no CTA barrier,
// and a converged warp leaves at once. What is known at the start (every
// level's previous-image block at pts_prev / 2^l, the backward pass's
// search block) is copied with cp.async while the top level iterates; a
// lower level's search block waits for the level above, which sets its
// guess. Each lane keeps its 14 taps of the windows (and their offsets in
// the block) in registers, so an LK step is one unrolled burst of 56
// independent shared-memory loads, then a butterfly. A block's row
// stride is its side rounded up to win modulo 32, so 32 consecutive
// window taps fall on 32 different banks.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLevels = 4;
constexpr int kMaxWin = 21;
constexpr int kLaneTaps = (kMaxWin * kMaxWin + 31) / 32;  // 14 taps a lane
constexpr int kMaxSearch = 64;
constexpr int kMaxWarpsPerCta = 4;
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory of a CTA
// Scharr (OpenCV's LK derivative kernel, /32): smoothing [3, 10, 3] / 32,
// difference [-1, 0, 1]
constexpr float kS0 = 3.f / 32.f;
constexpr float kS1 = 10.f / 32.f;

// Sums each of v over the warp; every lane ends with the same bits.
template <int NV>
__device__ __forceinline__ void warp_sum(float (&v)[NV]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
}

// The elements lane, lane + 32, ... of a row-major (rows x cols) array,
// each with its (row, col), stepped without a division per element.
struct LaneWalk {
  int e, y, x, n, cols, dy, dx;
  __device__ __forceinline__ LaneWalk(int rows, int cols_, int lane)
      : e(lane), y(lane / cols_), x(lane % cols_), n(rows * cols_),
        cols(cols_), dy(32 / cols_), dx(32 % cols_) {}
  __device__ __forceinline__ bool ok() const { return e < n; }
  __device__ __forceinline__ void next() {
    e += 32;
    y += dy;
    x += dx;
    if (x >= cols) {
      x -= cols;
      ++y;
    }
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// floor(v) as an int, |v| first clamped to 2^26 so that a diverged
// iterate converts without overflow (every clamp after it sees the same
// side of the image as the float would).
__device__ __forceinline__ int floor_int(float v) {
  return static_cast<int>(fminf(fmaxf(floorf(v), -67108864.f), 67108864.f));
}

// Corner of the (side x side) search block around g on an axis of `size`
// pixels (_track_level_mxu.gather_block).
__device__ __forceinline__ int block_corner(float g, int side, int size) {
  return min(max(floor_int(g) - side / 2, 0), max(size - side, 0));
}

// Row stride of a (side x side) block in shared memory: side rounded up
// to win modulo 32 (see the head of this file).
__host__ __device__ __forceinline__ int block_stride(int side, int win) {
  return side + (((win - side) % 32) + 32) % 32;
}

// The (win+1)^2 sample block of the window centred at (px, py): corner
// clamped to the image, one fractional offset against the clamped corner
// (klt._sample_window).
struct Window {
  int x, y;
  float fx, fy;
};
__device__ __forceinline__ Window window_at(float px, float py, int win,
                                            int H, int W) {
  const int r = win / 2;
  const float x0f = px - r, y0f = py - r;
  Window w;
  w.x = min(max(floor_int(x0f), 0), max(W - win - 1, 0));
  w.y = min(max(floor_int(y0f), 0), max(H - win - 1, 0));
  w.fx = x0f - static_cast<float>(w.x);
  w.fy = y0f - static_cast<float>(w.y);
  return w;
}

__device__ __forceinline__ float bilerp(const float* p, int stride, float fx,
                                        float fy) {
  return (1.f - fy) * (1.f - fx) * p[0] + (1.f - fy) * fx * p[1] +
         fy * (1.f - fx) * p[stride] + fy * fx * p[stride + 1];
}

// S[r * stride + c] = img[cy + r][cx + c], zero past the image edge.
__device__ __forceinline__ void load_block_async(float* S, int stride,
                                                 const float* img, int H,
                                                 int W, int cy, int cx,
                                                 int side, int lane) {
  for (int r = 0; r < side; ++r) {
    const int yy = cy + r;
    for (int c = lane; c < side; c += 32) {
      const int xx = cx + c;
      const bool in = yy < H && xx < W;
      cp_async4(S + r * stride + c,
                in ? img + static_cast<size_t>(yy) * W + xx : img,
                in ? 4 : 0);
    }
  }
}

// P = the (win+3)^2 block of img whose interior is window w's sample
// block, indices clamped to the image.
__device__ __forceinline__ void load_scharr_block_async(
    float* P, const float* img, int H, int W, const Window& w, int win,
    int lane) {
  const int side = win + 3;
  for (LaneWalk t(side, side, lane); t.ok(); t.next()) {
    const int yy = min(max(w.y - 1 + t.y, 0), H - 1);
    const int xx = min(max(w.x - 1 + t.x, 0), W - 1);
    cp_async4(P + t.e, img + static_cast<size_t>(yy) * W + xx, 4);
  }
}

// Template and Scharr windows from the block P: the gradients on the
// (win+1)^2 sample block (rows, then columns, as image._sep_filter),
// then one bilinear blend for all three windows. G holds 2 (win+1)^2.
__device__ void scharr_windows(const float* P, float* G, float* T, float* Ix,
                               float* Iy, int win, float fx, float fy,
                               int lane) {
  const int pw = win + 3, gw = win + 1;
  float* Gx = G;
  float* Gy = G + gw * gw;
  for (LaneWalk t(gw, gw, lane); t.ok(); t.next()) {
    const float* p = P + t.y * pw + t.x;  // the 3x3 around pixel (t.y, t.x)
    float s[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s[c] = kS0 * p[c] + kS1 * p[pw + c] + kS0 * p[2 * pw + c];
      d[c] = p[2 * pw + c] - p[c];
    }
    Gx[t.e] = s[2] - s[0];
    Gy[t.e] = kS0 * d[0] + kS1 * d[1] + kS0 * d[2];
  }
  __syncwarp();
  for (LaneWalk t(win, win, lane); t.ok(); t.next()) {
    T[t.e] = bilerp(P + (t.y + 1) * pw + t.x + 1, pw, fx, fy);
    Ix[t.e] = bilerp(Gx + t.y * gw + t.x, gw, fx, fy);
    Iy[t.e] = bilerp(Gy + t.y * gw + t.x, gw, fx, fy);
  }
  __syncwarp();
}

// Template and gradient windows sampled from whole images (entry 1).
__device__ void gradient_windows(const float* prev, const float* pix,
                                 const float* piy, int W, const Window& w,
                                 float* T, float* Ix, float* Iy, int win,
                                 int lane) {
  for (LaneWalk t(win, win, lane); t.ok(); t.next()) {
    const size_t base = static_cast<size_t>(w.y + t.y) * W + w.x + t.x;
    T[t.e] = bilerp(prev + base, W, w.fx, w.fy);
    Ix[t.e] = bilerp(pix + base, W, w.fx, w.fy);
    Iy[t.e] = bilerp(piy + base, W, w.fx, w.fy);
  }
  __syncwarp();
}

struct LevelOut {
  float x, y, err;
  bool ok;
  int steps;
};

// One lane's taps lane, lane + 32, ... of the windows, in registers, with
// each tap's offset y * stride + x in the search block. Taps past the
// window hold zeros and offset 0: they add exactly nothing to a sum of
// products, so an LK step's loop has no branch and unrolls whole.
struct LaneTaps {
  float t[kLaneTaps], ix[kLaneTaps], iy[kLaneTaps];
  int rel[kLaneTaps];
};

__device__ __forceinline__ void load_taps(LaneTaps& q, const float* T,
                                          const float* Ix, const float* Iy,
                                          int win, int stride, int lane) {
  LaneWalk w(win, win, lane);
#pragma unroll
  for (int k = 0; k < kLaneTaps; ++k) {
    const bool in = w.ok();
    q.t[k] = in ? T[w.e] : 0.f;
    q.ix[k] = in ? Ix[w.e] : 0.f;
    q.iy[k] = in ? Iy[w.e] : 0.f;
    q.rel[k] = in ? w.y * stride + w.x : 0;
    w.next();
  }
}

// One pyramid level of LK for one point, run by one warp whose lanes all
// hold the same scalars: S is the (search x search) block of the next
// image at corner (cx, cy), T/Ix/Iy the windows at (px, py) of the
// previous image (H x W), (gx0, gy0) the guess.
__device__ LevelOut lk_level(const float* S, int stride, int search, int cx,
                             int cy, const float* T, const float* Ix,
                             const float* Iy, int win, float px, float py,
                             int H, int W, float gx0, float gy0, bool ok_in,
                             int iters, float eps_sq, float min_eig_floor,
                             bool final_level, int lane) {
  const int r = win / 2;
  const int ntap = win * win;
  LaneTaps q;
  load_taps(q, T, Ix, Iy, win, stride, lane);
  float g[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kLaneTaps; ++k) {
    g[0] += q.ix[k] * q.ix[k];
    g[1] += q.ix[k] * q.iy[k];
    g[2] += q.iy[k] * q.iy[k];
  }
  warp_sum<3>(g);
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
  int steps = 0;
  for (; steps < iters && !conv; ++steps) {
    const float wx = fminf(fmaxf(lx - r, 0.f), lmax);
    const float wy = fminf(fmaxf(ly - r, 0.f), lmax);
    const int jx = static_cast<int>(floorf(wx));
    const int jy = static_cast<int>(floorf(wy));
    const float ax = wx - static_cast<float>(jx);
    const float ay = wy - static_cast<float>(jy);
    const float* base = S + jy * stride + jx;
    float b[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kLaneTaps; ++k) {
      const float d = bilerp(base + q.rel[k], stride, ax, ay) - q.t[k];
      b[0] += d * q.ix[k];
      b[1] += d * q.iy[k];
    }
    warp_sum<2>(b);
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
    const float* base = S + jy * stride + jx;
    float s[1] = {0.f};
#pragma unroll
    for (int k = 0; k < kLaneTaps; ++k)
      if (lane + 32 * k < ntap)
        s[0] += fabsf(bilerp(base + q.rel[k], stride, ax, ay) - q.t[k]);
    warp_sum<1>(s);
    err = s[0] / static_cast<float>(ntap);
  }
  LevelOut o;
  o.x = use ? lx + static_cast<float>(cx) : gx0;
  o.y = use ? ly + static_cast<float>(cy) : gy0;
  o.ok = final_level ? use : ok_in;
  o.err = err;
  o.steps = steps;
  return o;
}

__global__ void __launch_bounds__(32 * kMaxWarpsPerCta)
klt_level_kernel(const float* __restrict__ prev, const float* __restrict__ pix,
                 const float* __restrict__ piy, const float* __restrict__ next,
                 const float* __restrict__ pts, const float* __restrict__ guess,
                 const uint8_t* __restrict__ valid,
                 float* __restrict__ guess_out, uint8_t* __restrict__ valid_out,
                 float* __restrict__ err_out, int* __restrict__ steps_out,
                 int n_points, int H, int W, int win, int iters, float eps_sq,
                 float min_eig_floor, int final_level, int search,
                 int warp_floats) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= n_points) return;
  const int stride = block_stride(search, win);
  float* S = smem + (threadIdx.x >> 5) * warp_floats;
  float* T = S + search * stride;
  float* Ix = T + win * win;
  float* Iy = Ix + win * win;

  const float px = pts[2 * n], py = pts[2 * n + 1];
  const float gx0 = guess[2 * n], gy0 = guess[2 * n + 1];
  const int cx = block_corner(gx0, search, W);
  const int cy = block_corner(gy0, search, H);
  load_block_async(S, stride, next, H, W, cy, cx, search, lane);
  cp_async_commit();
  // the windows' global reads overlap the block's copy
  gradient_windows(prev, pix, piy, W, window_at(px, py, win, H, W), T, Ix,
                   Iy, win, lane);
  cp_async_wait<0>();
  __syncwarp();
  const LevelOut o = lk_level(S, stride, search, cx, cy, T, Ix, Iy, win, px,
                              py, H, W, gx0, gy0, valid[n] != 0, iters, eps_sq,
                              min_eig_floor, final_level != 0, lane);
  if (lane == 0) {
    guess_out[2 * n] = o.x;
    guess_out[2 * n + 1] = o.y;
    valid_out[n] = o.ok ? 1 : 0;
    err_out[n] = o.err;
    if (steps_out != nullptr) steps_out[n] = o.steps;
  }
}

struct Pyramids {
  const float* prev[kMaxLevels];
  const float* next[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  int levels;
};

struct TrackArgs {
  int win, iters, search_top, search_lo;
  float eps_sq, min_eig_floor, border, reverse_thresh, max_residual;
};

// Shared-memory floats of one warp of klt_track_kernel: the search block
// (reused by every forward level), the backward search block, one
// (win+3)^2 block per level, the two gradient blocks, the three windows.
int track_warp_floats(int levels, const TrackArgs& a) {
  const int top = a.search_top * block_stride(a.search_top, a.win);
  const int lo = a.search_lo * block_stride(a.search_lo, a.win);
  return (top > lo ? top : lo) + lo + levels * (a.win + 3) * (a.win + 3) +
         2 * (a.win + 1) * (a.win + 1) + 3 * a.win * a.win;
}

__global__ void __launch_bounds__(32 * kMaxWarpsPerCta)
klt_track_kernel(Pyramids pyr, TrackArgs a, const float* __restrict__ pts_prev,
                 const float* __restrict__ pts_init,
                 const uint8_t* __restrict__ valid_in,
                 float* __restrict__ pts_next, uint8_t* __restrict__ status,
                 int* __restrict__ steps_out, int n_points, int warp_floats) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= n_points) return;
  const int win = a.win, L = pyr.levels, top = L - 1;
  const int pside = (win + 3) * (win + 3);
  const int st_top = block_stride(a.search_top, win);
  const int st_lo = block_stride(a.search_lo, win);
  float* S = smem + (threadIdx.x >> 5) * warp_floats;
  float* Sb = S + max(a.search_top * st_top, a.search_lo * st_lo);
  float* P = Sb + a.search_lo * st_lo;
  float* G = P + L * pside;
  float* T = G + 2 * (win + 1) * (win + 1);
  float* Ix = T + win * win;
  float* Iy = Ix + win * win;

  const float px = pts_prev[2 * n], py = pts_prev[2 * n + 1];
  const float qx = pts_init[2 * n], qy = pts_init[2 * n + 1];
  const int H0 = pyr.H[0], W0 = pyr.W[0];
  int steps[kMaxLevels + 1] = {0, 0, 0, 0, 0};
  bool st = valid_in[n] != 0;
  float fx = qx, fy = qy;
  if (st) {
    Window wl[kMaxLevels];
    for (int l = 0; l < L; ++l) {
      const float inv = 1.f / static_cast<float>(1 << l);
      wl[l] = window_at(px * inv, py * inv, win, pyr.H[l], pyr.W[l]);
    }
    // copied at the start: the top level's two blocks (group 1), then the
    // lower levels' previous-image blocks and the backward search block
    // (group 2), which arrive while the top level iterates
    float gx = qx / static_cast<float>(1 << top);
    float gy = qy / static_cast<float>(1 << top);
    int search = a.search_top, stride = st_top;
    int cx = block_corner(gx, search, pyr.W[top]);
    int cy = block_corner(gy, search, pyr.H[top]);
    load_block_async(S, stride, pyr.next[top], pyr.H[top], pyr.W[top], cy, cx,
                     search, lane);
    load_scharr_block_async(P + top * pside, pyr.prev[top], pyr.H[top],
                            pyr.W[top], wl[top], win, lane);
    cp_async_commit();
    for (int l = top - 1; l >= 0; --l)
      load_scharr_block_async(P + l * pside, pyr.prev[l], pyr.H[l], pyr.W[l],
                              wl[l], win, lane);
    const int bcx = block_corner(px, a.search_lo, W0);
    const int bcy = block_corner(py, a.search_lo, H0);
    load_block_async(Sb, st_lo, pyr.prev[0], H0, W0, bcy, bcx, a.search_lo,
                     lane);
    cp_async_commit();

    float err = 0.f;
    for (int l = top; l >= 0; --l) {
      if (l < top) {
        // this level's search block needs the level above's guess
        search = a.search_lo;
        stride = st_lo;
        cx = block_corner(gx, search, pyr.W[l]);
        cy = block_corner(gy, search, pyr.H[l]);
        __syncwarp();  // every lane is done with the block it replaces
        load_block_async(S, stride, pyr.next[l], pyr.H[l], pyr.W[l], cy, cx,
                         search, lane);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();
      }
      __syncwarp();
      scharr_windows(P + l * pside, G, T, Ix, Iy, win, wl[l].fx, wl[l].fy,
                     lane);
      const float inv = 1.f / static_cast<float>(1 << l);
      const LevelOut o = lk_level(S, stride, search, cx, cy, T, Ix, Iy, win,
                                  px * inv, py * inv, pyr.H[l], pyr.W[l], gx,
                                  gy, st, a.iters, a.eps_sq, a.min_eig_floor,
                                  l == 0, lane);
      steps[top - l] = o.steps;
      gx = o.x;
      gy = o.y;
      st = o.ok;
      err = o.err;
      if (l > 0) {
        gx *= 2.f;
        gy *= 2.f;
      }
    }
    fx = gx;
    fy = gy;
    const float ddx = fx - px, ddy = fy - py;
    st = st && fx >= a.border && fx < W0 - a.border && fy >= a.border &&
         fy < H0 - a.border &&
         sqrtf(ddx * ddx + ddy * ddy) <= static_cast<float>(H0) * 0.25f &&
         err <= a.max_residual;
    if (st) {
      // backward, level 0: template at the forward result in the next
      // image, search block of the previous image at pts_prev
      const Window wb = window_at(fx, fy, win, H0, W0);
      __syncwarp();
      load_scharr_block_async(P, pyr.next[0], H0, W0, wb, win, lane);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      scharr_windows(P, G, T, Ix, Iy, win, wb.fx, wb.fy, lane);
      const LevelOut b = lk_level(Sb, st_lo, a.search_lo, bcx, bcy, T, Ix, Iy,
                                  win, fx, fy, H0, W0, px, py, true, a.iters,
                                  a.eps_sq, a.min_eig_floor, true, lane);
      steps[L] = b.steps;
      const float rx = b.x - px, ry = b.y - py;
      st = b.ok && sqrtf(rx * rx + ry * ry) <= a.reverse_thresh;
    }
    cp_async_wait<0>();  // the backward block's copy, where it went unused
  }
  if (lane == 0) {
    pts_next[2 * n] = st ? fx : qx;
    pts_next[2 * n + 1] = st ? fy : qy;
    status[n] = st ? 1 : 0;
    if (steps_out != nullptr)
      for (int p = 0; p <= L; ++p) steps_out[n * (L + 1) + p] = steps[p];
  }
}

// Launches `kernel` with as many points per CTA as cover the SMs, within
// kMaxWarpsPerCta and the shared memory a CTA may use.
template <class Kernel, class... Args>
int launch(Kernel kernel, int n_points, int warp_floats, void* stream,
           Args... args) {
  const size_t per_warp = sizeof(float) * static_cast<size_t>(warp_floats);
  if (per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int warps = std::max(
      1, std::min({(n_points + sms - 1) / sms, kMaxWarpsPerCta,
                   static_cast<int>(kMaxSmem / per_warp)}));
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(n_points + warps - 1) / warps, 32 * warps, smem,
           static_cast<cudaStream_t>(stream)>>>(args..., warp_floats);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int win, int search) {
  return win % 2 == 1 && win >= 3 && win <= kMaxWin && search >= win + 2 &&
         search <= kMaxSearch;
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
  if (!shape_ok(win, search)) return static_cast<int>(cudaErrorInvalidValue);
  const int warp_floats = search * block_stride(search, win) + 3 * win * win;
  return launch(klt_level_kernel, n_points, warp_floats, stream,
                static_cast<const float*>(prev), static_cast<const float*>(pix),
                static_cast<const float*>(piy), static_cast<const float*>(next),
                static_cast<const float*>(pts), static_cast<const float*>(guess),
                static_cast<const uint8_t*>(valid),
                static_cast<float*>(guess_out),
                static_cast<uint8_t*>(valid_out), static_cast<float*>(err_out),
                static_cast<int*>(steps_out), n_points, H, W, win, iters,
                eps_sq, min_eig_floor, final_level, search);
}

extern "C" int klt_track_launch(
    const void* prev0, const void* prev1, const void* prev2, const void* prev3,
    const void* next0, const void* next1, const void* next2, const void* next3,
    const void* pts_prev, const void* pts_init, const void* valid_in,
    void* pts_next, void* status, void* steps_out, int n_points, int levels,
    int H0, int W0, int H1, int W1, int H2, int W2, int H3, int W3, int win,
    int iters, int search_top, int search_lo, float eps_sq,
    float min_eig_floor, float border, float reverse_thresh,
    float max_residual, void* stream) {
  if (n_points == 0) return 0;
  if (levels < 1 || levels > kMaxLevels || !shape_ok(win, search_top) ||
      !shape_ok(win, search_lo))
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramids pyr = {{static_cast<const float*>(prev0),
                   static_cast<const float*>(prev1),
                   static_cast<const float*>(prev2),
                   static_cast<const float*>(prev3)},
                  {static_cast<const float*>(next0),
                   static_cast<const float*>(next1),
                   static_cast<const float*>(next2),
                   static_cast<const float*>(next3)},
                  {H0, H1, H2, H3},
                  {W0, W1, W2, W3},
                  levels};
  const TrackArgs a = {win,    iters,         search_top, search_lo,
                       eps_sq, min_eig_floor, border,     reverse_thresh,
                       max_residual};
  return launch(klt_track_kernel, n_points, track_warp_floats(levels, a),
                stream, pyr, a, static_cast<const float*>(pts_prev),
                static_cast<const float*>(pts_init),
                static_cast<const uint8_t*>(valid_in),
                static_cast<float*>(pts_next), static_cast<uint8_t*>(status),
                static_cast<int*>(steps_out), n_points);
}
