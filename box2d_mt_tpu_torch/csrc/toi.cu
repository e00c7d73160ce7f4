// Time of impact per lane (conservative advancement), one thread per
// active lane, the active lanes compacted inside each block.
//
// Replaces the TPU kernel box2d_mt_tpu/ops/pallas_toi.py `_kernel` /
// `time_of_impact_lanes` (:48-562): b2TimeOfImpact (b2TimeOfImpact.cpp:
// 256-497) with b2Distance (GJK with a simplex cache, b2Distance.cpp:
// 452-606) inside, the separating function, the push-back loop (at most 8
// trips) and the secant/bisection root finder (at most 12 trips), under an
// outer loop of at most 20 trips. The argument contract and the plain
// PyTorch version it is held against (ops/distance.py `time_of_impact`)
// are in ops/toi.py; this file runs the same arithmetic in the same order,
// and is built with --fmad=false and without fast math (sincosf, IEEE
// division and square root), so the two agree to the bit on a card.
//
// What bounds it on an H100: bytes, and they are tiny. An inactive lane
// needs only `active`, `t_max` and its two outputs (13 B); an active lane
// adds its counts, radii, sweep rows and each proxy's own vertices. At the
// main path's busiest round (512 x pyramid(10): 16,384 lanes, 5,120
// active boxes on the ground edge) that is 0.87 MB, 0.26 us at 3.35 TB/s,
// above its ~0.1 us of f32 operations; chip_smoke.py computes it from each
// run's lanes. What the time goes to instead is latency: one lane's
// dependent chain (sweep transforms, GJK and the separating-function
// evaluations, each trip waiting on the last), and where a round's active
// lanes are sparse (one of every 32 for fast boxes), warps that carry one
// working lane and a second wave of such warps.
// The design:
// * A shorter chain: one sincosf a transform, and no transform computed
//   twice at one time (the window's end once a lane, t1 once an outer
//   trip, the root finder's time kept where it converged): 8 transforms
//   instead of 16 for a main-path lane.
// * Compaction inside a block, in the one launch, with no host read: a
//   block of 12 warps an SM (one wave) walks a contiguous span of lanes,
//   each warp appends its active lanes to a queue in shared memory (ballot
//   and popc), and the warps solve the queue 32 lanes a warp. A span is at
//   least 128 lanes and grows with the batch, so a sparse round fills
//   whole warps: 1,024 lanes a block at 131,072 lanes, 32 fast boxes or
//   320 pyramid lanes. A compaction across blocks (a global queue behind a
//   grid-wide wait) was built and measured first: its atomics, fence and
//   wait cost ~3 us a launch, more than the fuller warps gave back.
// * Both proxies' vertices (32 floats), the simplex, the separating
//   function and the held transforms live in registers (every array is
//   indexed by compile-time constants after unrolling; a data-dependent
//   vertex index is a select chain, not a local memory load). Inputs are
//   plane-major rows of L values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNV = 8;                 // b2_maxPolygonVertices
constexpr int kThreads = 384;          // 12 warps a block, one block an SM
constexpr int kGjkIters = 20;
constexpr int kToiIters = 20;
constexpr int kPushIters = kNV;
constexpr int kRootIters = 12;

// ops/distance.py constants, rounded to float as the Python side does
constexpr double kLinearSlopD = 0.005;
constexpr float kLinearSlop = (float)kLinearSlopD;
constexpr float kTargetMargin = (float)(3.0 * kLinearSlopD);
constexpr float kTolerance = (float)(0.25 * kLinearSlopD);
constexpr float kEps = 1.1920929e-7f;
constexpr float kEps2 = (float)(1.1920929e-7 * 1.1920929e-7);
constexpr float kTiny = 1.1754943508222875e-38f;
constexpr float kNegBig = -3.4e38f;

enum { kUnknown = 0, kFailed = 1, kOverlapped = 2, kTouching = 3, kSeparated = 4 };

struct Proxy {
  float vx[kNV], vy[kNV];
  int count;
};

struct Sweep {
  float lcx, lcy, c0x, c0y, cx, cy, a0, a;
};

struct Xf {
  float px, py, s, c;
};

struct SepFn {
  int ftype;  // 0 points, 1 face A, 2 face B
  float axx, axy, lpx, lpy;
};

__device__ __forceinline__ void vert(const Proxy& P, int i, float& x, float& y) {
  x = P.vx[0];
  y = P.vy[0];
#pragma unroll
  for (int r = 1; r < kNV; ++r) {
    if (i == r) {
      x = P.vx[r];
      y = P.vy[r];
    }
  }
}

// b2DistanceProxy::GetSupport on local direction (dx, dy): first maximum
__device__ __forceinline__ int support(const Proxy& P, float dx, float dy) {
  int best = 0;
  float bv = 0 < P.count ? P.vx[0] * dx + P.vy[0] * dy : kNegBig;
#pragma unroll
  for (int r = 1; r < kNV; ++r) {
    const float d = r < P.count ? P.vx[r] * dx + P.vy[r] * dy : kNegBig;
    if (d > bv) {
      bv = d;
      best = r;
    }
  }
  return best;
}

// b2Sweep::GetTransform (math2d.sweep_get_transform); one sincosf gives
// the same two values as sinf and cosf (the plain version's torch.sin and
// torch.cos) with one range reduction
__device__ __forceinline__ Xf sweep_xf(const Sweep& w, float beta) {
  const float ob = 1.0f - beta;
  const float posx = ob * w.c0x + beta * w.cx;
  const float posy = ob * w.c0y + beta * w.cy;
  const float ang = ob * w.a0 + beta * w.a;
  Xf x;
  sincosf(ang, &x.s, &x.c);
  x.px = posx - (x.c * w.lcx - x.s * w.lcy);
  x.py = posy - (x.s * w.lcx + x.c * w.lcy);
  return x;
}

// rot_vec(q, v) + p
__device__ __forceinline__ void to_world(const Xf& x, float lx, float ly, float& wx,
                                         float& wy) {
  wx = (x.c * lx - x.s * ly) + x.px;
  wy = (x.s * lx + x.c * ly) + x.py;
}

// rot_t_vec(q, v)
__device__ __forceinline__ void rot_t(const Xf& x, float vx, float vy, float& ox,
                                      float& oy) {
  ox = x.c * vx + x.s * vy;
  oy = -x.s * vx + x.c * vy;
}

__device__ __forceinline__ void normalize(float x, float y, float& ux, float& uy) {
  const float ln = sqrtf(x * x + y * y);
  const bool small = ln < kTiny;
  const float safe = small ? 1.0f : ln;
  ux = small ? 0.0f : x / safe;
  uy = small ? 0.0f : y / safe;
}

// ---- GJK (distance._solve2, _solve3, _gjk_iter, gjk_distance) ----------

struct Simplex {
  float wax[3], way[3], wbx[3], wby[3], bary[3];
  int ia[3], ib[3];
  int count;
};

__device__ __forceinline__ void copy_slot(Simplex& s, int dst, const Simplex& o, int src) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (src == k) {
      s.wax[dst] = o.wax[k];
      s.way[dst] = o.way[k];
      s.wbx[dst] = o.wbx[k];
      s.wby[dst] = o.wby[k];
      s.ia[dst] = o.ia[k];
      s.ib[dst] = o.ib[k];
    }
  }
}

__device__ __forceinline__ void solve2(Simplex& s) {
  const float w1x = s.wbx[0] - s.wax[0], w1y = s.wby[0] - s.way[0];
  const float w2x = s.wbx[1] - s.wax[1], w2y = s.wby[1] - s.way[1];
  const float e12x = w2x - w1x, e12y = w2y - w1y;
  const float d12_2 = -(w1x * e12x + w1y * e12y);
  const float d12_1 = w2x * e12x + w2y * e12y;
  const bool in_w1 = d12_2 <= 0.0f;
  const bool in_w2 = !in_w1 && d12_1 <= 0.0f;
  const bool vertex = in_w1 || in_w2;
  const float sum = d12_1 + d12_2;
  const float inv = 1.0f / (sum != 0.0f ? sum : 1.0f);
  if (in_w2) {
    const Simplex o = s;
    copy_slot(s, 0, o, 1);
  }
  const float b0 = vertex ? 1.0f : d12_1 * inv;
  const float b1 = vertex ? 0.0f : d12_2 * inv;
  s.bary[0] = b0;
  s.bary[1] = b1;
  s.count = vertex ? 1 : 2;
}

__device__ __forceinline__ float inv_or_one(float x) { return 1.0f / (x != 0.0f ? x : 1.0f); }

__device__ __forceinline__ void solve3(Simplex& s) {
  const float w1x = s.wbx[0] - s.wax[0], w1y = s.wby[0] - s.way[0];
  const float w2x = s.wbx[1] - s.wax[1], w2y = s.wby[1] - s.way[1];
  const float w3x = s.wbx[2] - s.wax[2], w3y = s.wby[2] - s.way[2];
  const float e12x = w2x - w1x, e12y = w2y - w1y;
  const float d12_1 = w2x * e12x + w2y * e12y;
  const float d12_2 = -(w1x * e12x + w1y * e12y);
  const float e13x = w3x - w1x, e13y = w3y - w1y;
  const float d13_1 = w3x * e13x + w3y * e13y;
  const float d13_2 = -(w1x * e13x + w1y * e13y);
  const float e23x = w3x - w2x, e23y = w3y - w2y;
  const float d23_1 = w3x * e23x + w3y * e23y;
  const float d23_2 = -(w2x * e23x + w2y * e23y);
  const float n123 = e12x * e13y - e12y * e13x;
  const float d123_1 = n123 * (w2x * w3y - w2y * w3x);
  const float d123_2 = n123 * (w3x * w1y - w3y * w1x);
  const float d123_3 = n123 * (w1x * w2y - w1y * w2x);

  const bool c_w1 = d12_2 <= 0.0f && d13_2 <= 0.0f;
  const bool c_e12 = d12_1 > 0.0f && d12_2 > 0.0f && d123_3 <= 0.0f;
  const bool c_e13 = d13_1 > 0.0f && d13_2 > 0.0f && d123_2 <= 0.0f;
  const bool c_w2 = d12_1 <= 0.0f && d23_2 <= 0.0f;
  const bool c_w3 = d13_1 <= 0.0f && d23_1 <= 0.0f;
  const bool c_e23 = d23_1 > 0.0f && d23_2 > 0.0f && d123_1 <= 0.0f;
  // first match in the reference's if-chain order
  const bool m_w1 = c_w1;
  const bool m_e12 = !m_w1 && c_e12;
  const bool m_e13 = !m_w1 && !m_e12 && c_e13;
  const bool m_w2 = !m_w1 && !m_e12 && !m_e13 && c_w2;
  const bool m_w3 = !m_w1 && !m_e12 && !m_e13 && !m_w2 && c_w3;
  const bool m_e23 = !m_w1 && !m_e12 && !m_e13 && !m_w2 && !m_w3 && c_e23;
  const bool m_tri = !(m_w1 || m_e12 || m_e13 || m_w2 || m_w3 || m_e23);
  const bool vertex = m_w1 || m_w2 || m_w3;

  const int src0 = m_w2 ? 1 : (m_w3 ? 2 : (m_e23 ? 1 : 0));
  const int src1 = (m_e13 || m_e23) ? 2 : 1;
  const float inv12 = inv_or_one(d12_1 + d12_2);
  const float inv13 = inv_or_one(d13_1 + d13_2);
  const float inv23 = inv_or_one(d23_1 + d23_2);
  const float inv123 = inv_or_one(d123_1 + d123_2 + d123_3);
  float b0, b1, b2;
  if (vertex) {
    b0 = 1.0f;
  } else if (m_e12) {
    b0 = d12_1 * inv12;
  } else if (m_e13) {
    b0 = d13_1 * inv13;
  } else if (m_e23) {
    b0 = d23_1 * inv23;
  } else {
    b0 = d123_1 * inv123;
  }
  if (m_e12) {
    b1 = d12_2 * inv12;
  } else if (m_e13) {
    b1 = d13_2 * inv13;
  } else if (m_e23) {
    b1 = d23_2 * inv23;
  } else if (m_tri) {
    b1 = d123_2 * inv123;
  } else {
    b1 = 0.0f;
  }
  b2 = m_tri ? d123_3 * inv123 : 0.0f;
  const Simplex o = s;
  copy_slot(s, 0, o, src0);
  copy_slot(s, 1, o, src1);
  s.bary[0] = b0;
  s.bary[1] = b1;
  s.bary[2] = b2;
  s.count = vertex ? 1 : (m_tri ? 3 : 2);
}

// gjk_distance with the simplex cache; returns the distance and leaves
// the simplex (the next cache) in s
__device__ float gjk(const Proxy& A, const Proxy& B, const Xf& xa, const Xf& xb,
                     Simplex& s, int cache_count) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float lx, ly;
    s.ia[k] = max(s.ia[k], 0);
    s.ib[k] = max(s.ib[k], 0);
    vert(A, s.ia[k], lx, ly);
    to_world(xa, lx, ly, s.wax[k], s.way[k]);
    vert(B, s.ib[k], lx, ly);
    to_world(xb, lx, ly, s.wbx[k], s.wby[k]);
  }
  int cnt = min(max(cache_count, 1), 3);
  {
    const float w0x = s.wbx[0] - s.wax[0], w0y = s.wby[0] - s.way[0];
    const float w1x = s.wbx[1] - s.wax[1], w1y = s.wby[1] - s.way[1];
    const float w2x = s.wbx[2] - s.wax[2], w2y = s.wby[2] - s.way[2];
    const float area = (w1x - w0x) * (w2y - w0y) - (w1y - w0y) * (w2x - w0x);
    if (cnt == 3 && fabsf(area) < kEps) cnt = 1;
  }
  s.count = cnt;
  s.bary[0] = 1.0f;
  s.bary[1] = 0.0f;
  s.bary[2] = 0.0f;

  for (int it = 0; it < kGjkIters; ++it) {
    int ia_save[3], ib_save[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ia_save[k] = s.ia[k];
      ib_save[k] = s.ib[k];
    }
    const int count_save = s.count;
    if (s.count == 2) {
      solve2(s);
    } else if (s.count == 3) {
      solve3(s);
    }
    bool done = s.count == 3;

    // search direction (b2Simplex::GetSearchDirection)
    const float w1x = s.wbx[0] - s.wax[0], w1y = s.wby[0] - s.way[0];
    const float w2x = s.wbx[1] - s.wax[1], w2y = s.wby[1] - s.way[1];
    const float e12x = w2x - w1x, e12y = w2y - w1y;
    const float sgn = e12x * (-w1y) - e12y * (-w1x);
    float dx, dy;
    if (s.count == 1) {
      dx = -w1x;
      dy = -w1y;
    } else if (sgn > 0.0f) {
      dx = -e12y;
      dy = e12x;
    } else {
      dx = e12y;
      dy = -e12x;
    }
    done = done || (dx * dx + dy * dy < kEps2);

    float lx, ly;
    rot_t(xa, -dx, -dy, lx, ly);
    const int ia_new = support(A, lx, ly);
    rot_t(xb, dx, dy, lx, ly);
    const int ib_new = support(B, lx, ly);
    bool dup = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dup = dup || (k < count_save && ia_save[k] == ia_new && ib_save[k] == ib_new);
    }
    done = done || dup;
    if (done) break;

    float wax, way, wbx, wby;
    vert(A, ia_new, lx, ly);
    to_world(xa, lx, ly, wax, way);
    vert(B, ib_new, lx, ly);
    to_world(xb, lx, ly, wbx, wby);
    const int idx = min(max(s.count, 0), 2);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (idx == k) {
        s.wax[k] = wax;
        s.way[k] = way;
        s.wbx[k] = wbx;
        s.wby[k] = wby;
        s.ia[k] = ia_new;
        s.ib[k] = ib_new;
      }
    }
    s.count += 1;
  }

  float pax = 0.0f, pay = 0.0f, pbx = 0.0f, pby = 0.0f;
  float bw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) bw[k] = k < s.count ? s.bary[k] : 0.0f;
  pax = (bw[0] * s.wax[0] + bw[1] * s.wax[1]) + bw[2] * s.wax[2];
  pay = (bw[0] * s.way[0] + bw[1] * s.way[1]) + bw[2] * s.way[2];
  pbx = (bw[0] * s.wbx[0] + bw[1] * s.wbx[1]) + bw[2] * s.wbx[2];
  pby = (bw[0] * s.wby[0] + bw[1] * s.wby[1]) + bw[2] * s.wby[2];
  if (s.count == 3) {
    pbx = pax;
    pby = pay;
  }
  const float dx = pbx - pax, dy = pby - pay;
  return sqrtf(dx * dx + dy * dy);
}

// ---- separating function (distance._sep_initialize/_sep_eval/_sep_min) --

// axis and local point of face (i0, i1) of P, pointing at world point w
__device__ __forceinline__ void face(const Proxy& P, int i0, int i1, const Xf& x,
                                     float wx, float wy, SepFn& f) {
  float v1x, v1y, v2x, v2y;
  vert(P, i0, v1x, v1y);
  vert(P, i1, v2x, v2y);
  const float ex = v2x - v1x, ey = v2y - v1y;
  float axx, axy;
  normalize(ey, -ex, axx, axy);
  const float lpx = 0.5f * (v1x + v2x), lpy = 0.5f * (v1y + v2y);
  float pwx, pwy;
  to_world(x, lpx, lpy, pwx, pwy);
  const float nwx = x.c * axx - x.s * axy;
  const float nwy = x.s * axx + x.c * axy;
  const float s = (wx - pwx) * nwx + (wy - pwy) * nwy;
  if (s < 0.0f) {
    axx = -axx;
    axy = -axy;
  }
  f.axx = axx;
  f.axy = axy;
  f.lpx = lpx;
  f.lpy = lpy;
}

__device__ SepFn sep_initialize(const Simplex& s, const Proxy& A, const Proxy& B,
                                const Xf& xa, const Xf& xb) {
  SepFn f;
  const bool one = s.count == 1;
  const bool face_b = !one && s.ia[0] == s.ia[1];
  float lx, ly, wax, way, wbx, wby;
  vert(A, s.ia[0], lx, ly);
  to_world(xa, lx, ly, wax, way);
  vert(B, s.ib[0], lx, ly);
  to_world(xb, lx, ly, wbx, wby);
  if (one) {
    f.ftype = 0;
    normalize(wbx - wax, wby - way, f.axx, f.axy);
    f.lpx = 0.0f;
    f.lpy = 0.0f;
  } else if (face_b) {
    f.ftype = 2;
    face(B, s.ib[0], s.ib[1], xb, wax, way, f);
  } else {
    f.ftype = 1;
    face(A, s.ia[0], s.ia[1], xa, wbx, wby, f);
  }
  return f;
}

__device__ float sep_eval(const SepFn& f, const Proxy& A, const Proxy& B, int ia, int ib,
                          const Xf& xa, const Xf& xb) {
  float lx, ly, wax, way, wbx, wby;
  vert(A, max(ia, 0), lx, ly);
  to_world(xa, lx, ly, wax, way);
  vert(B, max(ib, 0), lx, ly);
  to_world(xb, lx, ly, wbx, wby);
  if (f.ftype == 0) return (wbx - wax) * f.axx + (wby - way) * f.axy;
  const Xf& x = f.ftype == 1 ? xa : xb;
  float pwx, pwy;
  to_world(x, f.lpx, f.lpy, pwx, pwy);
  const float nx = x.c * f.axx - x.s * f.axy;
  const float ny = x.s * f.axx + x.c * f.axy;
  if (f.ftype == 1) return (wbx - pwx) * nx + (wby - pwy) * ny;
  return (wax - pwx) * nx + (way - pwy) * ny;
}

__device__ float sep_min(const SepFn& f, const Proxy& A, const Proxy& B, const Xf& xa,
                         const Xf& xb, int& ia, int& ib) {
  float lx, ly;
  if (f.ftype == 0) {
    rot_t(xa, f.axx, f.axy, lx, ly);
    ia = support(A, lx, ly);
    rot_t(xb, -f.axx, -f.axy, lx, ly);
    ib = support(B, lx, ly);
  } else if (f.ftype == 1) {
    const float nx = xa.c * f.axx - xa.s * f.axy;
    const float ny = xa.s * f.axx + xa.c * f.axy;
    rot_t(xb, -nx, -ny, lx, ly);
    ia = -1;
    ib = support(B, lx, ly);
  } else {
    const float nx = xb.c * f.axx - xb.s * f.axy;
    const float ny = xb.s * f.axx + xb.c * f.axy;
    rot_t(xa, -nx, -ny, lx, ly);
    ia = support(A, lx, ly);
    ib = -1;
  }
  return sep_eval(f, A, B, ia, ib, xa, xb);
}

// ---- the lane --------------------------------------------------------------

struct Lanes {
  const float* __restrict__ verts_a;
  const int* __restrict__ count_a;
  const float* __restrict__ radius_a;
  const float* __restrict__ sweep_a;
  const float* __restrict__ verts_b;
  const int* __restrict__ count_b;
  const float* __restrict__ radius_b;
  const float* __restrict__ sweep_b;
  const float* __restrict__ t_max;
  const uint8_t* __restrict__ active;
  int* __restrict__ state;
  float* __restrict__ t;
  int n;
};

// b2TimeOfImpact for one active lane. Each transform is computed once for
// each time it is needed at: the window's end once a lane, t1 once an
// outer trip (it is also the push loop's first t1p, and an advance makes
// the held t2 the next t1), and t2 again only where the root finder
// converged at a new time.
__device__ __forceinline__ void solve_lane(const Lanes& L, int lane) {
  const size_t n = (size_t)L.n;
  Proxy A, B;
#pragma unroll
  for (int r = 0; r < kNV; ++r) {
    A.vx[r] = L.verts_a[r * n + lane];
    A.vy[r] = L.verts_a[(kNV + r) * n + lane];
    B.vx[r] = L.verts_b[r * n + lane];
    B.vy[r] = L.verts_b[(kNV + r) * n + lane];
  }
  A.count = L.count_a[lane];
  B.count = L.count_b[lane];
  const float* sa = L.sweep_a + lane;
  const float* sb = L.sweep_b + lane;
  const Sweep wa{sa[0], sa[n], sa[2 * n], sa[3 * n], sa[4 * n], sa[5 * n], sa[6 * n], sa[7 * n]};
  const Sweep wb{sb[0], sb[n], sb[2 * n], sb[3 * n], sb[4 * n], sb[5 * n], sb[6 * n], sb[7 * n]};
  const float t_max = L.t_max[lane];

  const float total_radius = L.radius_a[lane] + L.radius_b[lane];
  const float target = fmaxf(total_radius - kTargetMargin, kLinearSlop);
  const float hi = target + kTolerance;
  const float lo = target - kTolerance;

  int state = kUnknown;
  float t_out = t_max;
  float t1 = 0.0f;
  bool done = false;
  Simplex s;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.ia[k] = 0;
    s.ib[k] = 0;
  }
  s.count = 1;
  const Xf xam = sweep_xf(wa, t_max), xbm = sweep_xf(wb, t_max);
  Xf xa1 = sweep_xf(wa, t1), xb1 = sweep_xf(wb, t1);   // at t1, then at t1p

  for (int it = 0; it < kToiIters && !done; ++it) {
    const float dist = gjk(A, B, xa1, xb1, s, s.count);
    const bool overlapped = dist <= 0.0f;
    const bool touching = !overlapped && dist < hi;
    if (overlapped) {
      state = kOverlapped;
      t_out = 0.0f;
    } else if (touching) {
      state = kTouching;
      t_out = t1;
    }
    const bool done_o = overlapped || touching;
    const SepFn f = sep_initialize(s, A, B, xa1, xb1);

    // push-back loop over the deepest points
    float t1p = t1, t2 = t_max;
    Xf xa2 = xam, xb2 = xbm;                          // at t2
    bool pdone = done_o, odone = false;
    for (int pk = 0; pk < kPushIters && !pdone; ++pk) {
      int wia, wib;
      const float s2 = sep_min(f, A, B, xa2, xb2, wia, wib);
      const bool separated = s2 > hi;
      if (separated) {
        state = kSeparated;
        t_out = t_max;
      }
      const bool advance = !separated && s2 > lo;
      const float t1_next = advance ? t2 : t1p;
      const float s1 = sep_eval(f, A, B, wia, wib, xa1, xb1);
      const bool open = !separated && !advance;
      const bool failed = open && s1 < lo;
      const bool touch1 = open && !failed && s1 <= hi;
      if (failed) {
        state = kFailed;
        t_out = t1p;
      } else if (touch1) {
        state = kTouching;
        t_out = t1p;
      }
      odone = odone || separated || failed || touch1;
      pdone = separated || advance || failed || touch1;
      if (advance) {
        xa1 = xa2;
        xb1 = xb2;
      }
      if (!pdone) {
        // hybrid secant/bisection root find for sep(t) == target
        float a1 = t1p, a2 = t2, s1r = s1, s2r = s2;
        for (int k = 0; k < kRootIters; ++k) {
          float t;
          if (k & 1) {
            t = a1 + (target - s1r) * (a2 - a1) / (s2r != s1r ? s2r - s1r : 1.0f);
          } else {
            t = 0.5f * (a1 + a2);
          }
          const Xf xa3 = sweep_xf(wa, t), xb3 = sweep_xf(wb, t);
          const float sr = sep_eval(f, A, B, wia, wib, xa3, xb3);
          if (fabsf(sr - target) < kTolerance) {
            t2 = t;
            xa2 = xa3;
            xb2 = xb3;
            break;
          }
          if (sr > target) {
            a1 = t;
            s1r = sr;
          } else {
            a2 = t;
            s2r = sr;
          }
        }
      }
      t1p = t1_next;
    }
    if (!done_o) t1 = t1p;
    done = done_o || odone;
  }
  if (!done) {
    state = kFailed;
    t_out = t1;
  }
  L.state[lane] = state;
  L.t[lane] = t_out;
}

// ---- the launch: active lanes compacted inside each block -----------------

constexpr int kSegment = 8 * kThreads;  // lanes a block compacts at a time

// A block walks its span of lanes [first, last) in segments: every thread
// reads up to 8 lanes' `active` (writing an inactive lane's outputs at
// once), each warp appends its active lanes to a queue in shared memory
// (ballot, popc, one shared atomic), and the block's warps solve the
// queue 32 lanes a warp. Nothing is shared between blocks.
__global__ void __launch_bounds__(kThreads, 1) toi_kernel(const Lanes L, int span) {
  __shared__ int queue[kSegment];
  __shared__ int n_queued;
  const int me = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << me) - 1u;
  const int first = blockIdx.x * span;
  const int last = min(first + span, L.n);
  for (int seg = first; seg < last; seg += kSegment) {
    if (threadIdx.x == 0) n_queued = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSegment / kThreads; ++k) {
      const int lane = seg + k * kThreads + threadIdx.x;
      const bool in = lane < last;
      const bool on = in && L.active[lane];
      if (in && !on) {
        L.state[lane] = kUnknown;
        L.t[lane] = L.t_max[lane];
      }
      const unsigned mask = __ballot_sync(~0u, on);
      int base = 0;
      if (me == 0 && mask) base = atomicAdd(&n_queued, __popc(mask));
      base = __shfl_sync(~0u, base, 0);
      if (on) queue[base + __popc(mask & below)] = lane;
    }
    __syncthreads();
    const int n_active = n_queued;
    for (int i = 32 * warp + me; i - me < n_active; i += kThreads) {
      if (i < n_active) solve_lane(L, queue[i]);
    }
    __syncthreads();
  }
}

// The grid for n lanes: at most as many blocks as the SMs hold at once (one
// wave), each a contiguous span of lanes, a multiple of 32 and at least
// 128, so that a sparse round's active lanes fill whole warps.
int grid(int n_lanes, int* span) {
  static int resident[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return -1;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, toi_kernel, kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return -1;
    resident[dev] = per_sm * sms;
  }
  if (resident[dev] <= 0) return -1;
  int blocks = min(resident[dev], (n_lanes + 127) / 128);
  *span = ((n_lanes + blocks - 1) / blocks + 31) / 32 * 32;
  return (n_lanes + *span - 1) / *span;
}

}  // namespace

extern "C" int toi_launch(const float* verts_a, const int* count_a, const float* radius_a,
                          const float* sweep_a, const float* verts_b, const int* count_b,
                          const float* radius_b, const float* sweep_b, const float* t_max,
                          const uint8_t* active, int* state, float* t, int n_lanes,
                          void* stream) {
  if (n_lanes <= 0) return 0;
  int span = 0;
  const int blocks = grid(n_lanes, &span);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const Lanes L{verts_a, count_a, radius_a, sweep_a, verts_b, count_b, radius_b, sweep_b,
                t_max,   active,  state,    t,       n_lanes};
  toi_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(L, span);
  return (int)cudaGetLastError();
}

// the grid for n lanes: returns the blocks and writes each block's span
extern "C" int toi_grid(int n_lanes, int* span) { return grid(n_lanes, span); }
