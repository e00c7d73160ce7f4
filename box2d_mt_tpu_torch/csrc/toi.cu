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

// ---- K8: toi_substep_kernel ------------------------------------------------
//
// The passes of a TOI sub-step (b2Island::SolveTOI, b2Island.cpp:385-523),
// one thread a lane, in one launch: 20 position passes at TOI_BAUMGARTE
// (b2ContactSolver::SolveTOIPositionConstraints, b2ContactSolver.cpp:
// 780-806), the velocity constraints at the solved pose without warm start
// (the constructor and InitializeVelocityConstraints, :142-249) and the
// velocity iterations (:293-603), the lane's mini-island neighbors
// included. It replaces no TPU kernel: the JAX package runs these passes as
// XLA ops inside `_solve_toi_b` (box2d_mt_tpu/world.py:981-1946). The
// argument contract and the plain PyTorch version it is held against
// (`toi_substep_passes_plain`: eager operations over all lanes at once, the
// neighbors rank by rank) are in ops/toi.py; this code runs the same
// arithmetic in the same order, built with --fmad=false, so the two agree
// to the bit on a card.
//
// Why one thread a lane does it all: the selected pairs of a round are
// disjoint on their non-static bodies, and a neighbor constraint moves only
// its parent lane's TOI body in the position passes (its other endpoint
// has zero mass there and sits at its tentative advance) and carries its
// own copy of the other endpoint's velocity in the velocity passes. So a
// lane's passes read nothing another lane writes: the lane applies its own
// constraint, then its kept neighbors in slot order (the plain version's
// ranks), pass after pass, with both bodies' pose in registers. Its
// neighbors' velocity data is recomputed at each iteration from their
// rows (the same bits each time) rather than kept, since their number is
// the data's. Nothing is read back to the host: a lane's neighbors come
// as a span of `nb_order`.
//
// What bounds it on an H100: latency. A solved lane's chain is 20 passes of
// two points (two sincosf and ~60 dependent operations a point) and the
// velocity iterations; the bytes (121 B a lane, 92 more a solved one, 176
// a kept neighbor: chip_smoke.py `substep_bytes`) are tiny. A lane that is
// not solved and keeps no neighbor copies its inputs out; a neighbor no
// lane keeps gets zero impulses and its own velocity from the thread of
// its index.

namespace {

constexpr int kSubstepThreads = 128;
// box2d_mt_tpu_torch/settings.py, rounded to float as the Python side does
constexpr float kToiBaumgarte = 0.75f;
constexpr float kMaxLinearCorrection = 0.2f;
constexpr float kVelocityThreshold = 1.0f;
constexpr int kFaceA = 1;
constexpr int kFaceB = 2;

struct SubstepArgs {
  // lanes: L of them
  const uint8_t* solve;
  const int* kind;         // (2, L) manifold type, point count
  const float* manifold;   // (8, L) local point, local normal, points 0 and 1
  const float* body;       // (10, L) inverse masses a, b, inertias a, b, centers, radii
  const float* material;   // (3, L) friction, restitution, tangent speed
  const float* pose;       // (6, L) c_a, a_a, c_b, a_b
  const float* vel;        // (6, L) v_a, w_a, v_b, w_b
  const int* nb_span;      // (2, L) first kept neighbor in nb_order, their count
  // neighbors: N of them
  const int* nb_parent;    // (N,) the parent lane of a kept neighbor, -1 otherwise
  const int* nb_order;     // (N,) neighbor indices by (parent lane, slot)
  const int* nb_kind;      // (4, N) manifold type, point count, TOI body is A, parent side A
  const float* nb_manifold;  // (8, N)
  const float* nb_body;    // (14, N) position masses (4), velocity masses (4), centers, radii
  const float* nb_material;  // (3, N)
  const float* nb_other;   // (6, N) the other endpoint: c, a at its advance, v, w
  float* pose_out;         // (6, L)
  float* vel_out;          // (6, L)
  float* imp_out;          // (4, L) normal 0, 1, tangent 0, 1
  float* nb_imp_out;       // (4, N)
  float* nb_vel_out;       // (3, N) the other endpoint's velocity copy
  int n_lanes, n_nb, passes, iterations;
};

// A contact's manifold and constants, with the inverse masses of the pass
// at hand.
struct Contact {
  int type, count;
  float lpx, lpy, lnx, lny, mpx[2], mpy[2];
  float ma, mb, ia, ib;
  float lcax, lcay, lcbx, lcby, ra, rb;
  float fr, rest, ts;
};

// Velocity-constraint data (velocity_contact_math_s's arguments after the
// masses).
struct VelCon {
  float nx, ny, rax[2], ray[2], rbx[2], rby[2], nm[2], tm[2], bias[2];
  float k11, k12, k22, nm11, nm12, nm22;
  int pc;
};

__device__ __forceinline__ void load_manifold(Contact& k, const float* rows, int n, int i) {
  k.lpx = rows[i];
  k.lpy = rows[n + i];
  k.lnx = rows[2 * n + i];
  k.lny = rows[3 * n + i];
  k.mpx[0] = rows[4 * n + i];
  k.mpy[0] = rows[5 * n + i];
  k.mpx[1] = rows[6 * n + i];
  k.mpy[1] = rows[7 * n + i];
}

__device__ Contact lane_contact(const SubstepArgs& A, int i) {
  const int n = A.n_lanes;
  Contact k;
  k.type = A.kind[i];
  k.count = A.kind[n + i];
  load_manifold(k, A.manifold, n, i);
  const float* b = A.body;
  k.ma = b[i];
  k.mb = b[n + i];
  k.ia = b[2 * n + i];
  k.ib = b[3 * n + i];
  k.lcax = b[4 * n + i];
  k.lcay = b[5 * n + i];
  k.lcbx = b[6 * n + i];
  k.lcby = b[7 * n + i];
  k.ra = b[8 * n + i];
  k.rb = b[9 * n + i];
  k.fr = A.material[i];
  k.rest = A.material[n + i];
  k.ts = A.material[2 * n + i];
  return k;
}

// A neighbor's contact with its position-pass masses (only the TOI body
// moves) or its velocity-pass masses (both endpoints' own).
__device__ Contact neighbor_contact(const SubstepArgs& A, int id, bool velocity) {
  const int n = A.n_nb;
  Contact k;
  k.type = A.nb_kind[id];
  k.count = A.nb_kind[n + id];
  load_manifold(k, A.nb_manifold, n, id);
  const float* b = A.nb_body + (velocity ? 4 * n : 0);
  k.ma = b[id];
  k.mb = b[n + id];
  k.ia = b[2 * n + id];
  k.ib = b[3 * n + id];
  const float* c = A.nb_body + 8 * n;
  k.lcax = c[id];
  k.lcay = c[n + id];
  k.lcbx = c[2 * n + id];
  k.lcby = c[3 * n + id];
  k.ra = c[4 * n + id];
  k.rb = c[5 * n + id];
  k.fr = A.nb_material[id];
  k.rest = A.nb_material[n + id];
  k.ts = A.nb_material[2 * n + id];
  return k;
}

// One position pass over both manifold points (position_contact_math_s
// with _psm_s, same operation order; only the contact's own manifold type
// is evaluated: the plain version computes all three and selects, and the
// selected expression is the same). p: c_a, a_a, c_b, a_b.
__device__ void position_pass(const Contact& k, bool m, float p[6]) {
  float cax = p[0], cay = p[1], aa = p[2], cbx = p[3], cby = p[4], ab = p[5];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool has = m && (j < k.count);
    float qas, qac, qbs, qbc;
    sincosf(aa, &qas, &qac);
    sincosf(ab, &qbs, &qbc);
    const float pax = cax - (qac * k.lcax - qas * k.lcay);
    const float pay = cay - (qas * k.lcax + qac * k.lcay);
    const float pbx = cbx - (qbc * k.lcbx - qbs * k.lcby);
    const float pby = cby - (qbs * k.lcbx + qbc * k.lcby);

    // b2PositionSolverManifold::Initialize
    const float clx = k.mpx[j], cly = k.mpy[j];
    float nx, ny, px, py, sep;
    if (k.type == kFaceA) {
      const float pAx = qac * k.lpx - qas * k.lpy + pax;
      const float pAy = qas * k.lpx + qac * k.lpy + pay;
      nx = qac * k.lnx - qas * k.lny;
      ny = qas * k.lnx + qac * k.lny;
      px = qbc * clx - qbs * cly + pbx;
      py = qbs * clx + qbc * cly + pby;
      sep = (px - pAx) * nx + (py - pAy) * ny - k.ra - k.rb;
    } else if (k.type == kFaceB) {
      const float nbx = qbc * k.lnx - qbs * k.lny;
      const float nby = qbs * k.lnx + qbc * k.lny;
      const float plane_bx = qbc * k.lpx - qbs * k.lpy + pbx;
      const float plane_by = qbs * k.lpx + qbc * k.lpy + pby;
      px = qac * clx - qas * cly + pax;
      py = qas * clx + qac * cly + pay;
      sep = (px - plane_bx) * nbx + (py - plane_by) * nby - k.ra - k.rb;
      nx = -nbx;
      ny = -nby;
    } else {
      const float pAx = qac * k.lpx - qas * k.lpy + pax;
      const float pAy = qas * k.lpx + qac * k.lpy + pay;
      const float pBx = qbc * k.mpx[0] - qbs * k.mpy[0] + pbx;
      const float pBy = qbs * k.mpx[0] + qbc * k.mpy[0] + pby;
      const float dx = pBx - pAx, dy = pBy - pAy;
      const float dist = sqrtf(dx * dx + dy * dy);
      nx = dist > 0.0f ? dx / dist : 0.0f;
      ny = dist > 0.0f ? dy / dist : 0.0f;
      px = 0.5f * (pAx + pBx);
      py = 0.5f * (pAy + pBy);
      sep = dx * nx + dy * ny - k.ra - k.rb;
    }

    const float r_ax = px - cax, r_ay = py - cay;
    const float r_bx = px - cbx, r_by = py - cby;
    const float corr = fminf(fmaxf(kToiBaumgarte * (sep + kLinearSlop),
                                   -kMaxLinearCorrection), 0.0f);
    const float rn_a = r_ax * ny - r_ay * nx;
    const float rn_b = r_bx * ny - r_by * nx;
    const float kk = k.ma + k.mb + k.ia * rn_a * rn_a + k.ib * rn_b * rn_b;
    const float impulse = (has && kk > 0.0f) ? -corr / kk : 0.0f;
    const float ix = impulse * nx, iy = impulse * ny;
    cax = cax - k.ma * ix;
    cay = cay - k.ma * iy;
    aa = aa - k.ia * (r_ax * iy - r_ay * ix);
    cbx = cbx + k.mb * ix;
    cby = cby + k.mb * iy;
    ab = ab + k.ib * (r_bx * iy - r_by * ix);
  }
  p[0] = cax;
  p[1] = cay;
  p[2] = aa;
  p[3] = cbx;
  p[4] = cby;
  p[5] = ab;
}

// The velocity constraint of a contact at pose p with velocities v
// (ops/toi.py `_velocity_prep` over solver.world_manifold, same operation
// order; the manifold type's own branch only).
__device__ VelCon velocity_prep(const Contact& k, const float p[6], const float v[6]) {
  float qas, qac, qbs, qbc;
  sincosf(p[2], &qas, &qac);
  sincosf(p[5], &qbs, &qbc);
  const float pax = p[0] - (qac * k.lcax - qas * k.lcay);
  const float pay = p[1] - (qas * k.lcax + qac * k.lcay);
  const float pbx = p[3] - (qbc * k.lcbx - qbs * k.lcby);
  const float pby = p[4] - (qbs * k.lcbx + qbc * k.lcby);

  // b2WorldManifold::Initialize: the normal and the two points
  float nx, ny, ptx[2], pty[2];
  if (k.type == kFaceA) {
    nx = qac * k.lnx - qas * k.lny;
    ny = qas * k.lnx + qac * k.lny;
    const float plx = (qac * k.lpx - qas * k.lpy) + pax;
    const float ply = (qas * k.lpx + qac * k.lpy) + pay;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float clx = (qbc * k.mpx[j] - qbs * k.mpy[j]) + pbx;
      const float cly = (qbs * k.mpx[j] + qbc * k.mpy[j]) + pby;
      const float s = k.ra - ((clx - plx) * nx + (cly - ply) * ny);
      const float cax = clx + s * nx, cay = cly + s * ny;
      const float cbx = clx - k.rb * nx, cby = cly - k.rb * ny;
      ptx[j] = 0.5f * (cax + cbx);
      pty[j] = 0.5f * (cay + cby);
    }
  } else if (k.type == kFaceB) {
    const float nbx = qbc * k.lnx - qbs * k.lny;
    const float nby = qbs * k.lnx + qbc * k.lny;
    const float plx = (qbc * k.lpx - qbs * k.lpy) + pbx;
    const float ply = (qbs * k.lpx + qbc * k.lpy) + pby;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float clx = (qac * k.mpx[j] - qas * k.mpy[j]) + pax;
      const float cly = (qas * k.mpx[j] + qac * k.mpy[j]) + pay;
      const float s = k.rb - ((clx - plx) * nbx + (cly - ply) * nby);
      const float cbx = clx + s * nbx, cby = cly + s * nby;
      const float cax = clx - k.ra * nbx, cay = cly - k.ra * nby;
      ptx[j] = 0.5f * (cax + cbx);
      pty[j] = 0.5f * (cay + cby);
    }
    nx = -nbx;
    ny = -nby;
  } else {
    const float pAx = (qac * k.lpx - qas * k.lpy) + pax;
    const float pAy = (qas * k.lpx + qac * k.lpy) + pay;
    const float pBx = (qbc * k.mpx[0] - qbs * k.mpy[0]) + pbx;
    const float pBy = (qbs * k.mpx[0] + qbc * k.mpy[0]) + pby;
    const float dx = pBx - pAx, dy = pBy - pAy;
    const float dd = dx * dx + dy * dy;
    const float ln = sqrtf(dd);
    const float ux = ln < kTiny ? 0.0f : dx / ln;
    const float uy = ln < kTiny ? 0.0f : dy / ln;
    nx = dd > kEps2 ? ux : 1.0f;
    ny = dd > kEps2 ? uy : 0.0f;
    const float cax = pAx + k.ra * nx, cay = pAy + k.ra * ny;
    const float cbx = pBx - k.rb * nx, cby = pBy - k.rb * ny;
    ptx[0] = 0.5f * (cax + cbx);
    pty[0] = 0.5f * (cay + cby);
    ptx[1] = 0.0f;
    pty[1] = 0.0f;
  }

  VelCon c;
  c.nx = nx;
  c.ny = ny;
  const float tx = ny, ty = -nx;
  const float msum = k.ma + k.mb;
  float kn[2], rn_a[2], rn_b[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float rax = ptx[j] - p[0], ray = pty[j] - p[1];
    const float rbx = ptx[j] - p[3], rby = pty[j] - p[4];
    c.rax[j] = rax;
    c.ray[j] = ray;
    c.rbx[j] = rbx;
    c.rby[j] = rby;
    rn_a[j] = rax * ny - ray * nx;
    rn_b[j] = rbx * ny - rby * nx;
    kn[j] = msum + k.ia * (rn_a[j] * rn_a[j]) + k.ib * (rn_b[j] * rn_b[j]);
    c.nm[j] = kn[j] > 0.0f ? 1.0f / kn[j] : 0.0f;
    const float rt_a = rax * ty - ray * tx;
    const float rt_b = rbx * ty - rby * tx;
    const float kt = msum + k.ia * (rt_a * rt_a) + k.ib * (rt_b * rt_b);
    c.tm[j] = kt > 0.0f ? 1.0f / kt : 0.0f;
    const float dvx = v[3] - v[5] * rby - v[0] + v[2] * ray;
    const float dvy = v[4] + v[5] * rbx - v[1] - v[2] * rax;
    const float v_rel = dvx * nx + dvy * ny;
    c.bias[j] = v_rel < -kVelocityThreshold ? -k.rest * v_rel : 0.0f;
  }
  c.k11 = kn[0];
  c.k22 = kn[1];
  c.k12 = msum + k.ia * rn_a[0] * rn_a[1] + k.ib * rn_b[0] * rn_b[1];
  const float det = c.k11 * c.k22 - c.k12 * c.k12;
  const bool well = c.k11 * c.k11 < 1000.0f * det;
  c.pc = (k.count == 2 && !well) ? 1 : k.count;
  const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
  c.nm11 = inv_det * c.k22;
  c.nm12 = -inv_det * c.k12;
  c.nm22 = inv_det * c.k11;
  return c;
}

// One velocity iteration of a contact (velocity_contact_math_s, same
// operation order). v: v_a, w_a, v_b, w_b.
__device__ void velocity_pass(const VelCon& c, const Contact& k, bool m, float ni[2],
                              float ti[2], float v[6]) {
  float vax = v[0], vay = v[1], wa = v[2], vbx = v[3], vby = v[4], wb = v[5];
  const float nx = c.nx, ny = c.ny, tx = ny, ty = -nx;
  const float ma = k.ma, mb = k.mb, iA = k.ia, iB = k.ib;

  // friction, point by point (reference order: j = 0 then 1)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool has = m && (j < c.pc);
    const float dvx = vbx - wb * c.rby[j] - vax + wa * c.ray[j];
    const float dvy = vby + wb * c.rbx[j] - vay - wa * c.rax[j];
    const float vt = dvx * tx + dvy * ty - k.ts;
    float lam = c.tm[j] * (-vt);
    const float max_f = k.fr * ni[j];
    const float new_imp = fminf(fmaxf(ti[j] + lam, -max_f), max_f);
    lam = has ? new_imp - ti[j] : 0.0f;
    ti[j] = has ? new_imp : ti[j];
    const float px = lam * tx, py = lam * ty;
    vax = vax - ma * px;
    vay = vay - ma * py;
    wa = wa - iA * (c.rax[j] * py - c.ray[j] * px);
    vbx = vbx + mb * px;
    vby = vby + mb * py;
    wb = wb + iB * (c.rbx[j] * py - c.rby[j] * px);
  }

  // normal: 1-point scalar path
  {
    const bool one_pt = m && c.pc == 1;
    const float dvx = vbx - wb * c.rby[0] - vax + wa * c.ray[0];
    const float dvy = vby + wb * c.rbx[0] - vay - wa * c.rax[0];
    const float vn0 = dvx * nx + dvy * ny;
    const float lam0 = -c.nm[0] * (vn0 - c.bias[0]);
    const float new0 = fmaxf(ni[0] + lam0, 0.0f);
    const float dlam0 = one_pt ? new0 - ni[0] : 0.0f;
    const float px = dlam0 * nx, py = dlam0 * ny;
    vax = vax - ma * px;
    vay = vay - ma * py;
    wa = wa - iA * (c.rax[0] * py - c.ray[0] * px);
    vbx = vbx + mb * px;
    vby = vby + mb * py;
    wb = wb + iB * (c.rbx[0] * py - c.rby[0] * px);
    ni[0] = one_pt ? new0 : ni[0];
  }

  // normal: 2-point block LCP by total enumeration
  {
    const bool two_pt = m && c.pc == 2;
    const float a1 = ni[0], a2 = ni[1];
    const float dv1x = vbx - wb * c.rby[0] - vax + wa * c.ray[0];
    const float dv1y = vby + wb * c.rbx[0] - vay - wa * c.rax[0];
    const float dv2x = vbx - wb * c.rby[1] - vax + wa * c.ray[1];
    const float dv2y = vby + wb * c.rbx[1] - vay - wa * c.rax[1];
    const float vn1 = dv1x * nx + dv1y * ny;
    const float vn2 = dv2x * nx + dv2y * ny;
    const float b1 = vn1 - c.bias[0] - (c.k11 * a1 + c.k12 * a2);
    const float b2 = vn2 - c.bias[1] - (c.k12 * a1 + c.k22 * a2);

    const float x1_1 = -(c.nm11 * b1 + c.nm12 * b2);
    const float x2_1 = -(c.nm12 * b1 + c.nm22 * b2);
    const bool ok1 = (x1_1 >= 0.0f) && (x2_1 >= 0.0f);
    const float x1_2 = -c.nm[0] * b1;
    const float vn2_2 = c.k12 * x1_2 + b2;
    const bool ok2 = (x1_2 >= 0.0f) && (vn2_2 >= 0.0f);
    const float x2_3 = -c.nm[1] * b2;
    const float vn1_3 = c.k12 * x2_3 + b1;
    const bool ok3 = (x2_3 >= 0.0f) && (vn1_3 >= 0.0f);
    const bool ok4 = (b1 >= 0.0f) && (b2 >= 0.0f);
    // "no solution, give up" keeps the accumulated impulse (d = 0)
    const float x1 = ok1 ? x1_1 : ok2 ? x1_2 : ok3 ? 0.0f : ok4 ? 0.0f : a1;
    const float x2 = ok1 ? x2_1 : ok2 ? 0.0f : ok3 ? x2_3 : ok4 ? 0.0f : a2;

    const float d1 = two_pt ? x1 - a1 : 0.0f;
    const float d2 = two_pt ? x2 - a2 : 0.0f;
    const float p1x = d1 * nx, p1y = d1 * ny;
    const float p2x = d2 * nx, p2y = d2 * ny;
    vax = vax - ma * (p1x + p2x);
    vay = vay - ma * (p1y + p2y);
    wa = wa - iA * ((c.rax[0] * p1y - c.ray[0] * p1x) + (c.rax[1] * p2y - c.ray[1] * p2x));
    vbx = vbx + mb * (p1x + p2x);
    vby = vby + mb * (p1y + p2y);
    wb = wb + iB * ((c.rbx[0] * p1y - c.rby[0] * p1x) + (c.rbx[1] * p2y - c.rby[1] * p2x));
    ni[0] = two_pt ? x1 : ni[0];
    ni[1] = two_pt ? x2 : ni[1];
  }
  v[0] = vax;
  v[1] = vay;
  v[2] = wa;
  v[3] = vbx;
  v[4] = vby;
  v[5] = wb;
}

// The neighbor's two endpoints: the TOI body's three values `own`, the
// other endpoint's `other`; `toi_a` says which endpoint of the neighbor
// the TOI body is.
__device__ __forceinline__ void endpoints(bool toi_a, const float own[3], const float other[3],
                                          float q[6]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    q[r] = toi_a ? own[r] : other[r];
    q[3 + r] = toi_a ? other[r] : own[r];
  }
}

// The TOI body's three values of a lane's six (`side_a`: the lane's
// endpoint A), and the lane's six plus a change d of the TOI body's, as
// the plain version's scatter adds it.
__device__ __forceinline__ void own_of(bool side_a, const float lane[6], float own[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) own[r] = side_a ? lane[r] : lane[3 + r];
}

__device__ __forceinline__ void add_own(bool side_a, const float d[3], float lane[6]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (side_a) {
      lane[r] = lane[r] + d[r];
    } else {
      lane[3 + r] = lane[3 + r] + d[r];
    }
  }
}

// A kept neighbor's position constraint against the live TOI-body pose
// (the other endpoint at its tentative advance, with zero mass).
__device__ void neighbor_position(const SubstepArgs& A, int id, float p[6]) {
  const int n = A.n_nb;
  const Contact k = neighbor_contact(A, id, false);
  const bool toi_a = A.nb_kind[2 * n + id] != 0;
  const bool side_a = A.nb_kind[3 * n + id] != 0;
  const float other[3] = {A.nb_other[id], A.nb_other[n + id], A.nb_other[2 * n + id]};
  float own[3], q[6], d[3];
  own_of(side_a, p, own);
  endpoints(toi_a, own, other, q);
  position_pass(k, true, q);
#pragma unroll
  for (int r = 0; r < 3; ++r) d[r] = (toi_a ? q[r] : q[3 + r]) - own[r];
  add_own(side_a, d, p);
}

// A kept neighbor's velocity iteration: its constraint at the solved pose
// p and the velocities before the iterations v0, against the live TOI-body
// velocity v and its own copy of the other endpoint's velocity.
__device__ void neighbor_velocity(const SubstepArgs& A, int id, const float p[6],
                                  const float v0[6], float v[6]) {
  const int n = A.n_nb;
  const Contact k = neighbor_contact(A, id, true);
  const bool toi_a = A.nb_kind[2 * n + id] != 0;
  const bool side_a = A.nb_kind[3 * n + id] != 0;
  const float* oth = A.nb_other;
  const float other_pose[3] = {oth[id], oth[n + id], oth[2 * n + id]};
  const float other_vel[3] = {oth[3 * n + id], oth[4 * n + id], oth[5 * n + id]};
  float own[3], q[6], w0[6];
  own_of(side_a, p, own);
  endpoints(toi_a, own, other_pose, q);
  own_of(side_a, v0, own);
  endpoints(toi_a, own, other_vel, w0);
  const VelCon c = velocity_prep(k, q, w0);

  float* imp = A.nb_imp_out;
  float* ovo = A.nb_vel_out;
  float ni[2] = {imp[id], imp[n + id]}, ti[2] = {imp[2 * n + id], imp[3 * n + id]};
  const float ov[3] = {ovo[id], ovo[n + id], ovo[2 * n + id]};
  float u[6], d[3];
  own_of(side_a, v, own);
  endpoints(toi_a, own, ov, u);
  velocity_pass(c, k, true, ni, ti, u);
#pragma unroll
  for (int r = 0; r < 3; ++r) d[r] = (toi_a ? u[r] : u[3 + r]) - own[r];
  add_own(side_a, d, v);
  imp[id] = ni[0];
  imp[n + id] = ni[1];
  imp[2 * n + id] = ti[0];
  imp[3 * n + id] = ti[1];
  ovo[id] = toi_a ? u[3] : u[0];
  ovo[n + id] = toi_a ? u[4] : u[1];
  ovo[2 * n + id] = toi_a ? u[5] : u[2];
}

__global__ void __launch_bounds__(kSubstepThreads) toi_substep_kernel(const SubstepArgs A) {
  const int i = blockIdx.x * kSubstepThreads + threadIdx.x;
  const int nn = A.n_nb;
  if (i < nn && A.nb_parent[i] < 0) {
    // a neighbor no lane keeps: as the plain passes leave it
#pragma unroll
    for (int r = 0; r < 4; ++r) A.nb_imp_out[r * nn + i] = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) A.nb_vel_out[r * nn + i] = A.nb_other[(3 + r) * nn + i];
  }
  const int nl = A.n_lanes;
  if (i >= nl) return;
  const bool on = A.solve[i] != 0;
  const int start = A.nb_span[i], count = A.nb_span[nl + i];
  float p[6], v0[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    p[r] = A.pose[r * nl + i];
    v0[r] = A.vel[r * nl + i];
  }
  float ni[2] = {0.0f, 0.0f}, ti[2] = {0.0f, 0.0f};
  float v[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) v[r] = v0[r];

  if (on || count > 0) {
    const Contact k = lane_contact(A, i);
    // 20 position passes: the lane's constraint, then its kept neighbors
    for (int pass = 0; pass < A.passes; ++pass) {
      position_pass(k, on, p);
      for (int r = 0; r < count; ++r) neighbor_position(A, A.nb_order[start + r], p);
    }
    // the velocity solve at the solved pose, without warm start
    const VelCon c = velocity_prep(k, p, v0);
    for (int r = 0; r < count; ++r) {
      const int id = A.nb_order[start + r];
#pragma unroll
      for (int e = 0; e < 4; ++e) A.nb_imp_out[e * nn + id] = 0.0f;
#pragma unroll
      for (int e = 0; e < 3; ++e) A.nb_vel_out[e * nn + id] = A.nb_other[(3 + e) * nn + id];
    }
    for (int it = 0; it < A.iterations; ++it) {
      velocity_pass(c, k, on, ni, ti, v);
      for (int r = 0; r < count; ++r) neighbor_velocity(A, A.nb_order[start + r], p, v0, v);
    }
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    A.pose_out[r * nl + i] = p[r];
    A.vel_out[r * nl + i] = v[r];
  }
  A.imp_out[i] = ni[0];
  A.imp_out[nl + i] = ni[1];
  A.imp_out[2 * nl + i] = ti[0];
  A.imp_out[3 * nl + i] = ti[1];
}

}  // namespace

extern "C" int toi_substep_launch(const uint8_t* solve, const int* kind, const float* manifold,
                                  const float* body, const float* material, const float* pose,
                                  const float* vel, const int* nb_span, const int* nb_parent,
                                  const int* nb_order, const int* nb_kind,
                                  const float* nb_manifold, const float* nb_body,
                                  const float* nb_material, const float* nb_other,
                                  float* pose_out, float* vel_out, float* imp_out,
                                  float* nb_imp_out, float* nb_vel_out, int n_lanes, int n_nb,
                                  int passes, int iterations, void* stream) {
  const int n = n_lanes > n_nb ? n_lanes : n_nb;
  if (n <= 0) return 0;
  const SubstepArgs A{solve,    kind,     manifold,   body,       material,   pose,
                      vel,      nb_span,  nb_parent,  nb_order,   nb_kind,    nb_manifold,
                      nb_body,  nb_material, nb_other, pose_out,  vel_out,    imp_out,
                      nb_imp_out, nb_vel_out, n_lanes, n_nb,      passes,     iterations};
  const int blocks = (n + kSubstepThreads - 1) / kSubstepThreads;
  toi_substep_kernel<<<blocks, kSubstepThreads, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
