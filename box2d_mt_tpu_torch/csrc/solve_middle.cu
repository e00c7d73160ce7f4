// Contact solve middle for a batch of worlds: the whole middle as one
// kernel, one thread block per world (K1, joint-free worlds) and, further
// down, the same work as four kernels around the joint passes (K3-K6, "the
// sandwich"; each has its own header). This header is K1's.
//
// K1 replaces the TPU kernel box2d_mt_tpu/ops/pallas_solve.py `_kernel` /
// `solve_middle_pallas` (:273-349): pack the slot-order constraint rows into
// color-major order, run the velocity Gauss-Seidel sweeps color by color
// (friction + 2-point block LCP, b2ContactSolver.cpp:293-603), integrate
// positions with the translation/rotation clamps (b2Island.cpp:283-313),
// run the NGS position sweeps (b2ContactSolver.cpp:676-752) and unpack the
// impulses and min separation to slot order. The argument contract and the
// plain PyTorch version it is held against are in ops/solve_middle.py.
//
// Its bound on an H100 (the least time for this work): bytes. The kernel
// needs the blob rows, perm and dyn_ab entries of the solved lanes only
// (color_start[:, -1] a world), the body planes in and out, and the
// (W, 5, C) aux out. At 512 x pyramid(10) (C = 256 contact slots, 100
// solved a world, N = 64 bodies) that is 15.0 MB: 4.47 us at 3.35 TB/s,
// against ~1 us for its flops (about 130 per solved lane per velocity
// iteration and 260 per position iteration, at 67 TFLOP/s in f32).
// chip_smoke.py computes it from each run's inputs and holds the kernel's
// time on the device (a replayed CUDA graph of launches, no wrapper in it)
// against it. No single PyTorch call computes the same function.
//
// What holds it back on an H100: not flops (a lane is ~200 flops) but latency —
// every color pass ends in a block barrier, so a sweep costs about
// (colors x barrier + one dependent chain of shared-memory reads) per
// world, and worlds only overlap each other. The design keeps the body
// state (v, w, c, a, movable: 6 floats + 1 byte per body, 25 KB at 1024
// bodies, plus 8 KB for one overflow chunk) in shared memory so each pass
// reads and writes bodies there, and streams the packed constraint rows
// from global memory (coalesced: lane p of a pass reads column p). Other
// worlds' blocks on the same SM (register use allows two blocks of 256
// threads) run while one waits at a barrier.
//
// Races: within a color the coloring makes lanes conflict-free on DYNAMIC
// bodies only; static bodies are shared. A lane therefore writes back only
// the endpoints flagged dynamic in dyn_ab (every other endpoint's delta is
// exactly zero). The last color (max_colors - 1) holds the coloring's
// overflow, whose lanes may share dynamic bodies: it runs in chunks of
// kChunk lanes that all read the chunk-start state, and one thread then
// applies their deltas in lane order (deterministic, no float atomics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 51;          // pack_cc_blob_t rows
constexpr int kMinSepRow = 51;     // extra scratch row
constexpr int kScratchRows = 52;
constexpr int kAuxRows = 5;
constexpr int kChunk = 256;        // overflow-color chunk width (the Pallas CK)
constexpr int kThreads = 256;      // == kChunk: one lane per thread in a chunk

// box2d_mt_tpu_torch/settings.py, rounded to float as the Python side does
constexpr float kLinearSlop = 0.005f;
constexpr float kBaumgarte = 0.2f;
constexpr float kMaxLinearCorrection = 0.2f;
constexpr float kMaxTranslation = 2.0f;
constexpr float kMaxTranslationSquared = 4.0f;
constexpr double kMaxRotationD = 0.5 * 3.14159265358979323846;
constexpr float kMaxRotation = (float)kMaxRotationD;
constexpr float kMaxRotationSquared = (float)(kMaxRotationD * kMaxRotationD);
constexpr int kFaceA = 1;
constexpr int kFaceB = 2;

struct Rows {
  const float* p;
  int C;
  int lane;
  __device__ float operator()(int k) const { return p[(size_t)k * C + lane]; }
};

// One velocity lane (velocity_contact_math_s, same operation order).
// Body rows in `s`: [vx | vy | w], each n wide. Writes the lane's impulses
// back to the packed rows and returns the six body deltas.
template <class RowsT>
__device__ void velocity_lane(const RowsT R, float* P, int C, int lane, const float* s,
                              int n, float d[6], int* ia_out, int* ib_out) {
  const bool m = R(0) > 0.5f;
  const int ia = (int)R(1), ib = (int)R(2), pc = (int)R(3);
  const float fr = R(4), ts = R(5), ma = R(6), mb = R(7), iA = R(8), iB = R(9);
  const float nx = R(10), ny = R(11);
  const float rax[2] = {R(12), R(14)}, ray[2] = {R(13), R(15)};
  const float rbx[2] = {R(16), R(18)}, rby[2] = {R(17), R(19)};
  const float nm[2] = {R(20), R(21)}, tm[2] = {R(22), R(23)};
  const float bias[2] = {R(24), R(25)};
  const float k11 = R(26), k12 = R(27), k22 = R(28);
  const float nm11 = R(29), nm12 = R(30), nm22 = R(31);
  float ni[2] = {R(47), R(48)}, ti[2] = {R(49), R(50)};

  const float vax0 = s[ia], vay0 = s[n + ia], wa0 = s[2 * n + ia];
  const float vbx0 = s[ib], vby0 = s[n + ib], wb0 = s[2 * n + ib];
  float vax = vax0, vay = vay0, wa = wa0, vbx = vbx0, vby = vby0, wb = wb0;
  const float tx = ny, ty = -nx;

  // friction, point by point (reference order: j = 0 then 1)
  for (int j = 0; j < 2; ++j) {
    const bool has = m && (j < pc);
    const float dvx = vbx - wb * rby[j] - vax + wa * ray[j];
    const float dvy = vby + wb * rbx[j] - vay - wa * rax[j];
    const float vt = dvx * tx + dvy * ty - ts;
    float lam = tm[j] * (-vt);
    const float max_f = fr * ni[j];
    const float new_imp = fminf(fmaxf(ti[j] + lam, -max_f), max_f);
    lam = has ? new_imp - ti[j] : 0.0f;
    ti[j] = has ? new_imp : ti[j];
    const float px = lam * tx, py = lam * ty;
    vax = vax - ma * px;
    vay = vay - ma * py;
    wa = wa - iA * (rax[j] * py - ray[j] * px);
    vbx = vbx + mb * px;
    vby = vby + mb * py;
    wb = wb + iB * (rbx[j] * py - rby[j] * px);
  }

  // normal: 1-point scalar path
  {
    const bool one_pt = m && pc == 1;
    const float dvx = vbx - wb * rby[0] - vax + wa * ray[0];
    const float dvy = vby + wb * rbx[0] - vay - wa * rax[0];
    const float vn0 = dvx * nx + dvy * ny;
    const float lam0 = -nm[0] * (vn0 - bias[0]);
    const float new0 = fmaxf(ni[0] + lam0, 0.0f);
    const float dlam0 = one_pt ? new0 - ni[0] : 0.0f;
    const float px = dlam0 * nx, py = dlam0 * ny;
    vax = vax - ma * px;
    vay = vay - ma * py;
    wa = wa - iA * (rax[0] * py - ray[0] * px);
    vbx = vbx + mb * px;
    vby = vby + mb * py;
    wb = wb + iB * (rbx[0] * py - rby[0] * px);
    ni[0] = one_pt ? new0 : ni[0];
  }

  // normal: 2-point block LCP by total enumeration
  {
    const bool two_pt = m && pc == 2;
    const float a1 = ni[0], a2 = ni[1];
    const float dv1x = vbx - wb * rby[0] - vax + wa * ray[0];
    const float dv1y = vby + wb * rbx[0] - vay - wa * rax[0];
    const float dv2x = vbx - wb * rby[1] - vax + wa * ray[1];
    const float dv2y = vby + wb * rbx[1] - vay - wa * rax[1];
    const float vn1 = dv1x * nx + dv1y * ny;
    const float vn2 = dv2x * nx + dv2y * ny;
    const float b1 = vn1 - bias[0] - (k11 * a1 + k12 * a2);
    const float b2 = vn2 - bias[1] - (k12 * a1 + k22 * a2);

    const float x1_1 = -(nm11 * b1 + nm12 * b2);
    const float x2_1 = -(nm12 * b1 + nm22 * b2);
    const bool ok1 = (x1_1 >= 0.0f) && (x2_1 >= 0.0f);
    const float x1_2 = -nm[0] * b1;
    const float vn2_2 = k12 * x1_2 + b2;
    const bool ok2 = (x1_2 >= 0.0f) && (vn2_2 >= 0.0f);
    const float x2_3 = -nm[1] * b2;
    const float vn1_3 = k12 * x2_3 + b1;
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
    wa = wa - iA * ((rax[0] * p1y - ray[0] * p1x) + (rax[1] * p2y - ray[1] * p2x));
    vbx = vbx + mb * (p1x + p2x);
    vby = vby + mb * (p1y + p2y);
    wb = wb + iB * ((rbx[0] * p1y - rby[0] * p1x) + (rbx[1] * p2y - rby[1] * p2x));
    ni[0] = two_pt ? x1 : ni[0];
    ni[1] = two_pt ? x2 : ni[1];
  }

  P[(size_t)47 * C + lane] = ni[0];
  P[(size_t)48 * C + lane] = ni[1];
  P[(size_t)49 * C + lane] = ti[0];
  P[(size_t)50 * C + lane] = ti[1];
  d[0] = m ? vax - vax0 : 0.0f;
  d[1] = m ? vay - vay0 : 0.0f;
  d[2] = m ? wa - wa0 : 0.0f;
  d[3] = m ? vbx - vbx0 : 0.0f;
  d[4] = m ? vby - vby0 : 0.0f;
  d[5] = m ? wb - wb0 : 0.0f;
  *ia_out = ia;
  *ib_out = ib;
}

// One position lane (position_contact_math_s with _psm_s, same operation
// order). Body rows in `s`: [cx | cy | a]. Stores min(0, separation).
template <class RowsT>
__device__ void position_lane(const RowsT R, float* P, int C, int lane, const float* s,
                              int n, float d[6], int* ia_out, int* ib_out) {
  const bool m = R(0) > 0.5f;
  const int ia = (int)R(1), ib = (int)R(2), pc = (int)R(3);
  const float ma = R(6), mb = R(7), iA = R(8), iB = R(9);
  const float mpx[2] = {R(32), R(34)}, mpy[2] = {R(33), R(35)};
  const float lnx = R(36), lny = R(37), lpx = R(38), lpy = R(39);
  const float ra = R(40), rb = R(41);
  const float lcax = R(42), lcay = R(43), lcbx = R(44), lcby = R(45);
  const int mtype = (int)R(46);
  const bool is_a = mtype == kFaceA, is_b = mtype == kFaceB;

  const float cax0 = s[ia], cay0 = s[n + ia], aa0 = s[2 * n + ia];
  const float cbx0 = s[ib], cby0 = s[n + ib], ab0 = s[2 * n + ib];
  float cax = cax0, cay = cay0, aa = aa0, cbx = cbx0, cby = cby0, ab = ab0;
  float min_sep = 0.0f;

  for (int j = 0; j < 2; ++j) {
    const bool has = m && (j < pc);
    const float qas = sinf(aa), qac = cosf(aa);
    const float qbs = sinf(ab), qbc = cosf(ab);
    const float pax = cax - (qac * lcax - qas * lcay);
    const float pay = cay - (qas * lcax + qac * lcay);
    const float pbx = cbx - (qbc * lcbx - qbs * lcby);
    const float pby = cby - (qbs * lcbx + qbc * lcby);

    // b2PositionSolverManifold::Initialize
    const float pAx = qac * lpx - qas * lpy + pax;
    const float pAy = qas * lpx + qac * lpy + pay;
    const float pBx = qbc * mpx[0] - qbs * mpy[0] + pbx;
    const float pBy = qbs * mpx[0] + qbc * mpy[0] + pby;
    const float dx = pBx - pAx, dy = pBy - pAy;
    const float dist = sqrtf(dx * dx + dy * dy);
    const float ncx = dist > 0.0f ? dx / dist : 0.0f;
    const float ncy = dist > 0.0f ? dy / dist : 0.0f;
    const float ptcx = 0.5f * (pAx + pBx), ptcy = 0.5f * (pAy + pBy);
    const float sep_c = dx * ncx + dy * ncy - ra - rb;

    const float clx = mpx[j], cly = mpy[j];
    const float nax = qac * lnx - qas * lny;
    const float nay = qas * lnx + qac * lny;
    const float cAx = qbc * clx - qbs * cly + pbx;
    const float cAy = qbs * clx + qbc * cly + pby;
    const float sep_a = (cAx - pAx) * nax + (cAy - pAy) * nay - ra - rb;
    const float nbx = qbc * lnx - qbs * lny;
    const float nby = qbs * lnx + qbc * lny;
    const float plane_bx = qbc * lpx - qbs * lpy + pbx;
    const float plane_by = qbs * lpx + qbc * lpy + pby;
    const float cBx = qac * clx - qas * cly + pax;
    const float cBy = qas * clx + qac * cly + pay;
    const float sep_b = (cBx - plane_bx) * nbx + (cBy - plane_by) * nby - ra - rb;

    const float nx = is_a ? nax : is_b ? -nbx : ncx;
    const float ny = is_a ? nay : is_b ? -nby : ncy;
    const float px = is_a ? cAx : is_b ? cBx : ptcx;
    const float py = is_a ? cAy : is_b ? cBy : ptcy;
    const float sep = is_a ? sep_a : is_b ? sep_b : sep_c;

    const float r_ax = px - cax, r_ay = py - cay;
    const float r_bx = px - cbx, r_by = py - cby;
    min_sep = has ? fminf(min_sep, sep) : min_sep;
    const float corr = fminf(fmaxf(kBaumgarte * (sep + kLinearSlop),
                                   -kMaxLinearCorrection), 0.0f);
    const float rn_a = r_ax * ny - r_ay * nx;
    const float rn_b = r_bx * ny - r_by * nx;
    const float k = ma + mb + iA * rn_a * rn_a + iB * rn_b * rn_b;
    const float impulse = (has && k > 0.0f) ? -corr / k : 0.0f;
    const float ix = impulse * nx, iy = impulse * ny;
    cax = cax - ma * ix;
    cay = cay - ma * iy;
    aa = aa - iA * (r_ax * iy - r_ay * ix);
    cbx = cbx + mb * ix;
    cby = cby + mb * iy;
    ab = ab + iB * (r_bx * iy - r_by * ix);
  }

  P[(size_t)kMinSepRow * C + lane] = m ? min_sep : 0.0f;
  d[0] = m ? cax - cax0 : 0.0f;
  d[1] = m ? cay - cay0 : 0.0f;
  d[2] = m ? aa - aa0 : 0.0f;
  d[3] = m ? cbx - cbx0 : 0.0f;
  d[4] = m ? cby - cby0 : 0.0f;
  d[5] = m ? ab - ab0 : 0.0f;
  *ia_out = ia;
  *ib_out = ib;
}

__device__ __forceinline__ void add3(float* s, int n, int b, const float* d) {
  s[b] += d[0];
  s[n + b] += d[1];
  s[2 * n + b] += d[2];
}

// One sweep over every color: conflict-free colors as one parallel pass,
// the overflow color in Jacobi chunks applied in lane order.
template <bool kVelocity>
__device__ void sweep(float* P, int C, const int* cs, int mc, const int* perm,
                      const uint8_t* dyn, float* s, int n, float* sd, int* sidx) {
  for (int c = 0; c < mc; ++c) {
    const int s0 = cs[c], s1 = cs[c + 1];
    if (s0 >= s1) continue;  // same for every thread of the block
    if (c < mc - 1) {
      for (int p = s0 + threadIdx.x; p < s1; p += blockDim.x) {
        float d[6];
        int ia, ib;
        if (kVelocity) velocity_lane(Rows{P, C, p}, P, C, p, s, n, d, &ia, &ib);
        else position_lane(Rows{P, C, p}, P, C, p, s, n, d, &ia, &ib);
        const uint8_t f = dyn[perm[p]];
        if (f & 1) add3(s, n, ia, d);
        if (f & 2) add3(s, n, ib, d + 3);
      }
      __syncthreads();
    } else {
      for (int ch = s0; ch < s1; ch += kChunk) {
        const int cnt = min(kChunk, s1 - ch);
        const int l = threadIdx.x;
        if (l < cnt) {
          float d[6];
          int ia, ib;
          if (kVelocity) velocity_lane(Rows{P, C, ch + l}, P, C, ch + l, s, n, d, &ia, &ib);
          else position_lane(Rows{P, C, ch + l}, P, C, ch + l, s, n, d, &ia, &ib);
          const uint8_t f = dyn[perm[ch + l]];
          for (int q = 0; q < 6; ++q) sd[6 * l + q] = d[q];
          sidx[2 * l] = (f & 1) ? ia : -1;
          sidx[2 * l + 1] = (f & 2) ? ib : -1;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          for (int q = 0; q < cnt; ++q) {
            if (sidx[2 * q] >= 0) add3(s, n, sidx[2 * q], sd + 6 * q);
            if (sidx[2 * q + 1] >= 0) add3(s, n, sidx[2 * q + 1], sd + 6 * q + 3);
          }
        }
        __syncthreads();
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
solve_middle_kernel(const float* __restrict__ blob, const int* __restrict__ perm,
                    const int* __restrict__ color_start,
                    const uint8_t* __restrict__ dyn_ab,
                    const float* __restrict__ vel, const float* __restrict__ pos,
                    const uint8_t* __restrict__ movable,
                    float* __restrict__ vel_out, float* __restrict__ pos_out,
                    float* __restrict__ aux, float* __restrict__ scratch,
                    int n, int C, int mc, int vi, int pi, float dt) {
  extern __shared__ float smem[];
  float* sv = smem;                          // [vx | vy | w]
  float* sp = smem + 3 * n;                  // [cx | cy | a]
  float* sd = smem + 6 * n;                  // overflow chunk deltas
  int* sidx = reinterpret_cast<int*>(sd + 6 * kChunk);
  uint8_t* smov = reinterpret_cast<uint8_t*>(sidx + 2 * kChunk);

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const float* B = blob + (size_t)w * kRows * C;
  const int* pw = perm + (size_t)w * C;
  const int* cs = color_start + (size_t)w * (mc + 1);
  const uint8_t* dyn = dyn_ab + (size_t)w * C;
  float* P = scratch + (size_t)w * kScratchRows * C;
  const size_t bo = (size_t)w * 3 * n;

  for (int i = tid; i < 3 * n; i += blockDim.x) {
    sv[i] = vel[bo + i];
    sp[i] = pos[bo + i];
  }
  for (int i = tid; i < n; i += blockDim.x) smov[i] = movable[(size_t)w * n + i];

  // pack: slot-order rows -> color-major packed order
  const int total = cs[mc];
  for (int p = tid; p < total; p += blockDim.x) {
    const int slot = pw[p];
    for (int k = 0; k < kRows; ++k) P[(size_t)k * C + p] = B[(size_t)k * C + slot];
    P[(size_t)kMinSepRow * C + p] = 0.0f;
  }
  __syncthreads();

  for (int it = 0; it < vi; ++it) sweep<true>(P, C, cs, mc, pw, dyn, sv, n, sd, sidx);

  // integrate positions with the translation/rotation clamps
  const float dt2 = dt * dt;
  for (int i = tid; i < n; i += blockDim.x) {
    float vx = sv[i], vy = sv[n + i], wz = sv[2 * n + i];
    const float t2 = dt2 * (vx * vx + vy * vy);
    const float tlen = sqrtf(fmaxf(t2, 1e-30f));
    const float rt = t2 > kMaxTranslationSquared ? kMaxTranslation / tlen : 1.0f;
    vx = vx * rt;
    vy = vy * rt;
    const float rot = dt * wz;
    const float rr = rot * rot > kMaxRotationSquared
                         ? kMaxRotation / fabsf(rot == 0.0f ? 1.0f : rot) : 1.0f;
    wz = wz * rr;
    sv[i] = vx;
    sv[n + i] = vy;
    sv[2 * n + i] = wz;
    if (smov[i]) {
      sp[i] = sp[i] + dt * vx;
      sp[n + i] = sp[n + i] + dt * vy;
      sp[2 * n + i] = sp[2 * n + i] + dt * wz;
    }
  }
  __syncthreads();

  for (int it = 0; it < pi; ++it) sweep<false>(P, C, cs, mc, pw, dyn, sp, n, sd, sidx);

  for (int i = tid; i < 3 * n; i += blockDim.x) {
    vel_out[bo + i] = sv[i];
    pos_out[bo + i] = sp[i];
  }
  // unpack: impulses + min separation back to slot order (0 when unused)
  float* A = aux + (size_t)w * kAuxRows * C;
  for (int i = tid; i < kAuxRows * C; i += blockDim.x) A[i] = 0.0f;
  __syncthreads();
  for (int p = tid; p < total; p += blockDim.x) {
    const int slot = pw[p];
    for (int r = 0; r < 4; ++r) A[(size_t)r * C + slot] = P[(size_t)(47 + r) * C + p];
    A[(size_t)4 * C + slot] = P[(size_t)kMinSepRow * C + p];
  }
}

// ---------------------------------------------------------------------------
// The sandwich for worlds with joints: the same pack, sweeps and unpack as
// four kernels, one contact iteration per launch, so that the joint passes
// (PyTorch) run between them in the reference island order. They replace
// the TPU kernels pack_packed, vel_iter_packed, pos_iter_packed and
// unpack_packed (box2d_mt_tpu/ops/pallas_solve.py:363, :396, :429, :462).
// The packed table P (W, 52, C: the 51 rows and min_sep) lives in global
// memory between launches; a velocity sweep updates its impulse rows 47-50
// in place, a position sweep its min_sep row. Body planes go through
// shared memory inside a launch and through global memory between
// launches. Bounds: bytes, for each of the four (the solved lanes' rows of
// P, perm, dyn_ab and the body planes); chip_smoke.py computes them, and
// times an empty kernel beside them: a bound of a few microseconds lies at
// or below what any launch costs, so the sweeps and the unpack are held to
// that floor as well.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
pack_packed_kernel(const float* __restrict__ blob, const int* __restrict__ perm,
                   const int* __restrict__ color_start, float* __restrict__ packed,
                   int C, int mc) {
  const int w = blockIdx.x;
  const float* B = blob + (size_t)w * kRows * C;
  const int* pw = perm + (size_t)w * C;
  float* P = packed + (size_t)w * kScratchRows * C;
  const int total = color_start[(size_t)w * (mc + 1) + mc];
  for (int p = threadIdx.x; p < total; p += blockDim.x) {
    const int slot = pw[p];
    for (int k = 0; k < kRows; ++k) P[(size_t)k * C + p] = B[(size_t)k * C + slot];
    P[(size_t)kMinSepRow * C + p] = 0.0f;
  }
}

// ---- K4 / K5: one sweep over a (W, 3, n) body plane ------------------------
//
// What bounds a sweep on an H100 is latency, not its bytes (13.5 MB at
// 256 x tumbler(200): 4 us) nor its flops: a world's colors run one after
// the other (the tumbler: 15 colors and an overflow chunk), and each pass
// is one warp's worth of lanes running a lane's few hundred dependent
// instructions. That chain of passes cannot be shortened here (the
// arithmetic and its order are fixed), so the design takes everything
// else off it:
//
//   * the table is color-major, so row k of a world is one contiguous run
//     of lanes. At kernel entry a world's threads start asynchronous
//     16-byte copies (cp.async) of the needed rows (36 for a velocity
//     sweep, 23 for a position sweep) of its first tiles of `tile` lanes
//     into shared memory; the color passes read shared memory only. A
//     world with more lanes than the buffers hold walks its tiles through
//     the ring, the next tile's copies in flight while this one is swept.
//     color_start, the body plane and the lanes' dynamic-endpoint flags
//     (dyn_ab through perm) are staged by plain loads while the copies
//     fly. A table whose rows are not 16-byte aligned (C not a multiple
//     of 4) is staged by plain loads. (One 1-D bulk copy a row,
//     cp.async.bulk on an mbarrier, measured no faster: a row's run is
//     about 1 KB, and the copies are then bound by their count.)
//   * a world gets `tw` threads (one warp at 128 slots, 256 threads from
//     1024) and a block holds several worlds; a world's threads meet at a
//     named barrier of their own width (__syncwarp for one warp), not at
//     a block barrier. The host picks tw, the worlds a block, the tile
//     and the ring depth from the static shapes (ops/solve_middle.py
//     `sweep_shape`).
//   * the overflow chunk's deltas are applied by all threads, each owning
//     bodies and scanning the chunk's endpoints in lane order, so every
//     body receives its deltas in the order the serial apply gave them
//     (bit-identical), in ~cnt compares a thread.
//   * a lane's impulses (or min_sep) go straight to global memory: stores
//     of neighbouring lanes to neighbouring addresses, off the chain.
//
// Splitting a color at a tile border changes nothing: its lanes share no
// dynamic body. An overflow chunk that straddles a border computes all its
// lanes from the chunk-start state (nothing is applied in between) and is
// applied once complete.

// Rows of the packed table that a sweep reads, as staged rows 0..kR-1:
// velocity 0-31 and 47-50; position 0-3, 6-9 and 32-46.
constexpr int kVelRows = 36;
constexpr int kPosRows = 23;

template <bool kVelocity>
__device__ __forceinline__ int table_row(int r) {
  if (kVelocity) return r < 32 ? r : r + 15;
  return r < 4 ? r : r < 8 ? r + 2 : r + 24;
}

template <bool kVelocity>
struct StagedRows {
  const float* p;   // the tile in shared memory, `stride` lanes a row
  int stride;
  int lane;         // within the tile
  __device__ float operator()(int k) const {
    const int r = kVelocity ? (k < 32 ? k : k - 15) : (k < 4 ? k : k < 10 ? k - 2 : k - 24);
    return p[r * stride + lane];
  }
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// One world's shared memory, in bytes from its base (all 16-byte aligned).
// ops/solve_middle.py `_sweep_world_bytes` repeats the sum.
struct StagedLayout {
  int sd, sidx, body, cs, dyn, bytes;
  __host__ __device__ StagedLayout(int rows, int n, int C, int mc, int tile, int nbuf) {
    const int chunk = C < kChunk ? (C + 31) & ~31 : kChunk;   // lanes an overflow chunk can hold
    sd = nbuf * rows * tile * 4;          // after the row buffers
    sidx = sd + 6 * chunk * 4;
    body = sidx + 2 * chunk * 4;
    cs = body + align16(3 * n * 4);
    dyn = cs + align16((mc + 1) * 4);
    bytes = dyn + align16(C);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The threads of one world: barrier `id` (1..15; 0 is __syncthreads') of
// `width` threads, or the warp's own when the world has one warp.
struct Group {
  int id, width;
  __device__ __forceinline__ void sync() const {
    if (width == 32) __syncwarp();
    else asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(width) : "memory");
  }
};

// Start staging lanes [t0, t0 + cnt) of the needed rows into `dst` (`tile`
// lanes a row): 16-byte asynchronous copies, one group a tile and thread
// (t0 and C are multiples of 4, so a rounded-up run stays inside its row),
// or plain loads where the rows are not 16-byte aligned.
template <bool kVelocity>
__device__ void load_tile(const float* P, int C, float* dst, int t0, int cnt, int tile,
                          int tid, int tw, bool aligned) {
  constexpr int kR = kVelocity ? kVelRows : kPosRows;
  if (aligned) {
    const int q = (cnt + 3) / 4;
    for (int i = tid; i < kR * q; i += tw) {
      const int r = i / q, l = (i - r * q) * 4;
      cp_async16(dst + r * tile + l, P + (size_t)table_row<kVelocity>(r) * C + t0 + l);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < kR * cnt; i += tw) {
      const int r = i / cnt, l = i - r * cnt;
      dst[r * tile + l] = P[(size_t)table_row<kVelocity>(r) * C + t0 + l];
    }
  }
}

// Apply an overflow chunk's deltas in lane order (A endpoint, then B):
// each thread owns bodies and sums their deltas in a register.
__device__ void apply_chunk(float* s, int n, const float* sd, const int2* sidx, int cnt,
                            int tid, int tw) {
  for (int b = tid; b < n; b += tw) {
    float x = s[b], y = s[n + b], z = s[2 * n + b];
    bool hit = false;
    for (int q = 0; q < cnt; ++q) {
      const int2 e = sidx[q];
      if (e.x == b) {
        x += sd[6 * q];
        y += sd[6 * q + 1];
        z += sd[6 * q + 2];
        hit = true;
      }
      if (e.y == b) {
        x += sd[6 * q + 3];
        y += sd[6 * q + 4];
        z += sd[6 * q + 5];
        hit = true;
      }
    }
    if (hit) {
      s[b] = x;
      s[n + b] = y;
      s[2 * n + b] = z;
    }
  }
}

template <bool kVelocity>
__global__ void __launch_bounds__(kThreads)
iter_packed_kernel(float* __restrict__ packed, const int* __restrict__ perm,
                   const int* __restrict__ color_start,
                   const uint8_t* __restrict__ dyn_ab,
                   const float* __restrict__ body_in, float* __restrict__ body_out,
                   int n_worlds, int n, int C, int mc, int tw, int tile, int nbuf,
                   int aligned) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kR = kVelocity ? kVelRows : kPosRows;
  const StagedLayout lay(kR, n, C, mc, tile, nbuf);
  const int group = threadIdx.x / tw, tid = threadIdx.x - group * tw;
  unsigned char* base = smem_raw + (size_t)group * lay.bytes;
  float* srows = reinterpret_cast<float*>(base);
  float* sd = reinterpret_cast<float*>(base + lay.sd);       // overflow chunk deltas
  int2* sidx = reinterpret_cast<int2*>(base + lay.sidx);     // and endpoints (-1: none)
  float* sb = reinterpret_cast<float*>(base + lay.body);     // the three body rows
  int* scs = reinterpret_cast<int*>(base + lay.cs);
  uint8_t* sdyn = base + lay.dyn;                            // dyn_ab in packed order

  const int w = blockIdx.x * (blockDim.x / tw) + group;
  if (w >= n_worlds) return;

  const Group g{group + 1, tw};
  float* P = packed + (size_t)w * kScratchRows * C;
  const int* cs = color_start + (size_t)w * (mc + 1);
  const int* pw = perm + (size_t)w * C;
  const uint8_t* dyn = dyn_ab + (size_t)w * C;
  const size_t bo = (size_t)w * 3 * n;
  const int total = min(cs[mc], C);
  const int n_tiles = (total + tile - 1) / tile;

  for (int j = 0; j < min(nbuf, n_tiles); ++j)
    load_tile<kVelocity>(P, C, srows + (size_t)j * kR * tile, j * tile,
                         min(tile, total - j * tile), tile, tid, tw, aligned);
  for (int i = tid; i <= mc; i += tw) scs[i] = cs[i];
  for (int i = tid; i < 3 * n; i += tw) sb[i] = body_in[bo + i];
  for (int p = tid; p < total; p += tw) sdyn[p] = dyn[pw[p]];

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j % nbuf;
    const int t0 = j * tile, t1 = min(t0 + tile, total);
    const float* T = srows + (size_t)buf * kR * tile;
    if (aligned) {
      // this tile's group has landed once at most the newest one (the
      // next tile's, where one was started) is pending
      if (nbuf > 1 && j + 1 < n_tiles) cp_async_wait<1>();
      else cp_async_wait<0>();
    }
    g.sync();  // every thread's share of the tile is in place
    for (int c = 0; c < mc; ++c) {
      const int c0 = scs[c], c1 = scs[c + 1];
      const int s0 = max(c0, t0), s1 = min(c1, t1);
      if (s0 >= s1) continue;  // same for every thread of the world
      if (c < mc - 1) {
        for (int p = s0 + tid; p < s1; p += tw) {
          float d[6];
          int ia, ib;
          const StagedRows<kVelocity> R{T, tile, p - t0};
          if constexpr (kVelocity) velocity_lane(R, P, C, p, sb, n, d, &ia, &ib);
          else position_lane(R, P, C, p, sb, n, d, &ia, &ib);
          const uint8_t f = sdyn[p];
          if (f & 1) add3(sb, n, ia, d);
          if (f & 2) add3(sb, n, ib, d + 3);
        }
        g.sync();
      } else {
        // the chunks start at c0, c0 + kChunk, ...: the first one here is
        // the chunk that holds lane s0
        for (int ch = c0 + (s0 - c0) / kChunk * kChunk; ch < s1; ch += kChunk) {
          const int ce = min(ch + kChunk, c1);
          for (int p = max(ch, s0) + tid; p < min(ce, s1); p += tw) {
            float d[6];
            int ia, ib;
            const StagedRows<kVelocity> R{T, tile, p - t0};
            if constexpr (kVelocity) velocity_lane(R, P, C, p, sb, n, d, &ia, &ib);
            else position_lane(R, P, C, p, sb, n, d, &ia, &ib);
            const uint8_t f = sdyn[p];
            const int l = p - ch;
            for (int q = 0; q < 6; ++q) sd[6 * l + q] = d[q];
            sidx[l] = make_int2((f & 1) ? ia : -1, (f & 2) ? ib : -1);
          }
          if (ce <= t1) {  // complete: the rest of a straddling chunk comes with the next tile
            g.sync();
            apply_chunk(sb, n, sd, sidx, ce - ch, tid, tw);
            g.sync();
          }
        }
      }
    }
    if (j + nbuf < n_tiles) {
      g.sync();  // every thread is done with this buffer
      load_tile<kVelocity>(P, C, srows + (size_t)buf * kR * tile, (j + nbuf) * tile,
                           min(tile, total - (j + nbuf) * tile), tile, tid, tw, aligned);
    }
  }
  for (int i = tid; i < 3 * n; i += tw) body_out[bo + i] = sb[i];
}

// ---- K6: impulses and min_sep back to slot order ---------------------------
//
// Bound: bytes, 7.0 MB at 256 x tumbler(200), of which 5.2 MB is the zero
// of the slots that were not solved: 2.1 us, at or below the cost of a
// launch. The kernel is a gather, not a fill and a scatter: a block
// inverts perm in shared memory (slot -> packed position or -1; C ints a
// world), then every thread writes 16 bytes of one aux row, each element
// exactly once: the packed value (a 4-byte gather, L2-resident) or 0. A
// world's five rows are spread over gridDim.y blocks, each rebuilding the
// inverse, as far as it takes to fill the card with a small batch; for
// small C a block takes several worlds (ops/solve_middle.py
// `unpack_shape`).
constexpr int kUnpackMaxWorlds = 8;

__global__ void __launch_bounds__(kThreads)
unpack_packed_kernel(const float* __restrict__ packed, const int* __restrict__ perm,
                     const int* __restrict__ color_start, float* __restrict__ aux,
                     int n_worlds, int C, int mc, int wpb, int vec) {
  extern __shared__ __align__(16) int inv[];   // wpb x C
  __shared__ int totals[kUnpackMaxWorlds];
  const int w0 = blockIdx.x * wpb;
  const int nw = min(wpb, n_worlds - w0);
  const int tid = threadIdx.x;
  if (tid < nw) totals[tid] = min(color_start[(size_t)(w0 + tid) * (mc + 1) + mc], C);
  for (int i = tid; i < nw * C; i += blockDim.x) inv[i] = -1;
  __syncthreads();
  for (int i = tid; i < nw * C; i += blockDim.x) {
    const int gw = i / C, p = i - gw * C;
    if (p < totals[gw]) {
      const int slot = perm[(size_t)w0 * C + i];
      if ((unsigned)slot < (unsigned)C) inv[gw * C + slot] = p;
    }
  }
  __syncthreads();
  for (int r = blockIdx.y; r < kAuxRows; r += gridDim.y) {
    const int row = r < 4 ? 47 + r : kMinSepRow;
    if (vec) {
      const int q = C / 4;
      for (int i = tid; i < nw * q; i += blockDim.x) {
        const int gw = i / q, s = (i - gw * q) * 4;
        const int4 iv = *reinterpret_cast<const int4*>(inv + gw * C + s);
        const float* src = packed + ((size_t)(w0 + gw) * kScratchRows + row) * C;
        float4 v;
        v.x = iv.x >= 0 ? src[iv.x] : 0.0f;
        v.y = iv.y >= 0 ? src[iv.y] : 0.0f;
        v.z = iv.z >= 0 ? src[iv.z] : 0.0f;
        v.w = iv.w >= 0 ? src[iv.w] : 0.0f;
        *reinterpret_cast<float4*>(aux + ((size_t)(w0 + gw) * kAuxRows + r) * C + s) = v;
      }
    } else {
      for (int i = tid; i < nw * C; i += blockDim.x) {
        const int gw = i / C, s = i - gw * C;
        const int p = inv[i];
        aux[((size_t)(w0 + gw) * kAuxRows + r) * C + s] =
            p >= 0 ? packed[((size_t)(w0 + gw) * kScratchRows + row) * C + p] : 0.0f;
      }
    }
  }
}

// What any launch costs on the card: chip_smoke.py times this beside the
// kernels, whose bounds can lie below it.
__global__ void empty_kernel() {}

// Dynamic shared memory above 48 KB is an opt-in per kernel function.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool kVelocity>
int iter_packed_launch(float* packed, const int* perm, const int* color_start,
                       const uint8_t* dyn_ab, const float* body_in, float* body_out,
                       int n_worlds, int n_bodies, int n_contacts, int max_colors,
                       int tw, int wpb, int tile, int nbuf, void* stream) {
  if (n_worlds <= 0) return 0;
  if (tw < 32 || tw % 32 != 0 || wpb < 1 || wpb > 15 || tw * wpb > kThreads ||
      tile < 32 || tile % 32 != 0 || nbuf < 1)
    return (int)cudaErrorInvalidValue;
  const StagedLayout lay(kVelocity ? kVelRows : kPosRows, n_bodies, n_contacts, max_colors, tile, nbuf);
  const size_t smem = (size_t)wpb * lay.bytes;
  const cudaError_t e = allow_smem(iter_packed_kernel<kVelocity>, smem);
  if (e != cudaSuccess) return (int)e;
  const int aligned = n_contacts % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  iter_packed_kernel<kVelocity>
      <<<(n_worlds + wpb - 1) / wpb, tw * wpb, smem, (cudaStream_t)stream>>>(
          packed, perm, color_start, dyn_ab, body_in, body_out, n_worlds, n_bodies,
          n_contacts, max_colors, tw, tile, nbuf, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int solve_middle_launch(const float* blob, const int* perm,
                                   const int* color_start, const uint8_t* dyn_ab,
                                   const float* vel, const float* pos,
                                   const uint8_t* movable, float* vel_out,
                                   float* pos_out, float* aux, float* scratch,
                                   int n_worlds, int n_bodies, int n_contacts,
                                   int max_colors, int velocity_iterations,
                                   int position_iterations, float dt,
                                   void* stream) {
  if (n_worlds <= 0) return 0;
  const size_t smem = (size_t)(6 * n_bodies + 6 * kChunk) * sizeof(float) +
                      2 * kChunk * sizeof(int) + (size_t)n_bodies;
  const cudaError_t e = allow_smem(solve_middle_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  solve_middle_kernel<<<n_worlds, kThreads, smem, (cudaStream_t)stream>>>(
      blob, perm, color_start, dyn_ab, vel, pos, movable, vel_out, pos_out, aux,
      scratch, n_bodies, n_contacts, max_colors, velocity_iterations,
      position_iterations, dt);
  return (int)cudaGetLastError();
}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int pack_packed_launch(const float* blob, const int* perm,
                                  const int* color_start, float* packed,
                                  int n_worlds, int n_contacts, int max_colors,
                                  void* stream) {
  if (n_worlds <= 0) return 0;
  pack_packed_kernel<<<n_worlds, kThreads, 0, (cudaStream_t)stream>>>(
      blob, perm, color_start, packed, n_contacts, max_colors);
  return (int)cudaGetLastError();
}

extern "C" int vel_iter_packed_launch(float* packed, const int* perm,
                                      const int* color_start, const uint8_t* dyn_ab,
                                      const float* vel, float* vel_out, int n_worlds,
                                      int n_bodies, int n_contacts, int max_colors,
                                      int threads_per_world, int worlds_per_block,
                                      int tile, int n_buffers, void* stream) {
  return iter_packed_launch<true>(packed, perm, color_start, dyn_ab, vel, vel_out,
                                  n_worlds, n_bodies, n_contacts, max_colors,
                                  threads_per_world, worlds_per_block, tile, n_buffers,
                                  stream);
}

extern "C" int pos_iter_packed_launch(float* packed, const int* perm,
                                      const int* color_start, const uint8_t* dyn_ab,
                                      const float* pos, float* pos_out, int n_worlds,
                                      int n_bodies, int n_contacts, int max_colors,
                                      int threads_per_world, int worlds_per_block,
                                      int tile, int n_buffers, void* stream) {
  return iter_packed_launch<false>(packed, perm, color_start, dyn_ab, pos, pos_out,
                                   n_worlds, n_bodies, n_contacts, max_colors,
                                   threads_per_world, worlds_per_block, tile, n_buffers,
                                   stream);
}

// One world's shared memory in a sweep, as the kernel lays it out (the
// card-only tests hold ops/solve_middle.py's copy of the sum to it).
extern "C" int sweep_world_smem_bytes(int velocity, int n_bodies, int n_contacts,
                                      int max_colors, int tile, int n_buffers) {
  return StagedLayout(velocity ? kVelRows : kPosRows, n_bodies, n_contacts, max_colors,
                      tile, n_buffers).bytes;
}

extern "C" int unpack_packed_launch(const float* packed, const int* perm,
                                    const int* color_start, float* aux, int n_worlds,
                                    int n_contacts, int max_colors, int worlds_per_block,
                                    int grid_y, void* stream) {
  if (n_worlds <= 0) return 0;
  if (worlds_per_block < 1 || worlds_per_block > kUnpackMaxWorlds || grid_y < 1 ||
      grid_y > kAuxRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)worlds_per_block * n_contacts * sizeof(int);
  const cudaError_t e = allow_smem(unpack_packed_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = n_contacts % 4 == 0 && reinterpret_cast<uintptr_t>(aux) % 16 == 0;
  const dim3 grid((n_worlds + worlds_per_block - 1) / worlds_per_block, grid_y);
  unpack_packed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      packed, perm, color_start, aux, n_worlds, n_contacts, max_colors,
      worlds_per_block, vec);
  return (int)cudaGetLastError();
}
