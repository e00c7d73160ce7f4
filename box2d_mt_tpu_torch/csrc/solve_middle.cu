// Contact solve middle for a batch of worlds, one thread block per world:
// the whole middle as one kernel (K1, joint-free worlds) and, further down,
// the same work as four kernels around the joint passes (K3-K6, "the
// sandwich"). This header is K1's.
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
// chip_smoke.py computes it from each run's inputs. No single PyTorch call
// computes the same function.
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
__device__ void velocity_lane(float* P, int C, int lane, const float* s, int n,
                              float d[6], int* ia_out, int* ib_out) {
  const Rows R{P, C, lane};
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
__device__ void position_lane(float* P, int C, int lane, const float* s, int n,
                              float d[6], int* ia_out, int* ib_out) {
  const Rows R{P, C, lane};
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
        if (kVelocity) velocity_lane(P, C, p, s, n, d, &ia, &ib);
        else position_lane(P, C, p, s, n, d, &ia, &ib);
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
          if (kVelocity) velocity_lane(P, C, ch + l, s, n, d, &ia, &ib);
          else position_lane(P, C, ch + l, s, n, d, &ia, &ib);
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
// P, perm, dyn_ab and the body planes); chip_smoke.py computes them.
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

// One sweep over a (W, 3, n) body plane: velocity rows [vx | vy | w] or
// position rows [cx | cy | a].
template <bool kVelocity>
__global__ void __launch_bounds__(kThreads)
iter_packed_kernel(float* __restrict__ packed, const int* __restrict__ perm,
                   const int* __restrict__ color_start,
                   const uint8_t* __restrict__ dyn_ab,
                   const float* __restrict__ body_in, float* __restrict__ body_out,
                   int n, int C, int mc) {
  extern __shared__ float smem[];
  float* sb = smem;                          // the three body rows
  float* sd = smem + 3 * n;                  // overflow chunk deltas
  int* sidx = reinterpret_cast<int*>(sd + 6 * kChunk);

  const int w = blockIdx.x;
  const size_t bo = (size_t)w * 3 * n;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) sb[i] = body_in[bo + i];
  __syncthreads();
  sweep<kVelocity>(packed + (size_t)w * kScratchRows * C, C,
                   color_start + (size_t)w * (mc + 1), mc, perm + (size_t)w * C,
                   dyn_ab + (size_t)w * C, sb, n, sd, sidx);
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) body_out[bo + i] = sb[i];
}

__global__ void __launch_bounds__(kThreads)
unpack_packed_kernel(const float* __restrict__ packed, const int* __restrict__ perm,
                     const int* __restrict__ color_start, float* __restrict__ aux,
                     int C, int mc) {
  const int w = blockIdx.x;
  const float* P = packed + (size_t)w * kScratchRows * C;
  const int* pw = perm + (size_t)w * C;
  float* A = aux + (size_t)w * kAuxRows * C;
  const int total = color_start[(size_t)w * (mc + 1) + mc];
  for (int i = threadIdx.x; i < kAuxRows * C; i += blockDim.x) A[i] = 0.0f;
  __syncthreads();
  for (int p = threadIdx.x; p < total; p += blockDim.x) {
    const int slot = pw[p];
    for (int r = 0; r < 4; ++r) A[(size_t)r * C + slot] = P[(size_t)(47 + r) * C + p];
    A[(size_t)4 * C + slot] = P[(size_t)kMinSepRow * C + p];
  }
}

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
                       void* stream) {
  if (n_worlds <= 0) return 0;
  const size_t smem = (size_t)(3 * n_bodies + 6 * kChunk) * sizeof(float) +
                      2 * kChunk * sizeof(int);
  const cudaError_t e = allow_smem(iter_packed_kernel<kVelocity>, smem);
  if (e != cudaSuccess) return (int)e;
  iter_packed_kernel<kVelocity><<<n_worlds, kThreads, smem, (cudaStream_t)stream>>>(
      packed, perm, color_start, dyn_ab, body_in, body_out, n_bodies, n_contacts,
      max_colors);
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
                                      void* stream) {
  return iter_packed_launch<true>(packed, perm, color_start, dyn_ab, vel, vel_out,
                                  n_worlds, n_bodies, n_contacts, max_colors, stream);
}

extern "C" int pos_iter_packed_launch(float* packed, const int* perm,
                                      const int* color_start, const uint8_t* dyn_ab,
                                      const float* pos, float* pos_out, int n_worlds,
                                      int n_bodies, int n_contacts, int max_colors,
                                      void* stream) {
  return iter_packed_launch<false>(packed, perm, color_start, dyn_ab, pos, pos_out,
                                   n_worlds, n_bodies, n_contacts, max_colors, stream);
}

extern "C" int unpack_packed_launch(const float* packed, const int* perm,
                                    const int* color_start, float* aux, int n_worlds,
                                    int n_contacts, int max_colors, void* stream) {
  if (n_worlds <= 0) return 0;
  unpack_packed_kernel<<<n_worlds, kThreads, 0, (cudaStream_t)stream>>>(
      packed, perm, color_start, aux, n_contacts, max_colors);
  return (int)cudaGetLastError();
}
