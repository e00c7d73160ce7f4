// Contact solve middle for a batch of worlds: the whole middle as one
// kernel (K1, joint-free worlds) and, further down, the same work as four
// kernels around the joint passes (K3-K6, "the sandwich"). K1, K4 and K5
// run one implementation of a sweep (`sweep_span` over rows staged in
// shared memory), so K1 and the sandwich agree to the bit.
//
// ---- K1: solve_middle_kernel ------------------------------------------------
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
// against ~1 us for its flops. chip_smoke.py computes it from each run's
// inputs and holds the kernel's time on the device against it.
//
// What holds it back is latency, not bytes: a world's sweeps are a chain
// of passes (sweeps x non-empty colors; 11 x 4 at pyramid(10)), each one
// lane's few hundred dependent instructions and a barrier. The design
// takes everything else off that chain:
//
//   * a world gets a block of `tw` threads, C / 2 of them, so that the
//     pack's and the unpack's copies spread wide; a pass needs C / 10
//     (ops/solve_middle.py `middle_shape`). Several worlds a block, as K4
//     takes them, measured slower here;
//   * resident path (a world's table fits a block's shared memory; C up
//     to 1024): the pack gathers the lanes' 36 velocity rows through perm
//     straight into shared memory (4-byte asynchronous copies), so a row
//     crosses global memory once a call, not once a sweep. After the
//     velocity sweeps the 15 position-only rows are gathered into the
//     place of velocity-only rows 10-24 while the bodies integrate; the
//     impulses (rows 47-50) and min_sep stay resident for the unpack.
//     37 rows of C lanes: 47 KB a world at C = 256, four worlds an SM;
//   * ring path (larger worlds, pyramid(44)'s C = 4096): the pack writes
//     the table to a global scratch, and every sweep walks it through
//     K4's ring of tiles in shared memory, as K4 and K5 do, in two tiles
//     as wide as a block holds (a color split at a tile border costs a
//     pass);
//   * the overflow color's chunk deltas are applied by all threads in
//     lane order (`apply_chunk`), not by one;
//   * the unpack inverts perm in shared memory and writes each aux element
//     once, 16 bytes a thread, as K6 does;
//   * global planes (a world whose body planes leave no room for a ring
//     tile of 32 lanes, or whose perm inverse does not fit beside it:
//     above 4096 bodies or 16384 slots): the ring path with the body
//     planes in the call's own vel_out / pos_out rows, the movable flags
//     and the dynamic-endpoint flags read from global memory, and an
//     unpack that zeroes the aux rows and scatters the solved lanes into
//     them. Shared memory then holds the ring's tiles, the overflow
//     chunk and color_start alone, whatever the world's size. The
//     arithmetic and its order are the same; a pass's body writes reach
//     the next pass through the world's barrier, which orders a block's
//     global memory as it does its shared memory.
//
// Races: within a color the coloring makes lanes conflict-free on DYNAMIC
// bodies only; static bodies are shared. A lane therefore writes back only
// the endpoints flagged dynamic in dyn_ab (every other endpoint's delta is
// exactly zero). The last color (max_colors - 1) holds the coloring's
// overflow, whose lanes may share dynamic bodies: it runs in chunks of
// kChunk lanes that all read the chunk-start state, and their deltas are
// then applied in lane order (deterministic, no float atomics). A lane's
// impulses are written by the one thread that solves it, once a sweep.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 51;          // pack_cc_blob_t rows
constexpr int kMinSepRow = 51;     // extra table row
constexpr int kScratchRows = 52;
constexpr int kAuxRows = 5;
constexpr int kChunk = 256;        // overflow-color chunk width (the Pallas CK)
constexpr int kThreads = 256;      // most threads a block

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

// Rows of the packed table that a sweep reads, as staged rows 0..kR-1:
// velocity 0-31 and 47-50; position 0-3, 6-9 and 32-46.
constexpr int kVelRows = 36;
constexpr int kPosRows = 23;
// K1's resident table: the 36 velocity rows (position rows 32-46 later
// take the place of rows 10-24) and min_sep.
constexpr int kResidentMinSep = 36;
constexpr int kResidentRows = 37;

// One velocity lane (velocity_contact_math_s, same operation order). `R`
// reads table row k of the lane and stores its impulses. Body rows in
// `s`: [vx | vy | w], each n wide. Returns the six body deltas.
template <class RowsT>
__device__ void velocity_lane(const RowsT& R, const float* s, int n, float d[6],
                              int* ia_out, int* ib_out) {
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

  R.put_impulses(ni[0], ni[1], ti[0], ti[1]);
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
// Only the lane's own manifold type is evaluated: the plain version
// computes all three and selects, and the selected expression is the same.
template <class RowsT>
__device__ void position_lane(const RowsT& R, const float* s, int n, float d[6],
                              int* ia_out, int* ib_out) {
  const bool m = R(0) > 0.5f;
  const int ia = (int)R(1), ib = (int)R(2), pc = (int)R(3);
  const float ma = R(6), mb = R(7), iA = R(8), iB = R(9);
  const float mpx[2] = {R(32), R(34)}, mpy[2] = {R(33), R(35)};
  const float lnx = R(36), lny = R(37), lpx = R(38), lpy = R(39);
  const float ra = R(40), rb = R(41);
  const float lcax = R(42), lcay = R(43), lcbx = R(44), lcby = R(45);
  const int mtype = (int)R(46);

  const float cax0 = s[ia], cay0 = s[n + ia], aa0 = s[2 * n + ia];
  const float cbx0 = s[ib], cby0 = s[n + ib], ab0 = s[2 * n + ib];
  float cax = cax0, cay = cay0, aa = aa0, cbx = cbx0, cby = cby0, ab = ab0;
  float min_sep = 0.0f;

  for (int j = 0; j < 2; ++j) {
    const bool has = m && (j < pc);
    float qas, qac, qbs, qbc;
    sincosf(aa, &qas, &qac);
    sincosf(ab, &qbs, &qbc);
    const float pax = cax - (qac * lcax - qas * lcay);
    const float pay = cay - (qas * lcax + qac * lcay);
    const float pbx = cbx - (qbc * lcbx - qbs * lcby);
    const float pby = cby - (qbs * lcbx + qbc * lcby);

    // b2PositionSolverManifold::Initialize
    const float clx = mpx[j], cly = mpy[j];
    float nx, ny, px, py, sep;
    if (mtype == kFaceA) {
      const float pAx = qac * lpx - qas * lpy + pax;
      const float pAy = qas * lpx + qac * lpy + pay;
      nx = qac * lnx - qas * lny;
      ny = qas * lnx + qac * lny;
      px = qbc * clx - qbs * cly + pbx;
      py = qbs * clx + qbc * cly + pby;
      sep = (px - pAx) * nx + (py - pAy) * ny - ra - rb;
    } else if (mtype == kFaceB) {
      const float nbx = qbc * lnx - qbs * lny;
      const float nby = qbs * lnx + qbc * lny;
      const float plane_bx = qbc * lpx - qbs * lpy + pbx;
      const float plane_by = qbs * lpx + qbc * lpy + pby;
      px = qac * clx - qas * cly + pax;
      py = qas * clx + qac * cly + pay;
      sep = (px - plane_bx) * nbx + (py - plane_by) * nby - ra - rb;
      nx = -nbx;
      ny = -nby;
    } else {
      const float pAx = qac * lpx - qas * lpy + pax;
      const float pAy = qas * lpx + qac * lpy + pay;
      const float pBx = qbc * mpx[0] - qbs * mpy[0] + pbx;
      const float pBy = qbs * mpx[0] + qbc * mpy[0] + pby;
      const float dx = pBx - pAx, dy = pBy - pAy;
      const float dist = sqrtf(dx * dx + dy * dy);
      nx = dist > 0.0f ? dx / dist : 0.0f;
      ny = dist > 0.0f ? dy / dist : 0.0f;
      px = 0.5f * (pAx + pBx);
      py = 0.5f * (pAy + pBy);
      sep = dx * nx + dy * ny - ra - rb;
    }

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

  R.put_min_sep(m ? min_sep : 0.0f);
  d[0] = m ? cax - cax0 : 0.0f;
  d[1] = m ? cay - cay0 : 0.0f;
  d[2] = m ? aa - aa0 : 0.0f;
  d[3] = m ? cbx - cbx0 : 0.0f;
  d[4] = m ? cby - cby0 : 0.0f;
  d[5] = m ? ab - ab0 : 0.0f;
  *ia_out = ia;
  *ib_out = ib;
}

template <bool kVelocity, class RowsT>
__device__ __forceinline__ void solve_lane(const RowsT& R, const float* s, int n, float d[6],
                                           int* ia, int* ib) {
  if constexpr (kVelocity) velocity_lane(R, s, n, d, ia, ib);
  else position_lane(R, s, n, d, ia, ib);
}

__device__ __forceinline__ void add3(float* s, int n, int b, const float* d) {
  s[b] += d[0];
  s[n + b] += d[1];
  s[2 * n + b] += d[2];
}

template <bool kVelocity>
__device__ __forceinline__ int table_row(int r) {
  if (kVelocity) return r < 32 ? r : r + 15;
  return r < 4 ? r : r < 8 ? r + 2 : r + 24;
}

// A lane of a tile staged from the global table (K4, K5, K1's ring path):
// reads the staged rows, stores its results to the table in global memory
// (stores of neighbouring lanes to neighbouring addresses, off the chain).
template <bool kVelocity>
struct StagedRows {
  const float* T;   // the tile in shared memory, `stride` lanes a row
  int stride;
  int lane;         // within the tile
  float* P;         // the world's table in global memory
  int C;
  int p;            // packed position
  __device__ float operator()(int k) const {
    const int r = kVelocity ? (k < 32 ? k : k - 15) : (k < 4 ? k : k < 10 ? k - 2 : k - 24);
    return T[r * stride + lane];
  }
  __device__ void put_impulses(float n0, float n1, float t0, float t1) const {
    P[(size_t)47 * C + p] = n0;
    P[(size_t)48 * C + p] = n1;
    P[(size_t)49 * C + p] = t0;
    P[(size_t)50 * C + p] = t1;
  }
  __device__ void put_min_sep(float x) const { P[(size_t)kMinSepRow * C + p] = x; }
};

// A lane of K1's resident table: velocity rows 0-31 at 0-31 and the
// impulses 47-50 at 32-35; position rows 0-3 and 6-9 where they are, rows
// 32-46 at 10-24; min_sep at 36. Results stay in shared memory.
template <bool kVelocity>
struct ResidentRows {
  float* T;         // `cap` lanes a row
  int cap;
  int p;
  __device__ float operator()(int k) const {
    const int r = kVelocity ? (k < 32 ? k : k - 15) : (k < 10 ? k : k - 22);
    return T[r * cap + p];
  }
  __device__ void put_impulses(float n0, float n1, float t0, float t1) const {
    T[32 * cap + p] = n0;
    T[33 * cap + p] = n1;
    T[34 * cap + p] = t0;
    T[35 * cap + p] = t1;
  }
  __device__ void put_min_sep(float x) const { T[kResidentMinSep * cap + p] = x; }
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// One world's shared memory, in bytes from its base (all 16-byte aligned):
// `row_floats` of staged rows, the overflow chunk's deltas and endpoints,
// `planes` body planes (two: K1's velocities and positions, and then the
// movable flags), color_start, the dynamic-endpoint flags in packed order.
// No planes: the global-planes layout, whose planes and flags are in
// global memory. ops/solve_middle.py `_world_bytes` repeats the sum.
struct WorldLayout {
  int sd, sidx, body, mov, cs, dyn, bytes;
  __host__ __device__ WorldLayout(int row_floats, int planes, int n, int C, int mc) {
    const int chunk = C < kChunk ? (C + 31) & ~31 : kChunk;   // lanes an overflow chunk can hold
    sd = align16(row_floats * 4);
    sidx = sd + 6 * chunk * 4;
    body = sidx + 2 * chunk * 4;
    mov = body + planes * align16(3 * n * 4);
    cs = mov + (planes > 1 ? align16(n) : 0);
    dyn = cs + align16((mc + 1) * 4);
    bytes = dyn + (planes > 0 ? align16(C) : 0);
  }
};

// Staged rows of a sweep (K4, K5): `nbuf` tiles of `rows` rows, and the
// body plane unless it is global.
__host__ __device__ inline WorldLayout sweep_layout(int rows, int n, int C, int mc, int tile,
                                                    int nbuf, bool gplanes) {
  return WorldLayout(nbuf * rows * tile, gplanes ? 0 : 1, n, C, mc);
}

// K1: 37 resident rows of `tile` (>= C) lanes, or the ring's tiles of the
// velocity rows (which also hold perm's inverse, C ints, for the unpack,
// unless the planes are global).
__host__ __device__ inline WorldLayout middle_layout(bool resident, int n, int C, int mc,
                                                     int tile, int nbuf, bool gplanes) {
  const int ring = nbuf * kVelRows * tile;
  const int rows = resident ? kResidentRows * tile : gplanes || ring > C ? ring : C;
  return WorldLayout(rows, gplanes ? 0 : 2, n, C, mc);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
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

// Apply an overflow chunk's deltas in lane order (A endpoint, then B):
// each thread owns bodies and sums their deltas in a register, so every
// body receives its deltas in the order a serial apply gives them.
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

// The one sweep implementation (K1, K4, K5): the color passes over lanes
// [t0, t1) of staged rows; `rows(p)` is packed position p's accessor.
// Conflict-free colors are one parallel pass each. The overflow color's
// chunks start at its first lane, every kChunk lanes; a chunk's lanes all
// read the chunk-start state, and the chunk is applied once complete (a
// chunk that straddles t1 is finished by the caller's next tile, whose
// span starts inside it). Every pass ends at the world's barrier. The
// dynamic-endpoint flags are `sdyn`, staged in packed order, or with
// kGlobal (global planes) the slot-order flags in global memory, read
// through `perm`.
template <bool kVelocity, class RowsAt, bool kGlobal = false>
__device__ void sweep_span(const RowsAt& rows, int t0, int t1, const int* scs, int mc,
                           float* sb, int n, const uint8_t* sdyn, float* sd, int2* sidx,
                           const Group& g, int tid, int tw, const int* perm = nullptr) {
  for (int c = 0; c < mc; ++c) {
    const int c0 = scs[c], c1 = scs[c + 1];
    const int s0 = max(c0, t0), s1 = min(c1, t1);
    if (s0 >= s1) continue;  // same for every thread of the world
    if (c < mc - 1) {
      for (int p = s0 + tid; p < s1; p += tw) {
        float d[6];
        int ia, ib;
        solve_lane<kVelocity>(rows(p), sb, n, d, &ia, &ib);
        const uint8_t f = kGlobal ? sdyn[perm[p]] : sdyn[p];
        if (f & 1) add3(sb, n, ia, d);
        if (f & 2) add3(sb, n, ib, d + 3);
      }
      g.sync();
    } else {
      for (int ch = c0 + (s0 - c0) / kChunk * kChunk; ch < s1; ch += kChunk) {
        const int ce = min(ch + kChunk, c1);
        for (int p = max(ch, s0) + tid; p < min(ce, s1); p += tw) {
          float d[6];
          int ia, ib;
          solve_lane<kVelocity>(rows(p), sb, n, d, &ia, &ib);
          const uint8_t f = kGlobal ? sdyn[perm[p]] : sdyn[p];
          const int l = p - ch;
          for (int q = 0; q < 6; ++q) sd[6 * l + q] = d[q];
          sidx[l] = make_int2((f & 1) ? ia : -1, (f & 2) ? ib : -1);
        }
        if (ce <= t1) {
          g.sync();
          apply_chunk(sb, n, sd, sidx, ce - ch, tid, tw);
          g.sync();
        }
      }
    }
  }
}

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

// The ring over a world's table in global memory (K4, K5, K1's ring
// path): `ring_start` stages the first `nbuf` tiles; `ring_run` sweeps
// tile after tile, the next tile's copies in flight while one is swept.
// Splitting a color at a tile border changes nothing: its lanes share no
// dynamic body.
template <bool kVelocity>
__device__ void ring_start(const float* P, int C, float* srows, int total, int tile, int nbuf,
                           int tid, int tw, bool aligned) {
  constexpr int kR = kVelocity ? kVelRows : kPosRows;
  const int n_tiles = (total + tile - 1) / tile;
  for (int j = 0; j < min(nbuf, n_tiles); ++j)
    load_tile<kVelocity>(P, C, srows + (size_t)j * kR * tile, j * tile,
                         min(tile, total - j * tile), tile, tid, tw, aligned);
}

template <bool kVelocity, bool kGlobal = false>
__device__ void ring_run(float* P, int C, float* srows, int total, int tile, int nbuf,
                         bool aligned, const int* scs, int mc, float* sb, int n,
                         const uint8_t* sdyn, float* sd, int2* sidx, const Group& g, int tid,
                         int tw, const int* perm = nullptr) {
  constexpr int kR = kVelocity ? kVelRows : kPosRows;
  const int n_tiles = (total + tile - 1) / tile;
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
    const auto rows = [=](int p) { return StagedRows<kVelocity>{T, tile, p - t0, P, C, p}; };
    sweep_span<kVelocity, decltype(rows), kGlobal>(rows, t0, t1, scs, mc, sb, n, sdyn, sd,
                                                   sidx, g, tid, tw, perm);
    if (j + nbuf < n_tiles) {
      g.sync();  // every thread is done with this buffer
      load_tile<kVelocity>(P, C, srows + (size_t)buf * kR * tile, (j + nbuf) * tile,
                           min(tile, total - (j + nbuf) * tile), tile, tid, tw, aligned);
    }
  }
}

// Integrate positions with the translation/rotation clamps (b2Island.cpp
// :283-313); velocities are clamped in place.
__device__ void integrate_bodies(float* sv, float* sp, const uint8_t* smov, int n, float dt,
                                 int tid, int tw) {
  const float dt2 = dt * dt;
  for (int i = tid; i < n; i += tw) {
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
}

// perm's inverse for the first `total` packed positions: inv[slot] = p,
// -1 where no lane solved the slot. `inv` must hold -1 everywhere first.
__device__ void invert_perm(const int* pw, int total, int C, int* inv, int tid, int tw) {
  for (int p = tid; p < total; p += tw) {
    const int slot = pw[p];
    if ((unsigned)slot < (unsigned)C) inv[slot] = p;
  }
}

// The world's five aux rows in slot order, each element written once:
// src[r][inv[slot]], or 0 where inv is -1; 16 bytes a thread when `vec`.
__device__ void write_aux(const int* inv, const float* const src[kAuxRows], float* A, int C,
                          bool vec, int tid, int tw) {
  for (int r = 0; r < kAuxRows; ++r) {
    const float* s = src[r];
    if (vec) {
      for (int i = tid; i < C / 4; i += tw) {
        const int4 iv = reinterpret_cast<const int4*>(inv)[i];
        float4 v;
        v.x = iv.x >= 0 ? s[iv.x] : 0.0f;
        v.y = iv.y >= 0 ? s[iv.y] : 0.0f;
        v.z = iv.z >= 0 ? s[iv.z] : 0.0f;
        v.w = iv.w >= 0 ? s[iv.w] : 0.0f;
        reinterpret_cast<float4*>(A + (size_t)r * C)[i] = v;
      }
    } else {
      for (int i = tid; i < C; i += tw) {
        const int p = inv[i];
        A[(size_t)r * C + i] = p >= 0 ? s[p] : 0.0f;
      }
    }
  }
}

// The solved lanes' five aux values to their slots, A[r][perm[p]] =
// src[r][p], over rows that hold 0 (the slots no lane solved keep it).
__device__ void scatter_aux(const int* pw, int total, int C, const float* const src[kAuxRows],
                            float* A, int tid, int tw) {
  for (int p = tid; p < total; p += tw) {
    const int slot = pw[p];
    if ((unsigned)slot < (unsigned)C)
      for (int r = 0; r < kAuxRows; ++r) A[(size_t)r * C + slot] = src[r][p];
  }
}

// K1, a block of `tw` threads a world. Resident path (`resident`): the
// world's table lives in shared memory for the whole call, `tile` (>= C)
// lanes a row. Ring path: the
// table lives in a global scratch (W, 52, C), which every sweep walks
// through shared memory in tiles of `tile` lanes, as K4 and K5 do; with
// kGlobal (global planes), the body planes are vel_out's and pos_out's
// rows. The shared-memory instantiation is the code it was before.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
solve_middle_kernel(const float* __restrict__ blob, const int* __restrict__ perm,
                    const int* __restrict__ color_start, const uint8_t* __restrict__ dyn_ab,
                    const float* __restrict__ vel, const float* __restrict__ pos,
                    const uint8_t* __restrict__ movable, float* __restrict__ vel_out,
                    float* __restrict__ pos_out, float* __restrict__ aux, float* scratch,
                    int n, int C, int mc, int vi, int pi, float dt, int tw, int resident,
                    int tile, int nbuf, int aligned, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const WorldLayout lay = middle_layout(resident, n, C, mc, tile, nbuf, kGlobal);
  const int tid = threadIdx.x, w = blockIdx.x;
  unsigned char* base = smem_raw;
  float* T = reinterpret_cast<float*>(base);                 // the table, or the ring's tiles
  float* sd = reinterpret_cast<float*>(base + lay.sd);       // overflow chunk deltas
  int2* sidx = reinterpret_cast<int2*>(base + lay.sidx);     // and endpoints (-1: none)
  float* sv = reinterpret_cast<float*>(base + lay.body);     // [vx | vy | w]
  float* sp = sv + align16(3 * n * 4) / 4;                   // [cx | cy | a]
  uint8_t* smov = base + lay.mov;
  int* scs = reinterpret_cast<int*>(base + lay.cs);
  uint8_t* sdyn = base + lay.dyn;                            // dyn_ab in packed order

  const Group g{1, tw};
  const float* B = blob + (size_t)w * kRows * C;
  const int* pw = perm + (size_t)w * C;
  const int* cs = color_start + (size_t)w * (mc + 1);
  const uint8_t* dyn = dyn_ab + (size_t)w * C;
  float* P = resident ? nullptr : scratch + (size_t)w * kScratchRows * C;
  const size_t bo = (size_t)w * 3 * n;
  const int total = min(cs[mc], C);
  if constexpr (kGlobal) {  // the planes in global memory
    sv = vel_out + bo;
    sp = pos_out + bo;
  }

  // pack: resident, the solved lanes' velocity rows gathered through perm
  // by 4-byte asynchronous copies; ring, every row into the global table
  for (int p = tid; p < total; p += tw) {
    const int slot = pw[p];
    if constexpr (!kGlobal) sdyn[p] = dyn[slot];
    if (resident) {
      for (int k = 0; k < kVelRows; ++k)
        cp_async4(T + k * tile + p, B + (size_t)table_row<true>(k) * C + slot);
      T[kResidentMinSep * tile + p] = 0.0f;
    } else {
      for (int k = 0; k < kRows; ++k) P[(size_t)k * C + p] = B[(size_t)k * C + slot];
      P[(size_t)kMinSepRow * C + p] = 0.0f;
    }
  }
  cp_async_commit();
  for (int i = tid; i <= mc; i += tw) scs[i] = cs[i];
  for (int i = tid; i < 3 * n; i += tw) {
    sv[i] = vel[bo + i];
    sp[i] = pos[bo + i];
  }
  if constexpr (!kGlobal)
    for (int i = tid; i < n; i += tw) smov[i] = movable[(size_t)w * n + i];
  cp_async_wait<0>();
  // ring: the table's stores are in L2, where the tiles' copies read,
  // before any thread stages from it; so are a sweep's before the next's
  if (!resident) __threadfence();
  g.sync();

  const auto vrows = [=](int p) { return ResidentRows<true>{T, tile, p}; };
  for (int it = 0; it < vi; ++it) {
    if (resident) {
      sweep_span<true>(vrows, 0, total, scs, mc, sv, n, sdyn, sd, sidx, g, tid, tw);
    } else {
      ring_start<true>(P, C, T, total, tile, nbuf, tid, tw, aligned);
      if constexpr (kGlobal)  // the flags in slot order, through perm
        ring_run<true, true>(P, C, T, total, tile, nbuf, aligned, scs, mc, sv, n, dyn, sd, sidx,
                             g, tid, tw, pw);
      else
        ring_run<true>(P, C, T, total, tile, nbuf, aligned, scs, mc, sv, n, sdyn, sd, sidx, g,
                       tid, tw);
      __threadfence();
    }
    g.sync();
  }

  // resident: the position-only rows 32-46 into the place of rows 10-24
  // while the bodies integrate, and perm's inverse into row 4's place
  int* inv = reinterpret_cast<int*>(resident ? T + 4 * tile : T);
  if (resident) {
    for (int p = tid; p < total; p += tw) {
      const int slot = pw[p];
      for (int k = 0; k < 15; ++k)
        cp_async4(T + (10 + k) * tile + p, B + (size_t)(32 + k) * C + slot);
    }
    cp_async_commit();
    for (int i = tid; i < C; i += tw) inv[i] = -1;
  }
  integrate_bodies(sv, sp, kGlobal ? movable + (size_t)w * n : smov, n, dt, tid, tw);
  g.sync();
  if (resident) {
    invert_perm(pw, total, C, inv, tid, tw);
    cp_async_wait<0>();
    g.sync();
  }

  const auto prows = [=](int p) { return ResidentRows<false>{T, tile, p}; };
  for (int it = 0; it < pi; ++it) {
    if (resident) {
      sweep_span<false>(prows, 0, total, scs, mc, sp, n, sdyn, sd, sidx, g, tid, tw);
    } else {
      ring_start<false>(P, C, T, total, tile, nbuf, tid, tw, aligned);
      if constexpr (kGlobal)
        ring_run<false, true>(P, C, T, total, tile, nbuf, aligned, scs, mc, sp, n, dyn, sd,
                              sidx, g, tid, tw, pw);
      else
        ring_run<false>(P, C, T, total, tile, nbuf, aligned, scs, mc, sp, n, sdyn, sd, sidx, g,
                        tid, tw);
      __threadfence();
    }
    g.sync();
  }

  if constexpr (kGlobal) {  // the planes are the outputs; the aux rows: zero, then scatter
    const float* src[kAuxRows];
    for (int r = 0; r < kAuxRows; ++r) src[r] = P + (size_t)(r < 4 ? 47 + r : kMinSepRow) * C;
    float* A = aux + (size_t)w * kAuxRows * C;
    for (int i = tid; i < kAuxRows * C; i += tw) A[i] = 0.0f;
    g.sync();
    scatter_aux(pw, total, C, src, A, tid, tw);
    return;
  }
  for (int i = tid; i < 3 * n; i += tw) {
    vel_out[bo + i] = sv[i];
    pos_out[bo + i] = sp[i];
  }
  if (!resident) {  // the tiles are done: perm's inverse takes their place
    for (int i = tid; i < C; i += tw) inv[i] = -1;
    g.sync();
    invert_perm(pw, total, C, inv, tid, tw);
    g.sync();
  }
  const float* src[kAuxRows];
  for (int r = 0; r < kAuxRows; ++r)
    src[r] = resident ? T + (r < 4 ? 32 + r : kResidentMinSep) * tile
                      : P + (size_t)(r < 4 ? 47 + r : kMinSepRow) * C;
  write_aux(inv, src, aux + (size_t)w * kAuxRows * C, C, vec, tid, tw);
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
// instructions. That chain of passes is fixed by the coloring, the
// arithmetic and its order (--fmad=false), so the design takes everything
// else off it:
//
//   * the table is color-major, so row k of a world is one contiguous run
//     of lanes. At kernel entry a world's threads start asynchronous
//     16-byte copies (cp.async) of the needed rows (36 for a velocity
//     sweep, 23 for a position sweep) of its first tiles of `tile` lanes
//     into shared memory (`ring_start`); the color passes read shared
//     memory only. A world with more lanes than the buffers hold walks its
//     tiles through the ring (`ring_run`), the next tile's copies in flight
//     while this one is swept. color_start, the body plane and the lanes'
//     dynamic-endpoint flags (dyn_ab through perm) are staged by plain
//     loads while the copies fly. A table whose rows are not 16-byte
//     aligned (C not a multiple of 4) is staged by plain loads.
//   * a world gets `tw` threads (one warp at 128 slots, 256 threads from
//     1024) and a block holds several worlds; a world's threads meet at a
//     named barrier of their own width (__syncwarp for one warp). The host
//     picks tw, the worlds a block, the tile and the ring depth from the
//     static shapes (ops/solve_middle.py `sweep_shape`).
//   * the overflow chunk's deltas are applied by all threads in lane order.
//   * a position lane evaluates only its own manifold type and takes sine
//     and cosine of an angle from one sincosf: the two choices that shorten
//     its chain without changing a bit of its result.
//
// Races: as K1's. An overflow chunk that straddles a tile border computes
// all its lanes from the chunk-start state (nothing is applied in between)
// and is applied once complete.
//
// Global planes (kGlobal, a world whose body plane and flags do not fit
// a block beside a ring of tiles; above 8192 bodies): as K1's, the plane
// is body_out's rows, filled from body_in at entry, and the flags are
// read through perm.

template <bool kVelocity, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
iter_packed_kernel(float* __restrict__ packed, const int* __restrict__ perm,
                   const int* __restrict__ color_start,
                   const uint8_t* __restrict__ dyn_ab,
                   const float* __restrict__ body_in, float* __restrict__ body_out,
                   int n_worlds, int n, int C, int mc, int tw, int tile, int nbuf,
                   int aligned) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const WorldLayout lay =
      sweep_layout(kVelocity ? kVelRows : kPosRows, n, C, mc, tile, nbuf, kGlobal);
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
  if constexpr (kGlobal) sb = body_out + bo;

  ring_start<kVelocity>(P, C, srows, total, tile, nbuf, tid, tw, aligned);
  for (int i = tid; i <= mc; i += tw) scs[i] = cs[i];
  for (int i = tid; i < 3 * n; i += tw) sb[i] = body_in[bo + i];
  if constexpr (!kGlobal)
    for (int p = tid; p < total; p += tw) sdyn[p] = dyn[pw[p]];
  if constexpr (kGlobal)
    ring_run<kVelocity, true>(P, C, srows, total, tile, nbuf, aligned, scs, mc, sb, n, dyn, sd,
                              sidx, g, tid, tw, pw);
  else
    ring_run<kVelocity>(P, C, srows, total, tile, nbuf, aligned, scs, mc, sb, n, sdyn, sd, sidx,
                        g, tid, tw);
  if constexpr (!kGlobal)
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
// `unpack_shape`). Where a world's inverse does not fit a block's shared
// memory (C above 58112 slots), a block zeroes its aux rows and scatters
// the solved lanes into them instead (`scatter`, no shared memory).
constexpr int kUnpackMaxWorlds = 8;
constexpr int kSmemBlockMax = 232448;   // shared memory a block may take (H100)

__global__ void __launch_bounds__(kThreads)
unpack_packed_kernel(const float* __restrict__ packed, const int* __restrict__ perm,
                     const int* __restrict__ color_start, float* __restrict__ aux,
                     int n_worlds, int C, int mc, int wpb, int vec, int scatter) {
  extern __shared__ __align__(16) int inv[];   // wpb x C
  __shared__ int totals[kUnpackMaxWorlds];
  const int w0 = blockIdx.x * wpb;
  const int nw = min(wpb, n_worlds - w0);
  const int tid = threadIdx.x;
  if (scatter) {  // one world a block
    const int total = min(color_start[(size_t)w0 * (mc + 1) + mc], C);
    const int* pw = perm + (size_t)w0 * C;
    for (int r = blockIdx.y; r < kAuxRows; r += gridDim.y) {
      float* A = aux + ((size_t)w0 * kAuxRows + r) * C;
      const float* src =
          packed + ((size_t)w0 * kScratchRows + (r < 4 ? 47 + r : kMinSepRow)) * C;
      for (int i = tid; i < C; i += blockDim.x) A[i] = 0.0f;
      __syncthreads();
      for (int p = tid; p < total; p += blockDim.x) {
        const int slot = pw[p];
        if ((unsigned)slot < (unsigned)C) A[slot] = src[p];
      }
    }
    return;
  }
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

bool bad_group(int tw, int wpb) {
  return tw < 32 || tw % 32 != 0 || wpb < 1 || wpb > 15 || tw * wpb > kThreads;
}

template <bool kVelocity>
int iter_packed_launch(float* packed, const int* perm, const int* color_start,
                       const uint8_t* dyn_ab, const float* body_in, float* body_out,
                       int n_worlds, int n_bodies, int n_contacts, int max_colors,
                       int tw, int wpb, int tile, int nbuf, int gplanes, void* stream) {
  if (n_worlds <= 0) return 0;
  if (bad_group(tw, wpb) || tile < 32 || tile % 32 != 0 || nbuf < 1)
    return (int)cudaErrorInvalidValue;
  const WorldLayout lay = sweep_layout(kVelocity ? kVelRows : kPosRows, n_bodies, n_contacts,
                                       max_colors, tile, nbuf, gplanes);
  const size_t smem = (size_t)wpb * lay.bytes;
  const auto kernel =
      gplanes ? iter_packed_kernel<kVelocity, true> : iter_packed_kernel<kVelocity, false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int aligned = n_contacts % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  kernel<<<(n_worlds + wpb - 1) / wpb, tw * wpb, smem, (cudaStream_t)stream>>>(
      packed, perm, color_start, dyn_ab, body_in, body_out, n_worlds, n_bodies, n_contacts,
      max_colors, tw, tile, nbuf, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. `resident`: the resident path, `tile` lanes a row (>= n_contacts,
// a multiple of 4), no scratch; otherwise the ring path over `scratch`
// (W, 52, C) with `n_buffers` tiles of `tile` lanes, and with
// `global_planes` the body planes in global memory. The shape comes from
// ops/solve_middle.py `middle_shape`.
extern "C" int solve_middle_launch(const float* blob, const int* perm,
                                   const int* color_start, const uint8_t* dyn_ab,
                                   const float* vel, const float* pos,
                                   const uint8_t* movable, float* vel_out,
                                   float* pos_out, float* aux, float* scratch,
                                   int n_worlds, int n_bodies, int n_contacts,
                                   int max_colors, int velocity_iterations,
                                   int position_iterations, int threads_per_world,
                                   int resident, int tile, int n_buffers, int global_planes,
                                   float dt, void* stream) {
  if (n_worlds <= 0) return 0;
  const int tw = threads_per_world;
  if (bad_group(tw, 1) || tile < n_contacts * resident || tile % 4 != 0 || n_buffers < 1 ||
      (!resident && (scratch == nullptr || tile % 32 != 0)) || (resident && global_planes))
    return (int)cudaErrorInvalidValue;
  const size_t smem = middle_layout(resident, n_bodies, n_contacts, max_colors, tile,
                                    n_buffers, global_planes).bytes;
  const int vec = n_contacts % 4 == 0 && reinterpret_cast<uintptr_t>(aux) % 16 == 0;
  const auto kernel = global_planes ? solve_middle_kernel<true> : solve_middle_kernel<false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int aligned = n_contacts % 4 == 0 && reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  kernel<<<n_worlds, tw, smem, (cudaStream_t)stream>>>(
      blob, perm, color_start, dyn_ab, vel, pos, movable, vel_out, pos_out, aux, scratch,
      n_bodies, n_contacts, max_colors, velocity_iterations, position_iterations, dt, tw,
      resident, tile, n_buffers, aligned, vec);
  return (int)cudaGetLastError();
}

// One world's shared memory in K1, as the kernel lays it out (the
// card-only tests hold ops/solve_middle.py's copy of the sum to it).
extern "C" int middle_world_smem_bytes(int resident, int n_bodies, int n_contacts,
                                       int max_colors, int tile, int n_buffers,
                                       int global_planes) {
  return middle_layout(resident, n_bodies, n_contacts, max_colors, tile, n_buffers,
                       global_planes).bytes;
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
                                      int tile, int n_buffers, int global_planes,
                                      void* stream) {
  return iter_packed_launch<true>(packed, perm, color_start, dyn_ab, vel, vel_out,
                                  n_worlds, n_bodies, n_contacts, max_colors,
                                  threads_per_world, worlds_per_block, tile, n_buffers,
                                  global_planes, stream);
}

extern "C" int pos_iter_packed_launch(float* packed, const int* perm,
                                      const int* color_start, const uint8_t* dyn_ab,
                                      const float* pos, float* pos_out, int n_worlds,
                                      int n_bodies, int n_contacts, int max_colors,
                                      int threads_per_world, int worlds_per_block,
                                      int tile, int n_buffers, int global_planes,
                                      void* stream) {
  return iter_packed_launch<false>(packed, perm, color_start, dyn_ab, pos, pos_out,
                                   n_worlds, n_bodies, n_contacts, max_colors,
                                   threads_per_world, worlds_per_block, tile, n_buffers,
                                   global_planes, stream);
}

// One world's shared memory in a sweep, as the kernel lays it out (the
// card-only tests hold ops/solve_middle.py's copy of the sum to it).
extern "C" int sweep_world_smem_bytes(int velocity, int n_bodies, int n_contacts,
                                      int max_colors, int tile, int n_buffers,
                                      int global_planes) {
  return sweep_layout(velocity ? kVelRows : kPosRows, n_bodies, n_contacts, max_colors, tile,
                      n_buffers, global_planes).bytes;
}

extern "C" int unpack_packed_launch(const float* packed, const int* perm,
                                    const int* color_start, float* aux, int n_worlds,
                                    int n_contacts, int max_colors, int worlds_per_block,
                                    int grid_y, void* stream) {
  if (n_worlds <= 0) return 0;
  if (worlds_per_block < 1 || worlds_per_block > kUnpackMaxWorlds || grid_y < 1 ||
      grid_y > kAuxRows)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)worlds_per_block * n_contacts * sizeof(int);
  const int scatter = smem > (size_t)kSmemBlockMax;
  if (scatter && worlds_per_block != 1) return (int)cudaErrorInvalidValue;
  if (scatter) smem = 0;
  const cudaError_t e = allow_smem(unpack_packed_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = n_contacts % 4 == 0 && reinterpret_cast<uintptr_t>(aux) % 16 == 0;
  const dim3 grid((n_worlds + worlds_per_block - 1) / worlds_per_block, grid_y);
  unpack_packed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      packed, perm, color_start, aux, n_worlds, n_contacts, max_colors,
      worlds_per_block, vec, scatter);
  return (int)cudaGetLastError();
}
