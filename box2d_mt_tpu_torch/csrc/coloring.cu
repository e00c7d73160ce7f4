// Constraint coloring of a batch of worlds, Luby tier (K <= 2048 slots):
// K7, color_walk_kernel, one block a world.
//
// It replaces no TPU kernel: the JAX package colors with XLA operations
// under two nested `lax.while_loop`s (box2d_mt_tpu/ops/coloring.py
// `color_constraints`), and the port's plain version (ops/coloring.py
// `_luby`) builds the (K, K) conflict matrix as a float32 batched product
// and finds each color's maximal independent set in rounds, reading one
// predicate back to the host a round. The argument contract, and that
// plain version which the card-only tests hold this kernel to bit for
// bit, are in ops/coloring.py.
//
// What it computes. With fixed slot priorities, the maximal independent
// set that `_luby` picks for a color is the one a walk in slot order
// picks; color by color that is first-fit greedy coloring in slot order.
// A slot takes the smallest color in 0..MC-2 that no earlier slot sharing
// one of its conflicting (dynamic, active, in-range) endpoints holds, or
// MC-1, the overflow color, when all are taken; an overflow slot marks no
// body. Its rank is its place among the slots of its color in slot order.
// A body's colors so far are a bitmask (MC <= 32, so 31 usable bits).
//
// What bounds it on an H100: latency. The bytes are the endpoints (int64),
// three flag bytes and the int32 color and rank of each slot: 14.2 MB at
// 512 worlds x 1024 slots, 4.2 us at 3.35 TB/s. The walk is a chain of
// shared-memory reads and writes, a few tens of cycles a slot (the next
// slot's masks may be the ones this slot writes). The design keeps
// everything else off that chain: the block stages its world's endpoints
// (narrowed to int32, -1 where the endpoint does not conflict, -2 for an
// inactive slot) with all its threads, coalesced; one thread walks with
// the next slot's endpoints already in registers, and writes each slot's
// color and rank over its endpoints; the block writes them out
// coalesced. A world's shared memory is 8 K + 4 N + 128 bytes (9.3 KB at
// K = 1024, N = 256), so a batch of 512 worlds is one wave. A world past
// the card's shared memory a block (N above ~54000 bodies at K = 2048)
// walks the same way with its endpoints staged in the color and rank
// outputs and its body masks in `masks`, a W x N scratch in global memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxColors = 32;
constexpr int kInactive = -2;        // a staged endpoint of an inactive slot
constexpr int kSmemDefault = 48 * 1024;

// kShared: the endpoints and the body masks in shared memory; else the
// endpoints in `color` and `rank` and the masks in `masks` (W x N)
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
color_walk_kernel(const long long* __restrict__ body_a, const long long* __restrict__ body_b,
                  const uint8_t* __restrict__ conflict_a,
                  const uint8_t* __restrict__ conflict_b,
                  const uint8_t* __restrict__ active, int* __restrict__ color,
                  int* __restrict__ rank, int* __restrict__ overflow,
                  unsigned* __restrict__ masks, int k, int n_bodies, int max_colors) {
  extern __shared__ int smem[];
  __shared__ int count[kMaxColors];
  const size_t base = (size_t)blockIdx.x * k;
  int* end_a = kShared ? smem : color + base;             // then the colors
  int* end_b = kShared ? smem + k : rank + base;          // then the ranks
  unsigned* mask = kShared ? reinterpret_cast<unsigned*>(smem + 2 * k)
                           : masks + (size_t)blockIdx.x * n_bodies;

  for (int i = threadIdx.x; i < k; i += kThreads) {
    const long long a = body_a[base + i], b = body_b[base + i];
    const bool on = active[base + i] != 0;
    end_a[i] = !on ? kInactive
                   : (conflict_a[base + i] && a >= 0 && a < n_bodies ? (int)a : -1);
    end_b[i] = on && conflict_b[base + i] && b >= 0 && b < n_bodies ? (int)b : -1;
  }
  for (int i = threadIdx.x; i < n_bodies; i += kThreads) mask[i] = 0u;
  if (threadIdx.x < kMaxColors) count[threadIdx.x] = 0;
  __syncthreads();

  if (threadIdx.x == 0) {
    const int last = max_colors - 1;
    const unsigned usable = (1u << last) - 1u;            // colors 0..MC-2
    int a = k > 0 ? end_a[0] : 0, b = k > 0 ? end_b[0] : 0;
    for (int i = 0; i < k; ++i) {
      // the next slot's endpoints: no slot's walk writes them
      const int next_a = i + 1 < k ? end_a[i + 1] : 0;
      const int next_b = i + 1 < k ? end_b[i + 1] : 0;
      if (a == kInactive) {
        end_a[i] = -1;
        end_b[i] = 0;
      } else {
        const unsigned taken = (a >= 0 ? mask[a] : 0u) | (b >= 0 ? mask[b] : 0u);
        const unsigned avail = ~taken & usable;
        const int c = avail ? __ffs(avail) - 1 : last;
        const int r = count[c];
        count[c] = r + 1;
        if (c < last) {
          const unsigned bit = 1u << c;
          if (a >= 0) mask[a] |= bit;
          if (b >= 0) mask[b] |= bit;
        }
        end_a[i] = c;
        end_b[i] = r;
      }
      a = next_a;
      b = next_b;
    }
    overflow[blockIdx.x] = count[last];
  }
  if (!kShared) return;                   // the walk wrote the outputs in place
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += kThreads) {
    color[base + i] = end_a[i];
    rank[base + i] = end_b[i];
  }
}

// the shared memory a block may take on the current card
int smem_block_max() {
  static const int bytes = [] {
    int device = 0, value = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return value;
  }();
  return bytes;
}

}  // namespace

// K7: (W, K) int64 endpoints, (W, K) bool conflict flags and active flags
// in; (W, K) int32 color and rank and (W,) int32 overflow out; `masks` a
// (W, N) int32 scratch, used where a world does not fit a block's shared
// memory. One block of kThreads a world, on `stream`; returns a CUDA
// error code.
extern "C" int color_launch(const long long* body_a, const long long* body_b,
                            const uint8_t* conflict_a, const uint8_t* conflict_b,
                            const uint8_t* active, int* color, int* rank, int* overflow,
                            unsigned* masks, int n_worlds, int k, int n_bodies,
                            int max_colors, void* stream) {
  if (n_worlds <= 0) return 0;
  if (k < 0 || n_bodies < 0 || max_colors < 1 || max_colors > kMaxColors)
    return (int)cudaErrorInvalidValue;
  // a world's endpoints a and b (int32, K each) and body masks (uint32, N)
  const size_t smem = sizeof(int) * (2 * (size_t)k + (size_t)n_bodies);
  auto* kernel = color_walk_kernel<true>;
  size_t dynamic = smem;
  if (smem + sizeof(int) * kMaxColors > (size_t)smem_block_max()) {
    kernel = color_walk_kernel<false>;
    dynamic = 0;
  } else if (smem > kSmemDefault - sizeof(int) * kMaxColors) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_worlds, kThreads, dynamic, (cudaStream_t)stream>>>(
      body_a, body_b, conflict_a, conflict_b, active, color, rank, overflow, masks, k,
      n_bodies, max_colors);
  return (int)cudaGetLastError();
}
