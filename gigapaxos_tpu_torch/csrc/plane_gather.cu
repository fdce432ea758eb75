// Hand-written Hopper (sm_90a) kernels for the fused tick's two plane
// selects, bound to Python through a plain C interface (ctypes).
//
// gp_gather_planes replaces the Pallas kernel _gather_kernel
// (gigapaxos_tpu/ops/pallas_gather.py, gather_planes_pallas):
//     out_k[l, j, g] = arr_k[l, idx[(l,) j, g], g]     for k < K <= 8
// a per-lane gather along the ring-plane axis.  The tick gathers in five
// sets whose arrays share one index, and each set is one launch.
//
// gp_match_planes replaces the Pallas kernel _kernel_match
// (gigapaxos_tpu/ops/pallas_gather.py, match_planes_pallas):
//     out_k[j, g] = vals_k[e, g] for the e with keys[e, g] == idx[j, g],
//     else 0, the highest e winning on duplicate keys;   k < K <= 4
// the tick's intake select, one launch per tick for its two vals arrays.
//
// gp_scatter_inbox replaces no TPU kernel (the JAX package uploads the
// dense [R, P, G] inbox whole); it builds the Mode A inbox on the card
// from one tick's placements (see its section below).
//
// What bounds them: both are selects with little arithmetic, so
// device-memory bytes do.  At the tick's shape (R=3, W=8, P=4, G=2^20) the
// five gather sets move 2,970 MB and the match 189 MB per tick when every
// array, every output and the shared index cross device memory once: about
// 0.94 ms at 3.35 TB/s.  One launch per array would read the [8, G] or
// [3, 8, G] int32 index again for every array (3,876 MB for the gathers).
//
// What the design does about it:
// - One launch per set of arrays that share an index: the index is read
//   once into registers and serves every array and, for a shared index,
//   every leading index l (the thread walks l itself).
// - A thread owns kV = 4 consecutive lanes, so it moves int32 planes as
//   16-byte vectors and bool planes as one 4-byte word, through the
//   read-only path (ld.global.nc; outputs never alias inputs).  Neighbouring
//   threads own neighbouring lanes, so every warp access is coalesced.
// - For each array the thread issues all Wp plane loads before any
//   select, which keeps Wp * 16 bytes in flight per thread (int32).  The
//   Wp-way select runs on registers (the TPU kernel ran it in VMEM): a
//   three-level tree on the index bits for int32 (pick8), a per-byte
//   compare that selects four bool lanes at once for bool.
// - The match reads each entry's key once and runs one select chain per
//   vals array on it (KM chains, KM a template bound on the array count).
// - Ragged G, or a pointer that is not aligned (a contiguous view with a
//   storage offset), makes the wrapper clear the `vec` flag: the same
//   kernel (for the gather, its VEC = false instantiation) then moves each
//   lane with scalar loads and masks the edge.
// - An index outside [0, Wp) gives 0, as the Pallas kernel does.  More
//   than kPlanes planes (WIDE) or kRows output rows are walked in chunks of
//   that size (Wp <= 32 either way).  The gather's offsets within one
//   leading index are int32 (the wrappers bound G), the rest int64_t.
// TMA buys nothing here: each thread's data is a few coalesced 16-byte
// chunks that no other thread reads, so staging in shared memory would only
// add bytes in flight, which the vector loads already give.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // small blocks: occupancy by registers rounds finer
constexpr int kV = 4;          // lanes per thread
constexpr int kPlanes = 8;     // arr planes held in registers at once
constexpr int kRows = 8;       // output rows whose index is held at once
constexpr int kMaxPlanes = 32;
constexpr int kMaxGather = 8;  // arrays per gather launch
constexpr int kMaxMatch = 4;   // vals arrays per match launch
// the gather's offsets within one lead stay in int32
constexpr int64_t kMaxLanes = ((int64_t{1} << 31) - 1) / kMaxPlanes;

struct GatherArgs {
  const void* in[kMaxGather];   // [lead, wp, g] each
  void* out[kMaxGather];        // [lead, j_out, g] each
  int elem[kMaxGather];         // element bytes: 4 or 1
  const int32_t* idx;           // [j_out, g], or [lead, j_out, g] (perlead)
  int64_t g, lead;
  int k, wp, j_out, perlead;
};

struct MatchArgs {
  const void* vals[kMaxMatch];  // [e_planes, g] each
  void* out[kMaxMatch];         // [j_out, g] each
  int elem[kMaxMatch];
  const int32_t* keys;          // [e_planes, g]
  const int32_t* idx;           // [j_out, g]
  int64_t g;
  int k, e_planes, j_out, vec;
};

// ---- lane-quad loads and stores: `left` = lanes from this quad to g -----

template <bool VEC>
__device__ __forceinline__ void load_i32(const int32_t* p, int64_t left,
                                         int32_t (&v)[kV]) {
  if (VEC) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int u = 0; u < kV; ++u) v[u] = (u < left) ? __ldg(p + u) : 0;
  }
}

template <bool VEC>
__device__ __forceinline__ uint32_t load_u8(const uint8_t* p, int64_t left) {
  if (VEC) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t w = 0;
#pragma unroll
  for (int u = 0; u < kV; ++u)
    if (u < left) w |= static_cast<uint32_t>(__ldg(p + u)) << (8 * u);
  return w;
}

template <bool VEC>
__device__ __forceinline__ void store_i32(int32_t* p, int64_t left,
                                          const int32_t (&v)[kV]) {
  if (VEC) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int u = 0; u < kV; ++u)
      if (u < left) p[u] = v[u];
  }
}

template <bool VEC>
__device__ __forceinline__ void store_u8(uint8_t* p, int64_t left,
                                         uint32_t w) {
  if (VEC) {
    *reinterpret_cast<uint32_t*>(p) = w;
  } else {
#pragma unroll
    for (int u = 0; u < kV; ++u)
      if (u < left) p[u] = static_cast<uint8_t>(w >> (8 * u));
  }
}

// ------------------------------------------------------------- gather

// Lane u of plane s among eight, chosen by the bits of s (seven selects);
// an s outside [0, 8) gives 0.  A chain of s == i compares would do, but
// the compiler turns such a chain into an indexed read of v, which puts v
// in local memory (a 128-byte stack frame in ptxas's report).
__device__ __forceinline__ int32_t pick8(const int32_t (&v)[kPlanes][kV],
                                         int u, int32_t s) {
  const bool b0 = s & 1, b1 = s & 2, b2 = s & 4;
  const int32_t t01 = b0 ? v[1][u] : v[0][u];
  const int32_t t23 = b0 ? v[3][u] : v[2][u];
  const int32_t t45 = b0 ? v[5][u] : v[4][u];
  const int32_t t67 = b0 ? v[7][u] : v[6][u];
  const int32_t t03 = b1 ? t23 : t01;
  const int32_t t47 = b1 ? t67 : t45;
  const int32_t t = b2 ? t47 : t03;
  return static_cast<uint32_t>(s) < kPlanes ? t : 0;
}

// Output rows [0, nj) of one lead of one int32 array: `a` points at plane
// 0 and `o` at output row 0, both at this thread's first lane; `gs` is the
// row stride in lanes.  WIDE: more planes than registers hold, so each
// output row walks the planes in chunks.
template <bool VEC, bool WIDE>
__device__ __forceinline__ void gather_i32(const int32_t* a, int32_t* o,
                                           const int32_t (&s)[kRows][kV],
                                           int wp, int nj, int gs,
                                           int64_t left) {
  if (!WIDE) {
    int32_t v[kPlanes][kV];
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) {
      if (i < wp) {
        load_i32<VEC>(a + i * gs, left, v[i]);
      } else {
#pragma unroll
        for (int u = 0; u < kV; ++u) v[i][u] = 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < nj) {
        int32_t r[kV];
#pragma unroll
        for (int u = 0; u < kV; ++u) r[u] = pick8(v, u, s[j][u]);
        store_i32<VEC>(o + j * gs, left, r);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (j < nj) {
      int32_t r[kV] = {0, 0, 0, 0};
      for (int p0 = 0; p0 < wp; p0 += kPlanes) {
        int32_t v[kPlanes][kV];
#pragma unroll
        for (int i = 0; i < kPlanes; ++i) {
          if (p0 + i < wp) {
            load_i32<VEC>(a + (p0 + i) * gs, left, v[i]);
          } else {
#pragma unroll
            for (int u = 0; u < kV; ++u) v[i][u] = 0;
          }
        }
#pragma unroll
        for (int u = 0; u < kV; ++u)
#pragma unroll
          for (int i = 0; i < kPlanes; ++i)
            r[u] = (s[j][u] == p0 + i) ? v[i][u] : r[u];
      }
      store_i32<VEC>(o + j * gs, left, r);
    }
  }
}

// The same for a bool array, four lanes to a word: `sb[j]` holds the four
// lanes' plane indices as bytes (0xff where out of range), and a per-byte
// compare selects all four lanes at once.  Bool bytes are 0 or 1, and at
// most one plane matches a byte, so OR-ing the masked planes selects.
template <bool VEC, bool WIDE>
__device__ __forceinline__ void gather_u8(const uint8_t* a, uint8_t* o,
                                          const uint32_t (&sb)[kRows], int wp,
                                          int nj, int gs, int64_t left) {
  if (!WIDE) {
    uint32_t v[kPlanes];
#pragma unroll
    for (int i = 0; i < kPlanes; ++i)
      v[i] = (i < wp) ? load_u8<VEC>(a + i * gs, left) : 0u;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < nj) {
        uint32_t r = 0;
#pragma unroll
        for (int i = 0; i < kPlanes; ++i)
          r |= v[i] & __vcmpeq4(sb[j], 0x01010101u * i);
        store_u8<VEC>(o + j * gs, left, r);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (j < nj) {
      uint32_t r = 0;
      for (int p0 = 0; p0 < wp; p0 += kPlanes) {
#pragma unroll
        for (int i = 0; i < kPlanes; ++i) {
          const uint32_t v =
              (p0 + i < wp) ? load_u8<VEC>(a + (p0 + i) * gs, left) : 0u;
          r |= v & __vcmpeq4(sb[j], 0x01010101u * (p0 + i));
        }
      }
      store_u8<VEC>(o + j * gs, left, r);
    }
  }
}

// VEC and WIDE are template flags the host picks, so each instantiation
// holds one path: with `vec` read at run time instead, the vector and the
// scalar path shared one register budget, which took more registers and
// slowed the fused sets on an H100.
template <bool VEC, bool WIDE>
__global__ void __launch_bounds__(kThreads)
gather_planes_kernel(const __grid_constant__ GatherArgs a) {
  const int64_t g0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kV;
  if (g0 >= a.g) return;
  const int64_t left = a.g - g0;
  const int gs = static_cast<int>(a.g);
  for (int j0 = 0; j0 < a.j_out; j0 += kRows) {
    const int nj = min(kRows, a.j_out - j0);
    int32_t s[kRows][kV];
    uint32_t sb[kRows];
    for (int64_t l = 0; l < a.lead; ++l) {
      if (l == 0 || a.perlead) {
        const int32_t* ix =
            a.idx + ((a.perlead ? l * a.j_out : 0) + j0) * a.g + g0;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (j < nj) {
            load_i32<VEC>(ix + j * gs, left, s[j]);
          } else {
#pragma unroll
            for (int u = 0; u < kV; ++u) s[j][u] = -1;
          }
          sb[j] = 0;
#pragma unroll
          for (int u = 0; u < kV; ++u) {
            const uint32_t b = static_cast<uint32_t>(s[j][u]);
            sb[j] |= (b < 0xffu ? b : 0xffu) << (8 * u);
          }
        }
      }
      const int64_t in_off = l * a.wp * a.g + g0;
      const int64_t out_off = (l * a.j_out + j0) * a.g + g0;
      for (int k = 0; k < a.k; ++k) {
        if (a.elem[k] == 4)
          gather_i32<VEC, WIDE>(static_cast<const int32_t*>(a.in[k]) + in_off,
                                static_cast<int32_t*>(a.out[k]) + out_off, s,
                                a.wp, nj, gs, left);
        else
          gather_u8<VEC, WIDE>(static_cast<const uint8_t*>(a.in[k]) + in_off,
                               static_cast<uint8_t*>(a.out[k]) + out_off, sb,
                               a.wp, nj, gs, left);
      }
    }
  }
}

// -------------------------------------------------------------- match

// Output rows [j0, j0 + nj) of every vals array.  The keys and index are
// read once; each entry e's compares are shared by the KM select chains.
template <int KM, bool VEC>
__device__ __forceinline__ void match_lanes(const MatchArgs& a, int64_t g0) {
  const int64_t g = a.g, left = g - g0;
  for (int j0 = 0; j0 < a.j_out; j0 += kRows) {
    const int nj = min(kRows, a.j_out - j0);
    int32_t want[kRows][kV];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < nj) {
        load_i32<VEC>(a.idx + (j0 + j) * g + g0, left, want[j]);
      } else {
#pragma unroll
        for (int u = 0; u < kV; ++u) want[j][u] = 0;
      }
    }
    int32_t acc[KM][kRows][kV];
#pragma unroll
    for (int k = 0; k < KM; ++k)
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int u = 0; u < kV; ++u) acc[k][j][u] = 0;
#pragma unroll 2
    for (int e = 0; e < a.e_planes; ++e) {
      const int64_t off = e * g + g0;
      int32_t key[kV];
      load_i32<VEC>(a.keys + off, left, key);
      int32_t v[KM][kV];
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (k < a.k && a.elem[k] == 4) {
          load_i32<VEC>(static_cast<const int32_t*>(a.vals[k]) + off, left,
                        v[k]);
        } else {
          const uint32_t w =
              (k < a.k) ? load_u8<VEC>(
                              static_cast<const uint8_t*>(a.vals[k]) + off,
                              left)
                        : 0u;
#pragma unroll
          for (int u = 0; u < kV; ++u) v[k][u] = (w >> (8 * u)) & 0xff;
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          const bool hit = key[u] == want[j][u];
#pragma unroll
          for (int k = 0; k < KM; ++k) acc[k][j][u] = hit ? v[k][u] : acc[k][j][u];
        }
    }
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k >= a.k) continue;
      const int64_t off = j0 * g + g0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j >= nj) continue;
        if (a.elem[k] == 4) {
          store_i32<VEC>(static_cast<int32_t*>(a.out[k]) + off + j * g, left,
                         acc[k][j]);
        } else {
          uint32_t w = 0;
#pragma unroll
          for (int u = 0; u < kV; ++u)
            w |= static_cast<uint32_t>(acc[k][j][u]) << (8 * u);
          store_u8<VEC>(static_cast<uint8_t*>(a.out[k]) + off + j * g, left,
                        w);
        }
      }
    }
  }
}

template <int KM>
__global__ void __launch_bounds__(kThreads)
match_planes_kernel(const __grid_constant__ MatchArgs a) {
  const int64_t g0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kV;
  if (g0 >= a.g) return;
  if (a.vec)
    match_lanes<KM, true>(a, g0);
  else
    match_lanes<KM, false>(a, g0);
}

// 16-byte rows for int32, 4-byte rows for bool: g % kV == 0 and the base
// pointer aligned to a full lane quad.
bool quad_aligned(const void* p, int elem, int64_t g) {
  return g % kV == 0 && reinterpret_cast<uintptr_t>(p) % (elem * kV) == 0;
}

unsigned grid_of(int64_t g) {
  return static_cast<unsigned>((g + int64_t{kV} * kThreads - 1) /
                               (int64_t{kV} * kThreads));
}

// ------------------------------------------------------ inbox scatter

// One tick's placements into a zeroed inbox: req[idx[i]] = rid[i] and
// stp[idx[i]] = stop[i] != 0 for i < n, idx the flat slot
// (entry * P + p) * G + row.  The host copies 12 bytes a placement instead
// of the dense staging (5 bytes a slot, 63 MB at R=3, P=4, G=2^20, nearly
// all zeros).  What bounds it: 12n coalesced bytes read and n scattered
// 4- and 1-byte stores, microseconds at the thousands of placements a
// tick carries; the memset of the zeroed inbox before it moves more.  One
// thread a placement: a tick places each slot at most once, so no two
// stores meet.  Every index lies in [0, total): the uploader checks the
// packed columns on the host, where its plain version would raise.
__global__ void __launch_bounds__(kThreads)
scatter_inbox_kernel(const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ rid,
                     const int32_t* __restrict__ stop, int64_t n,
                     int32_t* __restrict__ req, uint8_t* __restrict__ stp) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t f = __ldg(idx + i);
  req[f] = __ldg(rid + i);
  stp[f] = __ldg(stop + i) != 0 ? 1 : 0;
}

}  // namespace

// Return codes: 0 = launched; > 0 = the cudaError_t of the launch;
// -1 = a count or shape argument out of the supported range; -2 = element
// size other than 4 or 1 bytes; -3 = `vec` set for data that is not
// quad-aligned.
extern "C" int gp_gather_planes(const void* const* in, void* const* out,
                                const int* elem_bytes, int k, const void* idx,
                                int64_t lead, int wp, int j_out, int64_t g,
                                int perlead, int vec, void* stream) {
  if (k < 1 || k > kMaxGather || lead < 1 || wp < 1 || wp > kMaxPlanes ||
      j_out < 1 || g < 1 || g > kMaxLanes)
    return -1;
  GatherArgs a{};
  for (int i = 0; i < k; ++i) {
    if (elem_bytes[i] != 4 && elem_bytes[i] != 1) return -2;
    if (vec && !(quad_aligned(in[i], elem_bytes[i], g) &&
                 quad_aligned(out[i], elem_bytes[i], g)))
      return -3;
    a.in[i] = in[i];
    a.out[i] = out[i];
    a.elem[i] = elem_bytes[i];
  }
  if (vec && !quad_aligned(idx, 4, g)) return -3;
  a.idx = static_cast<const int32_t*>(idx);
  a.g = g;
  a.lead = lead;
  a.k = k;
  a.wp = wp;
  a.j_out = j_out;
  a.perlead = perlead ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = wp > kPlanes;
  if (vec && !wide)
    gather_planes_kernel<true, false><<<grid_of(g), kThreads, 0, s>>>(a);
  else if (vec)
    gather_planes_kernel<true, true><<<grid_of(g), kThreads, 0, s>>>(a);
  else if (!wide)
    gather_planes_kernel<false, false><<<grid_of(g), kThreads, 0, s>>>(a);
  else
    gather_planes_kernel<false, true><<<grid_of(g), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gp_match_planes(const void* const* vals, void* const* out,
                               const int* elem_bytes, int k, const void* keys,
                               const void* idx, int e_planes, int j_out,
                               int64_t g, int vec, void* stream) {
  if (k < 1 || k > kMaxMatch || e_planes < 1 || j_out < 1 ||
      j_out > kMaxPlanes || g < 1 || g > kMaxLanes)
    return -1;
  MatchArgs a{};
  for (int i = 0; i < k; ++i) {
    if (elem_bytes[i] != 4 && elem_bytes[i] != 1) return -2;
    if (vec && !(quad_aligned(vals[i], elem_bytes[i], g) &&
                 quad_aligned(out[i], elem_bytes[i], g)))
      return -3;
    a.vals[i] = vals[i];
    a.out[i] = out[i];
    a.elem[i] = elem_bytes[i];
  }
  if (vec && !(quad_aligned(keys, 4, g) && quad_aligned(idx, 4, g)))
    return -3;
  a.keys = static_cast<const int32_t*>(keys);
  a.idx = static_cast<const int32_t*>(idx);
  a.g = g;
  a.k = k;
  a.e_planes = e_planes;
  a.j_out = j_out;
  a.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1)
    match_planes_kernel<1><<<grid_of(g), kThreads, 0, s>>>(a);
  else if (k == 2)
    match_planes_kernel<2><<<grid_of(g), kThreads, 0, s>>>(a);
  else
    match_planes_kernel<4><<<grid_of(g), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gp_scatter_inbox(const void* idx, const void* rid,
                                const void* stop, int64_t n, void* req,
                                void* stp, int64_t total, void* stream) {
  if (n < 1 || total < 1 || total > INT32_MAX) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  scatter_inbox_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(rid),
      static_cast<const int32_t*>(stop), n, static_cast<int32_t*>(req),
      static_cast<uint8_t*>(stp));
  return static_cast<int>(cudaGetLastError());
}
