// Closest-hit / any-hit BVH traversal, one ray per thread, called from
// JAX through the XLA FFI (ops/traverse_cuda.py builds and registers it).
//
// Each thread walks the fused two-level node array of scene/types.py
// with its own stack, the reference's own per-thread design
// (shaders/path_tracing.comp:130-209).  The contract, arithmetic and
// visiting order are those of the lax.while_loop walk in
// ops/traverse.py (intersect_scene), which stays the plain reference:
//
//   * inner node: test both children (a, then b) against the ray in
//     the space of the object each child is tagged with (identity for
//     world-space nodes), push those that pass; b is popped first;
//   * leaf: Moller-Trumbore on triangles [a, b), accept t > eps and
//     t < best (strict), best starting at t_max;
//   * any_hit: stop at the first accepted hit (shadow queries read
//     only the predicate t < t_max);
//   * a ray with no accepted hit returns t = INF, obj = tri = -1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        -shared -Xcompiler -fPIC -I <jax.ffi.include_dir()>

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxStack = 64;
constexpr float kInf = 3.4e38f;  // ops/intersect.py INF
constexpr int kBlock = 128;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 load3(const float* p, int64_t i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

// XLA's min/max propagate NaN; fminf/fmaxf would drop it and let an
// axis-parallel ray that starts on a slab plane pass the test.
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// ops/intersect.py ray_aabb_test.
__device__ __forceinline__ bool slab(V3 o, V3 inv, V3 lo, V3 hi,
                                     float best) {
  float nx = (lo.x - o.x) * inv.x, fx = (hi.x - o.x) * inv.x;
  float ny = (lo.y - o.y) * inv.y, fy = (hi.y - o.y) * inv.y;
  float nz = (lo.z - o.z) * inv.z, fz = (hi.z - o.z) * inv.z;
  float t0 = nmax(nmax(nmin(nx, fx), nmin(ny, fy)), nmin(nz, fz));
  float t1 = nmin(nmin(nmax(nx, fx), nmax(ny, fy)), nmax(nz, fz));
  if (t0 > t1) return false;
  return t0 > 0.0f ? t0 < best : t1 > 0.0f;
}

// ops/intersect.py ray_triangle: no backface cull, no determinant
// guard (a degenerate triangle yields inf/NaN, which the acceptance
// test rejects).
__device__ __forceinline__ float triangle(V3 o, V3 d, V3 v0, V3 v1, V3 v2) {
  V3 e1 = sub(v1, v0);
  V3 e2 = sub(v2, v0);
  V3 p = cross(d, e2);
  float det = 1.0f / dot(e1, p);
  V3 tv = sub(o, v0);
  float u = dot(tv, p) * det;
  V3 q = cross(tv, e1);
  float v = dot(d, q) * det;
  float t = dot(e2, q) * det;
  bool miss = (u < 0.0f) | (u > 1.0f) | (v < 0.0f) | (u + v > 1.0f);
  return miss ? kInf : t;
}

// Ray in the space of object slot `s` of the padded inverse table
// (slot 0 = identity; ops/traverse.py _padded_inverses).
__device__ __forceinline__ void local_ray(const float* inv, int s, V3 o,
                                          V3 d, V3* lo, V3* ld) {
  const float* m = inv + 12 * s;
  float r[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) r[k] = __ldg(m + k);
  lo->x = r[0] * o.x + r[1] * o.y + r[2] * o.z + r[3];
  lo->y = r[4] * o.x + r[5] * o.y + r[6] * o.z + r[7];
  lo->z = r[8] * o.x + r[9] * o.y + r[10] * o.z + r[11];
  ld->x = r[0] * d.x + r[1] * d.y + r[2] * d.z;
  ld->y = r[4] * d.x + r[5] * d.y + r[6] * d.z;
  ld->z = r[8] * d.x + r[9] * d.y + r[10] * d.z;
}

__global__ void __launch_bounds__(kBlock)
    traverse(int64_t n, const float* __restrict__ origin,
             const float* __restrict__ direction,
             const float* __restrict__ t_max,
             const float* __restrict__ node_min,
             const float* __restrict__ node_max,
             const int4* __restrict__ node_meta,
             const float* __restrict__ inv,
             const float* __restrict__ vtx, float eps, bool any_hit,
             float* __restrict__ out_t, int* __restrict__ out_obj,
             int* __restrict__ out_tri) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const V3 o = load3(origin, i);
  const V3 d = load3(direction, i);
  float best = t_max[i];
  int best_obj = -1, best_tri = -1;

  int stack[kMaxStack];
  int sp = 1;
  stack[0] = 0;
  int cur = -2;  // object slot of the cached local ray
  V3 lo{}, ld{}, linv{};

  while (sp > 0) {
    const int4 meta = __ldg(node_meta + stack[--sp]);
    if (meta.x == 0) {
      const int child[2] = {meta.y, meta.z};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int slot = __ldg(&node_meta[child[c]].w) + 1;
        if (slot != cur) {
          local_ray(inv, slot, o, d, &lo, &ld);
          linv = {1.0f / ld.x, 1.0f / ld.y, 1.0f / ld.z};
          cur = slot;
        }
        if (slab(lo, linv, load3(node_min, child[c]),
                 load3(node_max, child[c]), best)) {
          stack[sp++] = child[c];
        }
      }
    } else {
      const int slot = meta.w + 1;
      if (slot != cur) {
        local_ray(inv, slot, o, d, &lo, &ld);
        linv = {1.0f / ld.x, 1.0f / ld.y, 1.0f / ld.z};
        cur = slot;
      }
      for (int t = meta.y; t < meta.z; ++t) {
        const float h = triangle(lo, ld, load3(vtx, 3 * t),
                                 load3(vtx, 3 * t + 1),
                                 load3(vtx, 3 * t + 2));
        if (h > eps && h < best) {
          best = h;
          best_obj = meta.w;
          best_tri = t;
        }
      }
      if (any_hit && best_tri >= 0) break;
    }
  }
  out_t[i] = best_tri >= 0 ? best : kInf;
  out_obj[i] = best_obj;
  out_tri[i] = best_tri;
}

ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> origin,
                        ffi::Buffer<ffi::F32> direction,
                        ffi::Buffer<ffi::F32> t_max,
                        ffi::Buffer<ffi::F32> node_min,
                        ffi::Buffer<ffi::F32> node_max,
                        ffi::Buffer<ffi::S32> node_meta,
                        ffi::Buffer<ffi::F32> inv, ffi::Buffer<ffi::F32> vtx,
                        float eps, int32_t any_hit, int32_t max_stack,
                        ffi::ResultBuffer<ffi::F32> out_t,
                        ffi::ResultBuffer<ffi::S32> out_obj,
                        ffi::ResultBuffer<ffi::S32> out_tri) {
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  if (max_stack > kMaxStack) {
    return ffi::Error::InvalidArgument(
        "scene needs a traversal stack of " + std::to_string(max_stack) +
        " > " + std::to_string(kMaxStack));
  }
  if (origin.element_count() != 3 * static_cast<size_t>(n) ||
      direction.element_count() != 3 * static_cast<size_t>(n) ||
      node_meta.element_count() != 4 * node_min.element_count() / 3) {
    return ffi::Error::InvalidArgument("bvh_traverse: inconsistent shapes");
  }
  if (n == 0) return ffi::Error::Success();
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  traverse<<<blocks, kBlock, 0, stream>>>(
      n, origin.typed_data(), direction.typed_data(), t_max.typed_data(),
      node_min.typed_data(), node_max.typed_data(),
      reinterpret_cast<const int4*>(node_meta.typed_data()),
      inv.typed_data(), vtx.typed_data(), eps, any_hit != 0,
      out_t->typed_data(), out_obj->typed_data(), out_tri->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("bvh_traverse launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LptBvhTraverse, TraverseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // origin
                                  .Arg<ffi::Buffer<ffi::F32>>()  // direction
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_max
                                  .Arg<ffi::Buffer<ffi::F32>>()  // node_min
                                  .Arg<ffi::Buffer<ffi::F32>>()  // node_max
                                  .Arg<ffi::Buffer<ffi::S32>>()  // node_meta
                                  .Arg<ffi::Buffer<ffi::F32>>()  // inverses
                                  .Arg<ffi::Buffer<ffi::F32>>()  // vtx_pos
                                  .Attr<float>("eps")
                                  .Attr<int32_t>("any_hit")
                                  .Attr<int32_t>("max_stack")
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // obj
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tri
);
