"""CUDA BVH traversal called through the XLA FFI.

``native/bvh_traverse.cu`` walks the fused node array with one thread
per ray and a private stack (the reference's own GPU design,
shaders/path_tracing.comp:130-209), keeping the contract of
``ops/traverse.py::intersect_scene``: (t, obj, tri) with t = INF and
-1 ids on a miss, hits accepted at t > eps with a strict <, optional
``t_max``, and an early exit under ``any_hit``.

The library is compiled with nvcc into ``native/build/`` at first use
(the way scene/bvh_native.py builds the C++ BVH builder) and registered
as the CUDA handler of one FFI target.  There is no quiet fallback: a
CUDA kernel requested where JAX has no CUDA device, or a library that
fails to build or load, raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np

from logipathtracer_tpu.ops.intersect import INF

TARGET = "lpt_bvh_traverse"
MAX_STACK = 64  # kMaxStack in native/bvh_traverse.cu

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE, "bvh_traverse.cu")
_SO = os.path.join(_NATIVE, "build", "libbvh_traverse.so")

_LOCK = threading.Lock()
_REGISTERED = [False]


def cuda_available() -> bool:
    """True when this process's JAX has at least one CUDA device."""
    try:
        return bool(jax.devices("cuda"))
    except RuntimeError:
        return False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build_command(out: str) -> list[str]:
    """The nvcc command that builds the kernel library into ``out``."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", out, _SRC]


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    source; return its path.  Raises RuntimeError when nvcc fails or
    cannot be found."""
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    cmd = build_command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run nvcc ({cmd[0]}): {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {_SRC}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, _SO)
    return _SO


def ensure_registered() -> None:
    """Build (if needed), load and register the FFI target once per
    process."""
    with _LOCK:
        if _REGISTERED[0]:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.LptBvhTraverse), platform="CUDA")
        _REGISTERED[0] = True


def kernel_operands(scene, origin, direction, t_max=None):
    """The kernel's eight operands, in order: rays [R, 3] x2, t_max [R]
    (INF where none is given — the same bound the walk starts from),
    the fused nodes (min [M, 3], max [M, 3], meta [M, 4] i32), the
    object inverses padded with an identity slot 0 ([O+1, 12]) and the
    triangle vertices [3T, 3]."""
    from logipathtracer_tpu.ops.traverse import _padded_inverses
    r = origin.shape[0]
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    tm = (jnp.full((r,), INF, jnp.float32) if t_max is None
          else jnp.broadcast_to(f32(t_max), (r,)))
    inv = _padded_inverses(scene).reshape(-1, 12)
    return (f32(origin).reshape(r, 3), f32(direction).reshape(r, 3), tm,
            f32(scene.fused_min), f32(scene.fused_max),
            jnp.asarray(scene.fused_meta, jnp.int32), f32(inv),
            f32(scene.vtx_pos))


def call_kernel(scene, origin, direction, eps: float = 1e-4, t_max=None,
                any_hit: bool = False):
    """Stage the FFI call (the target must be registered before the
    program is compiled for a CUDA device)."""
    if scene.max_stack > MAX_STACK:
        raise ValueError(f"scene needs a traversal stack of "
                         f"{scene.max_stack} > {MAX_STACK}")
    r = origin.shape[0]
    out = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((r,), jnp.float32),
         jax.ShapeDtypeStruct((r,), jnp.int32),
         jax.ShapeDtypeStruct((r,), jnp.int32)))(
        *kernel_operands(scene, origin, direction, t_max),
        eps=np.float32(eps), any_hit=np.int32(bool(any_hit)),
        max_stack=np.int32(scene.max_stack))
    return tuple(out)


def intersect_scene_cuda(scene, origin, direction, eps: float = 1e-4,
                         t_max=None, any_hit: bool = False):
    """``intersect_scene`` on the CUDA kernel (RenderConfig
    intersect="cuda").  Raises RuntimeError where JAX has no CUDA
    device, instead of running anything else."""
    if not cuda_available():
        raise RuntimeError(
            "intersect='cuda' needs a CUDA device; JAX has "
            f"{[d.platform for d in jax.devices()]}")
    ensure_registered()
    return call_kernel(scene, origin, direction, eps=eps, t_max=t_max,
                       any_hit=any_hit)
