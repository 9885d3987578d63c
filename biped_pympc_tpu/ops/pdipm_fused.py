"""Fused native PDIPM: the whole fixed-iteration solve of every env in one
foreign-function call (`jax.ffi`).

The pure-JAX `ric_aug` backend (`ops/pdipm.py`) runs each Newton iteration
as about nine sequential `lax.scan` sweeps over the horizon on blocks at
most 30 wide; XLA turns that into thousands of tiny kernels per solve. This
module runs the same algorithm — foot-split `ric_aug`, one refinement step,
the reference's "delta" corrector — as one kernel launch per solve
(`native/pdipm_fused.h`). Each env is solved by 16 GPU lanes: lane i holds
row i of every 12-wide stage block, the Gauss-Jordan eliminations and
matvecs go across lanes with warp shuffles, the per-env constant matrices
stay in registers and everything else sits in the env's slice of a scratch
buffer. (The reference's own GPU solver runs one thread per env,
`mpc_controller_cusadi.py:28,144`.)

Two targets implement the one C++ per-env routine:
  * "CUDA": `native/pdipm_fused_cuda.cu`, built with nvcc for sm_90a;
  * "cpu":  `native/pdipm_fused_cpu.cc`, built with g++ — it lets the CPU
    tests drive this exact wrapper (packing, padding, sharding).
Both build into `<repo>/build/` on first use; the library name carries a
hash of the sources, so an edited kernel is never served stale.

The solver supports exactly the shipped configuration in float32 and
raises for anything else; nothing falls back to another solver.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from biped_pympc_tpu.ops.pdipm import PdipmOptions, PdipmResult
from biped_pympc_tpu.ops.qp import StageQP

TARGET = "biped_pdipm_fused_ric_aug"
BATCH_ALIGN = 8  # the CUDA kernel runs whole 8-env blocks (kEnvsPerBlock)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native")
_BUILD = os.path.join(_ROOT, "build")
_registered: set[str] = set()


LANES = 16  # lanes per env


def input_len(T: int) -> int:
    return 528 + 40 * T


def output_lvs(T: int) -> int:
    """Lane vectors of output per env: x_t, u_t, s_t, z_t, y_t, ymx_t, and
    the residuals."""
    return 6 * T + 1


def scratch_lvs(T: int) -> int:
    """Lane vectors of scratch per env (`Layout` in `native/pdipm_fused.h`;
    the handler rejects a mismatch)."""
    return 81 * T + 13


def check_options(opts: PdipmOptions, dtype) -> None:
    """Raise unless (opts, dtype) is the one configuration the kernel runs."""
    want = {
        "backend": "ric_aug", "foot_split": True, "refine_steps": 1,
        "corrector_form": "delta", "refine_residual": "f32",
        "kkt_scale": "none", "sigma_cap": 0.0, "inv_impl": "gj",
    }
    bad = {k: getattr(opts, k) for k, v in want.items()
           if getattr(opts, k) != v}
    if bad:
        raise ValueError(
            f"the fused solver runs only {want}; got {bad}. Use the "
            "pure-JAX ops.pdipm.solve for other options"
        )
    if jnp.dtype(dtype) != jnp.float32:
        raise ValueError(
            f"the fused solver runs in float32 only, got {jnp.dtype(dtype)};"
            " use the pure-JAX ops.pdipm.solve for float64"
        )


def pack(qp: StageQP) -> jnp.ndarray:
    """Batched StageQP (leading batch axis) -> (input_len(T), B) batch-last."""
    B = qp.f.shape[0]
    leaves = (qp.q_diag, qp.r_diag, qp.dyn.A, qp.dyn.B, qp.dyn.c, qp.b0,
              qp.g_u, qp.f, qp.d)
    return jnp.concatenate([a.reshape(B, -1) for a in leaves], axis=1).T


def unpack(out: jnp.ndarray, T: int, B: int) -> PdipmResult:
    """(output_lvs(T), B_padded, LANES) -> PdipmResult with a leading batch
    axis."""
    o = out[:, :B]

    def stages(i, lanes):  # T lane vectors -> (B, T * lanes)
        return o[i * T:(i + 1) * T, :, :lanes].transpose(1, 0, 2).reshape(
            B, T * lanes)

    return PdipmResult(
        x=jnp.concatenate([stages(0, 12), stages(1, 12)], axis=1),
        s=stages(2, 16), z=stages(3, 16),
        y=jnp.concatenate([stages(4, 12), stages(5, 2)], axis=1),
        residuals=o[6 * T, :, :4])


def solve(qp: StageQP, opts: PdipmOptions = PdipmOptions(
        backend="ric_aug", foot_split=True, refine_steps=1)) -> PdipmResult:
    """Batched fused solve; `qp` has a leading batch axis. Cold start only.

    Same contract as `jax.vmap(lambda q: pdipm.solve(q, opts))(qp)`.
    """
    check_options(opts, qp.f.dtype)
    _register_targets()
    B, T = qp.d.shape[0], qp.d.shape[1]
    packed = pack(qp)
    pad = (-B) % BATCH_ALIGN
    if pad:
        # Padded envs solve copies of the last env (a well-posed QP) and
        # are dropped by `unpack`.
        packed = jnp.pad(packed, ((0, 0), (0, pad)), mode="edge")
    bp = B + pad
    call = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((output_lvs(T), bp, LANES), jnp.float32),
         jax.ShapeDtypeStruct((scratch_lvs(T), bp, LANES), jnp.float32)),
    )
    out, _ = call(
        packed,
        horizon=np.int32(T), iterations=np.int32(opts.iterations),
        beta=np.float32(opts.beta), delta=np.float32(opts.delta),
        frac_to_boundary=np.float32(opts.frac_to_boundary),
        alpha_min=np.float32(opts.alpha_min),
        sz_floor=np.float32(opts.sz_floor),
    )
    return unpack(out, T, B)


# ---------------------------------------------------------------------------
# Build and registration.
# ---------------------------------------------------------------------------

def _sources(names):
    h = hashlib.sha256()
    for n in names:
        with open(os.path.join(_SRC, n), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_library(platform: str) -> str:
    """Build (once per source hash) and return the path of the target's
    shared library. Writes to a temporary file and renames it into place,
    so concurrent processes never load a half-written library."""
    if platform == "cpu":
        srcs = ("pdipm_fused.h", "pdipm_fused_cpu.cc")
        compiler = shutil.which(os.environ.get("CXX", "g++"))
        flags = ["-std=c++17", "-O2", "-shared", "-fPIC",
                 "-Wno-unknown-pragmas"]
    else:
        srcs = ("pdipm_fused.h", "pdipm_fused_cuda.cu")
        compiler = shutil.which("nvcc") or (
            "/usr/local/cuda/bin/nvcc"
            if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
        flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC"]
    if compiler is None:
        raise RuntimeError(
            f"no compiler for the fused solver's {platform} target "
            "(g++ for cpu, nvcc for CUDA)")
    lib = os.path.join(_BUILD, f"libpdipm_fused_{platform}-"
                               f"{_sources(srcs)}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [compiler, *flags, "-I", jax.ffi.include_dir(), "-I", _SRC,
           "-o", tmp, os.path.join(_SRC, srcs[1])]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(
            f"building the fused solver failed:\n{' '.join(cmd)}\n{e.stderr}"
        ) from e
    os.replace(tmp, lib)
    return lib


def _register_targets() -> None:
    """Register the FFI target for the default backend's platform ("cpu" or
    "CUDA"). Idempotent."""
    platform = {"cpu": "cpu", "gpu": "CUDA"}.get(jax.default_backend())
    if platform is None:
        raise RuntimeError(
            f"the fused solver has no target for {jax.default_backend()!r}")
    if platform in _registered:
        return
    lib = ctypes.cdll.LoadLibrary(build_library(platform.lower()))
    symbol = ("PdipmFusedRicAugCpu" if platform == "cpu"
              else "PdipmFusedRicAugCuda")
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(getattr(lib, symbol)), platform=platform)
    _registered.add(platform)
