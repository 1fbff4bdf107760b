"""ceedpetscsolid_tpu — matrix-free solid mechanics framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
CeedPetscSolid mini-app (libCEED + PETSc solid mechanics): steady-state
momentum balance on unstructured high-order hexahedral meshes with linear
elasticity, Neo-Hookean hyperelasticity at small and finite strain (plus a
nearly-incompressible finite-strain variant), solved matrix-free with
Newton-Krylov-p-multigrid.

Architecture (bottom up):
  mesh/      — box + Exodus-II hex meshes, per-degree FE spaces, face sets
  ops/       — quadrature, tensor-product bases, element gather/scatter,
               geometric qdata, the fused E-vector operator pipeline
  models/    — pointwise physics kernels (the libCEED "QFunction" analog),
               vectorized over quadrature-point batches
  solve/     — Newton + critical-point line search, PCG (natural norm),
               Chebyshev smoothing, p-multigrid, coarse solves
  parallel/  — element partitioning + halo exchange over a jax device Mesh
  post/      — strain energy, diagnostics, MMS error, VTU output

Everything on the compute path is functionally pure, statically shaped and
jit-compiled; f64 on CPU for verification, f32 (+ compensated reductions)
on the GPU unless CPSTPU_X64=1 asks for f64.
"""

__version__ = "0.1.0"


def _enable_compilation_cache():
    """Persistent XLA compilation cache.

    Kept where JAX_COMPILATION_CACHE_DIR says when it is set; otherwise at a
    fixed path inside the checkout (<repo>/.jax_cache, gitignored): the path
    is part of the cache key, and a directory inside the checkout is found
    again by every process run from it. CPU runs (tests) are not cached.
    Opt out with CPSTPU_NO_CACHE=1."""
    import os

    if os.environ.get("CPSTPU_NO_CACHE"):
        return
    # checked WITHOUT initializing a backend: this runs at import time
    if os.environ.get("JAX_PLATFORMS", "").lower() == "cpu":
        return
    import jax

    if str(jax.config.jax_platforms or "").lower() == "cpu":
        return
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)


_enable_compilation_cache()
