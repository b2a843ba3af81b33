"""boslam_tpu — an RGBD SLAM engine in JAX.

A from-scratch re-design of the capabilities of the reference system
``BOpermanis/boslam`` (an ORB-SLAM2-style pure-Python RGBD SLAM pipeline that
delegates hot loops to cv2/g2o/DBoW3; see SURVEY.md §0–§3) as a JAX/XLA
engine:

- ORB-style feature frontend   -> batched jnp (features/)
- brute-force Hamming matching -> packed XOR+popcount / bf16 bit-matmul (matching/)
- PnP + motion-only BA         -> robust Gauss-Newton on SE3 (solvers/)
- covisibility map             -> fixed-capacity pytree of arrays (mapping/)
- local/global bundle adjustment with Schur complement -> solvers/local_ba.py
- loop closure: place recognition + pose-graph optimization (loopclosure/)
- multi-device scaling via jax.sharding Mesh + collectives (parallel/)

The whole engine state is a pytree; every pipeline stage is a pure, jittable
``(state, frame) -> (state, out)`` function with static shapes and validity
masks (SURVEY.md §7.0).
"""

import os as _os

import jax as _jax

# Persistent compilation cache: the fused frame step is one large XLA
# program that takes minutes to compile cold.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; only without it does the engine pick a
# directory, a fixed absolute one in the checkout (the path is part of the
# cache key, so a moving directory never hits).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.abspath(
            _os.path.join(_os.path.dirname(__file__), "..", ".jax_cache")
        ),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

from boslam_tpu.config import SlamConfig

__version__ = "0.1.0"

__all__ = ["SlamConfig", "__version__"]
