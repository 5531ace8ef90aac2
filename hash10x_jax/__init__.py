"""hash10x-jax: a sketch-and-cluster engine for linked-read data in JAX.

A from-scratch JAX/XLA framework with the capabilities of
richarddurbin/hash10x (see SURVEY.md): seqhash-compatible minimizer/modimizer
sketching, a sorted-run k-mer x barcode count table in device memory, and
barcode co-occurrence clustering, with psum/all_gather/all_to_all merges over
a device mesh.

Importing this package enables 64-bit JAX types: the entire hash pipeline is
exact uint64 arithmetic.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: CLI invocations are many short processes, and
# without it every one re-compiles the pipeline.  JAX_COMPILATION_CACHE_DIR
# places it; otherwise it lives at one fixed path in the checkout (the path
# is part of the cache key, so it must not move between runs).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .hashspec import HashSpec, U64MAX  # noqa: E402

__version__ = "0.1.0"
__all__ = ["HashSpec", "U64MAX"]
