"""PyTorch + CUDA port of the swarm+ABR simulator (NVIDIA H100).

The JAX package ``hlsjs_p2p_wrapper_tpu`` is the reference; this
package is its port, module for module where a reader needs to find
a counterpart (``core/``, ``ops/``, ``testing/``).  It imports
``torch``, ``numpy`` and the standard library only — never ``jax``
and nothing of the reference package, whose few JAX-free pieces it
needs are copied here.

It covers the circulant path (``ops/swarm_sim.py``), VOD and live: up
to 16 transfer slots (prefetches), ``"spread"`` holder selection, an
admission cap, for one scenario or a stacked batch of scenario lanes,
with the metrics timeline and the chunked grid dispatch with its fault
plane, its row cache, its crash-safe journal and its flight recorder
(``ops/dispatch.py``, ``engine/faults.py``, ``engine/artifact_cache.py``,
``engine/tracer.py``; the grids of ``sweep_grid.py`` and
``policy_grid.py``), the closed-loop policy search (``engine/search.py``,
``search_eval.py``) and the multi-host sweep fabric
(``engine/fabric.py``).  The step and its per-lane
reductions run on the card as hand-written ``sm_90a`` kernels
(``ops/swarm_kernels.py``, ``csrc/``).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
