"""PyTorch + CUDA port of the swarm+ABR simulator (NVIDIA H100).

The JAX package ``hlsjs_p2p_wrapper_tpu`` is the reference; this
package is its port, module for module where a reader needs to find
a counterpart (``core/``, ``ops/``, ``testing/``).  It imports
``torch``, ``numpy`` and the standard library only — never ``jax``
and nothing of the reference package, whose few JAX-free pieces it
needs are copied here.

Slice 1 covers the circulant VOD main path (``ops/swarm_sim.py``):
one transfer slot, ``"spread"`` holder selection, an admission cap,
stepped on the card by three hand-written ``sm_90a`` kernels
(``ops/swarm_kernels.py``, ``csrc/swarm_step.cu``).  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
