"""vio360_tpu_torch — the PyTorch + CUDA port of ``vio360_tpu``.

Same subpackage layout and module names as the JAX package, so the
counterpart of ``vio360_tpu/<path>.py`` is ``vio360_tpu_torch/<path>.py``.
The exceptions are the kernel modules: ``solver/ba_cuda.py`` replaces
``solver/ba_pallas.py``, ``ops/lk_cuda.py`` replaces
``ops/lk_pallas.py`` and ``ops/gather_cuda.py`` replaces
``ops/gather_pallas.py``; their CUDA sources live in ``csrc/``.

The port imports ``torch`` and never ``jax``, and nothing of
``vio360_tpu``: it keeps its own copies of the JAX package's JAX-free
modules it needs (``config``, ``io.dataset``, ``io.trajectory``,
``utils.logging``, ``utils.metrics``).

Ported: monocular VO and VIO at the default operating point (loop
closure, relocalization and the pose graph on), with either LK front
end (``optical_flow.backend``: ``matmul`` for the matmul-gather LK with
kernel K5, else the per-feature kernel K4), checkpoints of either
package (``io.checkpoint``) and the async frame API. See ``cli.py`` for
what is refused as not yet ported.
"""

__version__ = "0.1.0"
