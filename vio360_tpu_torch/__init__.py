"""vio360_tpu_torch — the PyTorch + CUDA port of ``vio360_tpu``.

Same subpackage layout and module names as the JAX package, so the
counterpart of ``vio360_tpu/<path>.py`` is ``vio360_tpu_torch/<path>.py``.
The exceptions are the kernel modules: ``solver/ba_cuda.py`` replaces
``solver/ba_pallas.py`` and ``ops/lk_cuda.py`` replaces
``ops/lk_pallas.py``; their CUDA sources live in ``csrc/``.

The port imports ``torch`` and never ``jax``. It reuses the JAX
package's modules that are free of JAX (``config``, ``io.dataset``,
``io.trajectory``, ``utils.logging``, ``utils.metrics``); importing them
pulls in no JAX because ``vio360_tpu/__init__.py`` imports nothing.

This slice covers monocular VO, sequential, at the default operating
point: see ``cli.py`` for what is refused as not yet ported.
"""

__version__ = "0.1.0"
