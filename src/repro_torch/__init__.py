"""gZCCL compressed collectives in PyTorch with hand-written CUDA kernels.

The PyTorch/CUDA counterpart of the ``repro`` JAX package, module for
module.  It imports ``torch`` and ``numpy`` and nothing of JAX or of the
``repro`` package.
"""
