"""PyTorch/CUDA port of tpu_ecm: batched ECM with the digit engine on one GPU.

The JAX package ``tpu_ecm`` beside it is the reference; this package imports
``torch`` and never ``jax``, and takes only the JAX-free host modules of
``tpu_ecm`` (params, primes, native, io.calc, io.savefile, utils.rng).
"""

__version__ = "0.1.0"
