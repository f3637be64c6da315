"""PyTorch/CUDA port of tpu_ecm: batched ECM on one GPU, with the digit
engine (generic REDC and Mersenne-form folds, Suyama and Edwards stage 1)
and the RNS engine for large moduli.

The JAX package ``tpu_ecm`` beside it is the reference.  This package
imports ``torch`` and nothing of ``tpu_ecm``: it keeps its own copies of the
host modules it needs (params, primes, native, io.calc, io.savefile,
utils.rng, and the curve planners).
"""

__version__ = "0.1.0"
