"""PyTorch/CUDA port of the desamba_tpu fast classify path.

The package mirrors desamba_tpu's layout (ops/, engine/, cli.py) so each
module's counterpart is easy to find. It imports torch and never jax; the
JAX package's backend-free modules (constants, index/*, io/*, oracle/*,
engine/native.py and the numpy-only top level of engine/fast_engine.py)
are shared, not copied. Hand-written CUDA kernels live in csrc/ and are
built and loaded by kernels.py at first use.
"""
