"""PyTorch/CUDA port of the desamba_tpu fast classify path.

The package mirrors desamba_tpu's layout (ops/, engine/, index/, io/,
cli.py) so each module's counterpart is easy to find. It stands alone: it
imports torch and numpy, never jax and nothing of the JAX package, and
keeps its own copies of what it needs from the JAX package's jax-free
modules (constants, the index reader, the FASTA/FASTQ reader, the native
engine's binding). It reads the C reference's on-disk index format and
runs the host C++ engine in native/ for the exact replay. Hand-written
CUDA kernels live in csrc/ and are built and loaded by kernels.py at
first use.
"""
