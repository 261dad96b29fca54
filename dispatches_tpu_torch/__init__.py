"""dispatches_tpu_torch — the PyTorch/CUDA port of `dispatches_tpu`.

The price-taker design sweep (weekly dense IPM and the year-scale
block-tridiagonal IPM) runs on an NVIDIA GPU; the year solves' KKT sweep
chains go through a hand-written CUDA kernel
(`solvers/chain_sweep.py`, source in `csrc/chain_sweep.cu`). The JAX
package `dispatches_tpu` is the reference this port is held against; this
package imports nothing from it, and nothing from JAX.
"""

__version__ = "0.1.0"
