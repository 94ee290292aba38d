"""PyTorch + CUDA port of :mod:`warpconvnet_tpu` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module paths
and keeps its public layout (padded ``[B, N, C]`` features with ``num_valid``,
``PAD_COORD`` pad rows, ``[K, C_in, C_out]`` weights, ``[B, K, N_out]`` int32
pair tables) so each function can be held against its JAX counterpart.
It imports ``torch`` and never ``jax``.
"""
