"""PyTorch/CUDA port of espnet_slurp_tpu (the JAX package stays the reference).

Mirrors the reference layout (ops/, models/, decode/, data/, tasks/,
train/, utils/). Imports torch and numpy only, never jax, flax or anything of
espnet_slurp_tpu. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
