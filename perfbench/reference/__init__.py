"""The plain reference: PyTorch in f32 (TF32 off), no kernel, no cache, no
batching trick, and nothing of ``repro_torch`` or of the JAX package."""
