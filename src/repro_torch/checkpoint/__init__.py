"""Checkpoints of the PyTorch port, in the JAX package's npz format."""
