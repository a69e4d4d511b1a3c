"""Tensor ops of the PyTorch port."""
