"""Krylov engines of the PyTorch port."""
