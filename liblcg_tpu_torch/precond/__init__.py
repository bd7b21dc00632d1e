"""Preconditioners of the PyTorch port."""

from .jacobi import JacobiPreconditioner

__all__ = ["JacobiPreconditioner"]
