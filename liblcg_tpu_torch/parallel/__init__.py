"""Stencil operators of the PyTorch port (single device in this slice)."""

from .stencil import Laplacian3DOperator

__all__ = ["Laplacian3DOperator"]
