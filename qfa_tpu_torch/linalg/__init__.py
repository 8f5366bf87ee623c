"""Small-matrix and low-rank linear algebra for the QFA likelihood."""

from . import lowrank, smallchol

__all__ = ["lowrank", "smallchol"]
