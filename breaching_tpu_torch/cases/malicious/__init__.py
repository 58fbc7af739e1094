"""The malicious servers' model surgery (counterpart of ``breaching_tpu/cases/malicious``):
imprint blocks, parameter utilities, the fishing attack's utilities and the servers."""

from .imprint import CuriousAbandonHonesty, ImprintBlock, OneShotBlock, OneShotBlockSparse, SparseImprintBlock

__all__ = [
    "ImprintBlock",
    "SparseImprintBlock",
    "OneShotBlock",
    "OneShotBlockSparse",
    "CuriousAbandonHonesty",
]
