"""Data pipeline: dataset construction + federated splits + loading."""

from .data_preparation import construct_dataloader

__all__ = ["construct_dataloader"]
