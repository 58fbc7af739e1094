from .analysis import report

__all__ = ["report"]
