from .model_preparation import construct_model

__all__ = ["construct_model"]
