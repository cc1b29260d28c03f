from .checkpoint import load_model

__all__ = ["load_model"]
