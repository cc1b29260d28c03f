from .checkpoint import load_checkpoint, load_checkpoint_extras, load_model, save_checkpoint

__all__ = ["load_checkpoint", "load_checkpoint_extras", "load_model", "save_checkpoint"]
