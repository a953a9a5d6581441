"""Checkpoints in the reference ``.pth`` layout, and the fixture weights."""

from .convert import (fixture_state_dict, from_flax_variables, load_pth, model_keys,
                      save_pth)

__all__ = ["fixture_state_dict", "from_flax_variables", "load_pth", "model_keys",
           "save_pth"]
