from .create import create_model, init_params
from .stacks import PNAStack

__all__ = ["PNAStack", "create_model", "init_params"]
