from .checkpoint import read_checkpoint
from .convert import jax_params_to_torch
