from .checkpoint import read_checkpoint
from .convert import jax_cache_state_to_torch, jax_params_to_torch
