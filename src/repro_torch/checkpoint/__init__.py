from .checkpoint import latest_checkpoint, read_checkpoint, save_checkpoint
from .convert import (jax_cache_state_to_torch, jax_params_to_torch, torch_param_dtypes,
                      torch_params_to_jax)
