from .config import ATTN, ModelConfig
from .model import Model, build_model
