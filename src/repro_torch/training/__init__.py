"""AdamW, the LM train step, and the contrastive / pairwise trainers of the
embedder and reranker."""
from .optimizer import AdamWConfig, init_opt_state, adamw_update, cosine_schedule
from .trainer import make_train_step, make_eval_step
