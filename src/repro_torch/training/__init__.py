"""AdamW and the contrastive / pairwise trainers of the embedder and reranker."""
