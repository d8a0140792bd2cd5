from .tokenizer import HashWordTokenizer, SPECIAL_TOKENS
