"""LM data helpers (the byte tokenizer)."""
