"""Data helpers: the byte tokenizer (LM) and the table readers and
writers (``io``: CSV, compiled CSV, flarecol)."""
