"""LM launch entry points: serving (``serve_llm``) and its step builders."""
