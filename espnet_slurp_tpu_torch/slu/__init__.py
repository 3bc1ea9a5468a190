"""Spoken-language understanding and contextual biasing: the SLU model
(``model.py``), its scoring (``metrics.py``), a synthetic SLURP-style
corpus (``mini_corpus.py``) and the biasing knowledge base (``kb.py``)."""
