"""Spoken-language understanding and contextual biasing. So far the biasing
knowledge base (``kb.py``)."""
