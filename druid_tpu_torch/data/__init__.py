"""Segments, dictionaries, the synthetic generator and array conversion."""
