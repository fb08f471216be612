"""Column generators, one module per schema family, named by the
configuration's `generator` key."""
