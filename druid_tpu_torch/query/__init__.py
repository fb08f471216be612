"""The aggregate query model and its JSON serde."""
