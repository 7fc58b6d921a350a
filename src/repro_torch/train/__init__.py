"""Training loops."""
