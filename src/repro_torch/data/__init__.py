"""Synthetic CF data and (seed, step)-pure batch sampling."""
