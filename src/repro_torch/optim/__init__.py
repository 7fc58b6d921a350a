"""Optimizer-side storage: int8 embedding tables with stochastic-rounded
updates."""
