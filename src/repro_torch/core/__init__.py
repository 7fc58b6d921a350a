"""The HEAT MF core: similarity, CCL loss, samplers, tiling, the execution
engine and the training step."""
