"""The LM side of the port: configs, parameter trees, transformer layers and
the dense language model in train mode."""
