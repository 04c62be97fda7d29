"""The dense model stack: config, layers, attention, blocks, model."""
