"""Models of the port: the GPT decoder (serving path) and the flax → torch
weight converter."""
