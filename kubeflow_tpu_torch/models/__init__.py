"""Models of the port: the GPT decoder, ResNet, the BERT encoder (serving
path) and the flax → torch weight converters."""
