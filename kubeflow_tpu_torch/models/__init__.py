"""Models of the port: the GPT decoder, ResNet, the MNIST CNN (the HPO
trial's model), the BERT encoder (serving path) and the converters between
flax trees and the port's tensors."""
