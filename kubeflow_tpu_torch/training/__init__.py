"""Training of the port: the GPT and ResNet-50 train steps of the JAX
package's bench (``training/gpt.py``, ``training/resnet.py``,
``training/classifier.py``), draft distillation for speculative decoding
(``training/distill.py``) and MFU accounting (``training/flops.py``)."""

from .flops import mfu  # noqa: F401
