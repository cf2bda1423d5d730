"""Training of the port: the GPT train step of the JAX package's bench
(``training/gpt.py``)."""
