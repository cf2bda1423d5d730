"""kubeflow_tpu_torch — the PyTorch/CUDA port of ``kubeflow_tpu``'s compute.

The JAX package (``kubeflow_tpu``) stays the reference. This package serves
the same models on an NVIDIA H100: plain tensor code is eager PyTorch and
every kernel the JAX package wrote in Pallas is a hand-written CUDA kernel
for ``sm_90a`` (``ops/csrc/``), built from source at first use.

It imports ``torch``, numpy and the standard library only — never ``jax``,
``flax`` or anything of ``kubeflow_tpu``; what it shares with the JAX
package (metrics, tracing, the HTTP app, the KV block allocator) it keeps as
its own trimmed copy.

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when CUDA is missing; the CPU is used only when the caller asks for
it (the tests do).
"""

__version__ = "0.1.0"
