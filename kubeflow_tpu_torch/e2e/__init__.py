"""The port's device-evidence probes, the counterparts of the top-level
``e2e/`` scripts: what the card sustains (``ceiling``), how fast a
hand-written kernel streams memory (``fused_bottleneck_probe``) and where a
training step's time goes (``profile_step``, ``gpt_profile``). Each runs
with ``python -m kubeflow_tpu_torch.e2e.<name>`` on the card."""
