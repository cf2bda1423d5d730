"""The port's probes and e2e drivers, the counterparts of the top-level
``e2e/`` scripts: what the card sustains (``ceiling``, ``conv_experiments``),
how fast a hand-written kernel streams memory (``fused_bottleneck_probe``),
where a training step's time goes (``profile_step``, ``gpt_profile``,
``stage_profile``), the serving probe (``serving_bench``) and the serving
drivers over real HTTP (``paged_kv_driver``, ``disagg_driver``,
``serving_driver``, ``observability_driver``, ``fleet_driver``,
``overload_driver``; their shared client in ``_http``), and the
elastic plane's drivers on an in-memory cluster (``elastic_driver``,
``goodput_driver``, ``straggler_driver``; ``elastic_cluster``). Each runs
with ``python -m kubeflow_tpu_torch.e2e.<name>`` on the card (the elastic
drivers with ``--device cpu`` on the CPU)."""
