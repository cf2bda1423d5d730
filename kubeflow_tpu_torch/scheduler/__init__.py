"""The port's gang scheduler for ``nvidia.com/gpu`` nodes (copies of
``kubeflow_tpu/scheduler/``): the gang model and the drain protocol
(``gang``), the cards ledger with reservations (``ledger``), the flight
recorder behind ``/debug/scheduler`` (``flight``) and
``SchedulerReconciler`` (``core``, ``python -m
kubeflow_tpu_torch.scheduler.core``). The package imports nothing here, so
the elastic trainer and the straggler detector read ``gang`` without the
control plane."""
