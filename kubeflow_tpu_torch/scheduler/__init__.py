"""The scheduler vocabulary the port's elastic plane speaks: a trimmed copy
of ``kubeflow_tpu/scheduler/gang.py`` (``gang``). The port has no
scheduler; its workloads and drivers read and write these annotations on
Pod and Node dicts held by any client."""
