"""The port's cluster-substrate controllers (``builtin``: the kubelet
stand-in and the GPU node fixture)."""
