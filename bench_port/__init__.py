"""The benchmark of ``lssp_tpu_torch`` on NVIDIA GPUs (see ``run.py``)."""
