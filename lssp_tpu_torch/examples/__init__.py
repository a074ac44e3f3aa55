"""Runnable examples, the port's counterparts of ``examples/`` (which stay
the JAX package's): ``exam`` (the reference's example program), ``tour``
(the capabilities beyond it) and ``distributed`` (the shard mesh).  Each
runs on the CUDA card unless given ``--device cpu``:

    python -m lssp_tpu_torch.examples.exam
    python -m lssp_tpu_torch.examples.tour [--scale 0.25] [--device cpu]
    python -m lssp_tpu_torch.examples.distributed [--device cpu]
"""
