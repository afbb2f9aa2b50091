"""
Multi-device and multi-process work for the port (the counterpart of
gance_tpu/parallel/):

  * data axis: frame and sample batches split over a mesh's devices
    (`mesh.py`, `sharded_synthesis.py`), in synthesis, training
    (`training.py`) and projection;
  * network axis: every network resident on its own device group
    (`network_parallel.py`);
  * processes: `distributed.py` joins a torch.distributed group (NCCL where
    each rank owns its GPUs, gloo on the CPU and where ranks share a GPU),
    after which a mesh spans every process's devices.

Not ported yet (ROADMAP.md Queue 1 item 12, part 2): a tensor-parallel
'model' axis larger than 1, and serving over a mesh or several hosts.
"""
